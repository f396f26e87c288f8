"""Closed-loop hyperparameter and inducing-point fitting of Titsias's SGPR:
``gpr_fit``'s loop (``make_step_fn(model, Adam)``'s ``step_fn()`` back to
back, restarted from the starting leaves and a fresh Adam state every
``restart_every`` steps) on ``models.SGPR`` with the configuration's ARD
Matern-3/2 kernel; the reference's ``start`` gives the starting values, Z
drawn from X by the seed. ``numbers`` and ``control`` are ``nkn_fit``'s.

Traffic parameters: ``n`` points, ``learning_rate``, ``first_steps``,
``restart_every``, ``trace_slice_s``.
"""

import numpy as np

from port_bench.loops.gpr_fit import BETAS, SPANS, _traced_step, window  # noqa: F401  (SPANS, window: the loop's)
# the reference's fit takes the seed, as the NKN's does: the same comparison and control
from port_bench.loops.nkn_fit import control, numbers  # noqa: F401  (the loop's)

# the program's leaves -> the reference's
LEAVES = {"feature.Z": "Z", "kern.lengthscales": "lengthscale", "kern.variance": "variance",
          "likelihood.variance": "noise_variance"}


def setup(env, t_start):
    torch, gft = env.torch, env.program
    from gpflow_slim_tpu_torch.params import trainable_leaves
    from gpflow_slim_tpu_torch.training.optimize import make_step_fn

    cfg, tr = env.config, env.traffic
    X, Y = env.reference.data(cfg, tr["n"], env.seed)
    s = env.reference.start(cfg, X, env.seed)
    kern = gft.kernels.Matern32(cfg["input_dim"], variance=s["variance"], lengthscales=np.asarray(s["lengthscale"]))
    env.phase("data", t_start)
    model = gft.models.SGPR(X, Y, kern=kern, Z=s["Z"], device=env.device, dtype=torch.float32)
    leaves = dict(trainable_leaves(model))
    if set(leaves) != set(LEAVES):
        raise RuntimeError(f"the program's leaves {sorted(leaves)} are not the loop's {sorted(LEAVES)}")
    with torch.no_grad():
        p = model.likelihood.variance
        p.unconstrained.copy_(p.transform.backward(torch.tensor(s["noise_variance"], dtype=torch.float64)))
    state = {"X": X, "Y": Y, "events": []}
    loss_fn = None
    if env.tracer.on:
        loss_fn, pre, post = _traced_step(env, state)
    step_fn, opt = make_step_fn(
        model, lambda ps: torch.optim.Adam(ps, lr=tr["learning_rate"], betas=BETAS, eps=1e-8), loss_fn)
    if env.tracer.on:
        opt.register_step_pre_hook(pre)
        opt.register_step_post_hook(post)
    start = {n: t.detach().clone() for n, t in leaves.items()}

    def restart():
        with torch.no_grad():
            for n, t in leaves.items():
                t.copy_(start[n])
        opt.state.clear()

    losses, grad1 = [], None
    for step in range(tr["first_steps"]):
        losses.append(step_fn())
        if step == 0:
            grad1 = {LEAVES[n]: (opt.state[t]["exp_avg"] / (1 - BETAS[0])).double().cpu() for n, t in leaves.items()}
    env.phase("first_steps", t_start)
    state["prog"] = {"losses": [float(x) for x in losses], "grad1": grad1,
                     "change": {LEAVES[n]: (t.detach() - start[n]).double().cpu() for n, t in leaves.items()}}
    restart()
    state.update(model=model, step_fn=step_fn, opt=opt, restart=restart)
    return state
