"""Closed-loop hyperparameter fitting of an exact GPR on a Neural Kernel
Network: ``gpr_fit``'s loop (``make_step_fn(model, Adam)``'s ``step_fn()``
back to back, restarted from the starting leaves and a fresh Adam state
every ``restart_every`` steps) on the configuration's network, built from
its primitives and layers; the reference's ``start`` gives the starting
values, the layers' weights drawn from the seed.

Traffic parameters: ``n`` points, ``learning_rate``, ``first_steps``,
``restart_every``, ``trace_slice_s``.
"""

import numpy as np

from port_bench import compare
from port_bench.loops.gpr_fit import BETAS, SPANS, _free, _traced_step, window  # noqa: F401  (SPANS, window: the loop's)

# the program's 22 leaves (101 numbers) -> the reference's
LEAVES = {
    "kern.primitives.0.variance": "lin0.variance",
    "kern.primitives.1.variance": "lin1.variance",
    "kern.primitives.2.variance": "per0.variance",
    "kern.primitives.2.lengthscales": "per0.lengthscale",
    "kern.primitives.2.period": "per0.period",
    "kern.primitives.3.variance": "per1.variance",
    "kern.primitives.3.lengthscales": "per1.lengthscale",
    "kern.primitives.3.period": "per1.period",
    "kern.primitives.4.variance": "rbf0.variance",
    "kern.primitives.4.lengthscales": "rbf0.lengthscale",
    "kern.primitives.5.variance": "rbf1.variance",
    "kern.primitives.5.lengthscales": "rbf1.lengthscale",
    "kern.primitives.6.variance": "rq0.variance",
    "kern.primitives.6.lengthscales": "rq0.lengthscale",
    "kern.primitives.6.alpha": "rq0.alpha",
    "kern.primitives.7.variance": "rq1.variance",
    "kern.primitives.7.lengthscales": "rq1.lengthscale",
    "kern.primitives.7.alpha": "rq1.alpha",
    "kern.layers.0.weights": "layer0.weights",
    "kern.layers.2.weights": "layer2.weights",
    "kern.layers.4.weights": "layer4.weights",
    "likelihood.variance": "noise_variance",
}


def build_kernel(gft, cfg, start):
    """The configuration's NKN at the starting values ``start`` (the
    reference's names)."""
    k, nkn = gft.kernels, gft.kernels_nkn
    prims = []
    for p in cfg["primitives"]:
        v = {key: start[f"{p['name']}.{key}"] for key in ("variance", "lengthscale", "period", "alpha") if key in p}
        if p["kind"] == "Linear":
            prims.append(k.Linear(1, variance=v["variance"]))
        elif p["kind"] == "Periodic":
            prims.append(k.Periodic(1, period=v["period"], variance=v["variance"], lengthscales=v["lengthscale"]))
        elif p["kind"] == "RBF":
            prims.append(k.RBF(1, variance=v["variance"], lengthscales=v["lengthscale"]))
        else:
            prims.append(k.RationalQuadratic(1, variance=v["variance"], lengthscales=v["lengthscale"], alpha=v["alpha"]))
    layers = []
    for i, layer in enumerate(cfg["layers"]):
        if layer["kind"] == "Linear":
            layers.append(nkn.NKNLinear(layer["in"], layer["out"], weights=np.asarray(start[f"layer{i}.weights"])))
        else:
            layers.append(nkn.NKNProduct(layer["in"], layer["step"]))
    return nkn.NKN(1, prims, layers)


def setup(env, t_start):
    torch, gft = env.torch, env.program
    from gpflow_slim_tpu_torch.params import trainable_leaves
    from gpflow_slim_tpu_torch.training.optimize import make_step_fn

    cfg, tr = env.config, env.traffic
    X, Y = env.reference.data(cfg, tr["n"], env.seed)
    start_values = env.reference.start(cfg, env.seed)
    env.phase("data", t_start)
    model = gft.models.GPR(X, Y, kern=build_kernel(gft, cfg, start_values), device=env.device, dtype=torch.float32)
    leaves = dict(trainable_leaves(model))
    if set(leaves) != set(LEAVES):
        raise RuntimeError(f"the program's leaves {sorted(leaves)} are not the loop's {sorted(LEAVES)}")
    with torch.no_grad():
        p = model.likelihood.variance
        p.unconstrained.copy_(p.transform.backward(torch.tensor(cfg["noise_variance"], dtype=torch.float64)))
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
    for s in range(tr["first_steps"]):
        losses.append(step_fn())
        if s == 0:
            grad1 = {LEAVES[n]: (opt.state[t]["exp_avg"] / (1 - BETAS[0])).double().cpu() for n, t in leaves.items()}
    env.phase("first_steps", t_start)
    state["prog"] = {"losses": [float(x) for x in losses], "grad1": grad1,
                     "change": {LEAVES[n]: (t.detach() - start[n]).double().cpu() for n, t in leaves.items()}}
    restart()
    state.update(model=model, step_fn=step_fn, opt=opt, restart=restart)
    return state


def numbers(state, env):
    _free(state, env)
    ref = env.reference.fit(env.config, env.traffic, state["X"], state["Y"], env.traffic["first_steps"],
                            env.torch.float64, env.device, env.seed)
    return compare.training(state["prog"], ref, env.detail)


def control(env):
    """The numbers of the reference put in the program's place, computed in
    float32 with TF32 on."""
    X, Y = env.reference.data(env.config, env.traffic["n"], env.seed)
    args = env.config, env.traffic, X, Y, env.traffic["first_steps"]
    ref = env.reference.fit(*args, env.torch.float64, env.device, env.seed)
    low = env.reference.fit(*args, env.torch.float32, env.device, env.seed)
    return compare.training(low, ref, env.detail)
