"""Closed-loop hyperparameter fitting of an exact GPR: the window calls
``training.optimize.make_step_fn(model, Adam)``'s ``step_fn()`` (objective,
``.backward()``, ``opt.step()``) back to back, restarting the fit from the
starting hyperparameters (and a fresh Adam state) every
``restart_every`` steps, so every run's window covers the same points of
the fit however fast it runs.

Set-up builds the model and its step once, runs its first ``first_steps``
steps through that same ``step_fn`` and keeps what they produced (each
loss, the first gradient as Adam holds it, each leaf's change), which the
reference follows once the window has closed.

Traffic parameters: ``n`` points, ``learning_rate``, ``first_steps``,
``restart_every``, ``trace_slice_s``.
"""

import time

from port_bench import compare, harness

SPANS = ("step.forward", "step.backward", "step.optimizer")
BETAS = (0.9, 0.999)
# the program's leaf names -> the reference's
LEAVES = {"kern.lengthscales": "lengthscale", "kern.variance": "variance",
          "likelihood.variance": "noise_variance"}


def _traced_step(env, state):
    """The loss function and optimizer hooks of a traced run: the
    benchmark's spans around the forward, the backward and the optimizer
    step, and CUDA events at the backward's two ends."""
    torch, span = env.torch, env.tracer.span
    cur = {}

    def loss_fn(model):
        with span("step.forward"):
            loss = model.objective()
        if env.device.type == "cuda":
            cur["ev"] = torch.cuda.Event(enable_timing=True)
            cur["ev"].record()
        cur["bwd"] = span("step.backward")
        cur["bwd"].__enter__()
        return loss

    def pre(opt, args, kwargs):
        cur["bwd"].__exit__(None, None, None)
        if env.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            state["events"].append((cur["ev"], ev))
        cur["opt"] = span("step.optimizer")
        cur["opt"].__enter__()

    def post(opt, args, kwargs):
        cur["opt"].__exit__(None, None, None)

    return loss_fn, pre, post


def setup(env, t_start):
    torch, gft = env.torch, env.program
    from gpflow_slim_tpu_torch.params import trainable_leaves
    from gpflow_slim_tpu_torch.training.optimize import make_step_fn

    cfg, tr = env.config, env.traffic
    X, Y = env.reference.data(cfg, tr["n"], env.seed)
    kern = gft.kernels.RBF(1, lengthscales=cfg["lengthscale"], variance=cfg["variance"])
    env.phase("data", t_start)
    model = gft.models.GPR(X, Y, kern=kern, device=env.device, dtype=torch.float32)
    leaves = dict(trainable_leaves(model))
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


def window(state, env, seconds):
    torch, tracer = env.torch, env.tracer
    step_fn, every = state["step_fn"], env.traffic["restart_every"]
    state["events"].clear()
    losses, steps, stamps = [], 0, []
    t0 = time.perf_counter()
    while True:
        if steps and steps % every == 0:
            state["restart"]()
        losses.append(step_fn())
        steps += 1
        elapsed = time.perf_counter() - t0
        stamps.append(elapsed)
        tracer.tick(env, elapsed)
        if elapsed >= seconds and not tracer.active:
            break
    env.sync()
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    events = state["events"]
    return {"attempted": steps, "failed": failed, "steps": steps, "window_s": window_s, "n": env.traffic["n"],
            "backward_ms_sum": sum(a.elapsed_time(b) for a, b in events) if events else None,
            "backward_spans": len(events), "host": harness.host_steps(stamps)}


def _free(state, env):
    for k in ("model", "step_fn", "opt", "restart"):
        state.pop(k, None)
    if env.device.type == "cuda":
        env.torch.cuda.empty_cache()


def numbers(state, env):
    _free(state, env)
    ref = env.reference.fit(env.config, env.traffic, state["X"], state["Y"], env.traffic["first_steps"],
                            env.torch.float64, env.device)
    return compare.training(state["prog"], ref, env.detail)


def control(env):
    """The numbers of the reference put in the program's place, computed in
    float32 with TF32 on."""
    X, Y = env.reference.data(env.config, env.traffic["n"], env.seed)
    args = env.config, env.traffic, X, Y, env.traffic["first_steps"]
    ref = env.reference.fit(*args, env.torch.float64, env.device)
    low = env.reference.fit(*args, env.torch.float32, env.device)
    return compare.training(low, ref, env.detail)
