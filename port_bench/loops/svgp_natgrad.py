"""Closed-loop SVGP training: the window calls
``training.natgrad.fit_svgp_natgrad(model, chunk, generator, gamma,
learning_rate, batch_size, optimizer)`` back to back, ``chunk`` steps a
call (each a natgrad step on q, then an Adam step on the hyperparameters),
one Adam built once and handed to every call, the minibatches drawn by one
generator seeded from the seed. The fit restarts from the model as built
every ``restart_every`` steps (a long float32 run can reach a q whose
precision no longer factors).

Set-up builds the model and runs the first ``first_steps`` steps through
the same call, one step a call, keeping each batch loss, the
hyperparameters' first gradient as Adam holds it and each leaf's change;
the reference follows them once the window has closed. The first call
captures natgrad's CUDA graph.

Traffic parameters: ``batch_size``, ``gamma``, ``learning_rate``,
``max_halvings`` (the program's), ``chunk``, ``first_steps``,
``restart_every``, ``trace_slice_s``.
"""

import time

from port_bench import compare, harness

SPANS = ("svgp.chunk",)
BETAS = (0.9, 0.999)
LEAVES = {"kern.lengthscales": "lengthscale", "kern.variance": "variance", "feature.Z": "Z",
          "q_mu": "q_mu", "q_sqrt": "q_sqrt"}


def setup(env, t_start):
    torch, gft = env.torch, env.program
    from gpflow_slim_tpu_torch.params import trainable_leaves
    from gpflow_slim_tpu_torch.training.natgrad import fit_svgp_natgrad

    cfg, tr = env.config, env.traffic
    X, Y, Z = env.reference.data(cfg, env.seed)
    kern = gft.kernels.RBF(1, lengthscales=cfg["lengthscale"], variance=cfg["variance"])
    env.phase("data", t_start)
    model = gft.models.SVGP(X, Y, kern=kern, likelihood=gft.likelihoods.Bernoulli(), Z=Z,
                            whiten=cfg["whiten"], device=env.device, dtype=torch.float32)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(env.seed)
    adam = {}

    def optimizer(ps):
        if "opt" not in adam:
            adam["opt"], adam["params"] = torch.optim.Adam(ps, lr=tr["learning_rate"], betas=BETAS, eps=1e-8), ps
        return adam["opt"]

    def chunk(k):
        return fit_svgp_natgrad(model, k, gen, gamma=tr["gamma"], learning_rate=tr["learning_rate"],
                                batch_size=tr["batch_size"], optimizer=optimizer)[1]

    leaves = dict(trainable_leaves(model))
    start = {n: t.detach().clone() for n, t in leaves.items()}
    q0 = model.q_sqrt_array().detach()[0].clone()

    def restart():
        with torch.no_grad():
            for n, t in leaves.items():
                t.copy_(start[n])
        adam["opt"].state.clear()

    losses, grad1 = [], None
    for s in range(tr["first_steps"]):
        losses.append(chunk(1))
        if s == 0:
            st = adam["opt"].state
            grad1 = {LEAVES[n]: (st[t]["exp_avg"] / (1 - BETAS[0])).double().cpu()
                     for n, t in leaves.items() if any(t is p for p in adam["params"])}
    env.phase("first_steps", t_start)
    change = {LEAVES[n]: (t.detach() - start[n]).double().cpu() for n, t in leaves.items() if n != "q_sqrt"}
    change["q_sqrt"] = (model.q_sqrt_array().detach()[0] - q0).double().cpu()
    state = {"X": X, "Y": Y, "Z": Z,
             "prog": {"losses": [float(x) for x in torch.cat(losses)], "grad1": grad1, "change": change}}
    restart()
    chunk(tr["chunk"])  # the window's own call size
    restart()
    env.phase("warmup", t_start)
    state.update(model=model, chunk=chunk, restart=restart, adam=adam)
    return state


def window(state, env, seconds):
    torch, tracer = env.torch, env.tracer
    chunk, k, every = state["chunk"], env.traffic["chunk"], env.traffic["restart_every"]
    losses, steps, stamps = [], 0, []
    t0 = time.perf_counter()
    while True:
        if steps and steps % every == 0:
            state["restart"]()
        with tracer.span("svgp.chunk"):
            losses.append(chunk(k))
        steps += k
        elapsed = time.perf_counter() - t0
        stamps.append(elapsed)
        tracer.tick(env, elapsed, k)
        if elapsed >= seconds and not tracer.active:
            break
    env.sync()
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.cat(losses))).sum())
    return {"attempted": steps, "failed": failed, "steps": steps, "window_s": window_s,
            "host": harness.host_steps(stamps)}


def numbers(state, env):
    for k in ("model", "chunk", "restart", "adam"):
        state.pop(k, None)
    if env.device.type == "cuda":
        env.torch.cuda.empty_cache()
    ref = env.reference.fit(env.config, env.traffic, state["X"], state["Y"], state["Z"], env.seed,
                            env.traffic["first_steps"], env.torch.float64, env.device)
    return compare.training(state["prog"], ref, env.detail)


def control(env):
    """The numbers of the reference put in the program's place, computed in
    float32 with TF32 on."""
    X, Y, Z = env.reference.data(env.config, env.seed)
    args = env.config, env.traffic, X, Y, Z, env.seed, env.traffic["first_steps"]
    ref = env.reference.fit(*args, env.torch.float64, env.device)
    low = env.reference.fit(*args, env.torch.float32, env.device)
    return compare.training(low, ref, env.detail)
