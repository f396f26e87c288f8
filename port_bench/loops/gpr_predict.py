"""Closed-loop serving of an exact GPR by one client: set-up builds the
model at the configuration's hyperparameters and its ``posterior()`` (the
one factorization); each request then sends ``X*`` from the host, calls
``GPRPosterior.predict_f`` and copies the mean and marginal variance back
to the host, and the next starts when it has.

The requests' sizes P are log-uniform over 1..``max_points``: every block
of ``block`` requests holds the same sizes, round(max_points^(j / (block -
1))), in an order drawn from the seed, so every seed asks for the same
work; X* ~ U[0, 1]. A pool of ``pool`` requests is drawn in set-up and
sent in turn (again from the start if the window outlasts it). Once the
window has closed, ``sample`` requests drawn from the seed, and the largest,
are compared with the reference.

Traffic parameters: ``n`` points, ``max_points``, ``block``, ``pool``,
``sample``, ``trace_slice_s``.
"""

import time

import numpy as np

from port_bench import compare

SPANS = ("request.predict", "request.copy_out")


def _sizes(tr):
    b = tr["block"]
    return np.array([round(tr["max_points"] ** (j / (b - 1))) for j in range(b)])


def pool(tr, seed):
    """The requests' X* (float32, (P, 1) each), in the order they are sent."""
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(1,)))
    sizes = _sizes(tr)
    out = []
    while len(out) < tr["pool"]:
        out += [rng.uniform(0, 1, (int(p), 1)).astype(np.float32) for p in rng.permutation(sizes)]
    return out[: tr["pool"]]


def sample(tr, seed, sizes):
    """The requests compared: ``sample`` of those done, drawn from the seed,
    and the largest."""
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(2,)))
    idx = rng.choice(len(sizes), size=min(tr["sample"], len(sizes)), replace=False)
    return sorted(set(idx.tolist()) | {int(np.argmax(sizes))})


def setup(env, t_start):
    torch, gft = env.torch, env.program
    cfg, tr = env.config, env.traffic
    X, Y = env.reference.data(cfg, tr["n"], env.seed)
    kern = gft.kernels.RBF(1, lengthscales=cfg["lengthscale"], variance=cfg["variance"])
    env.phase("data", t_start)
    model = gft.models.GPR(X, Y, kern=kern, device=env.device, dtype=torch.float32)
    with torch.no_grad():
        p = model.likelihood.variance
        p.unconstrained.copy_(p.transform.backward(torch.tensor(cfg["noise_variance"], dtype=torch.float64)))
        post = model.posterior()
    env.phase("posterior", t_start)
    requests = pool(tr, env.seed)
    env.phase("pool", t_start)
    state = {"X": X, "Y": Y, "model": model, "post": post, "requests": requests}
    warm = np.random.default_rng(0)
    for p in _sizes(tr):  # every size the traffic sends, once
        _request(state, env, warm.uniform(0, 1, (int(p), 1)).astype(np.float32))
    env.phase("warmup", t_start)
    return state


def _request(state, env, xq):
    torch, span = env.torch, env.tracer.span
    with torch.no_grad():
        with span("request.predict"):
            mean, var = state["post"].predict_f(torch.from_numpy(xq).to(env.device))
        with span("request.copy_out"):
            return mean[:, 0].cpu(), var[:, 0].cpu()


def window(state, env, seconds):
    torch, tracer, requests = env.torch, env.tracer, state["requests"]
    answers, latency, sizes = [], [], []
    t0 = time.perf_counter()
    while True:
        xq = requests[len(answers) % len(requests)]
        t = time.perf_counter()
        answers.append(_request(state, env, xq))
        done = time.perf_counter()
        latency.append(done - t)
        sizes.append(len(xq))
        tracer.tick(env, done - t0, 1, len(xq))
        if done - t0 >= seconds and not tracer.active:
            break
    window_s = time.perf_counter() - t0
    failed = sum(not (bool(torch.isfinite(m).all()) and bool(torch.isfinite(v).all())) for m, v in answers)
    state["answers"], state["sizes"] = answers, sizes
    return {"attempted": len(answers), "failed": failed, "latency_s": latency, "sizes": sizes,
            "window_s": window_s, "n": env.traffic["n"], "input_dim": 1}


def _compare(env, answers, xqs, X, Y):
    ref_post = env.reference.posterior(env.config, X, Y, env.torch.float64, env.device)
    ref = [env.reference.predict(env.config, ref_post, xq, env.torch.float64) for xq in xqs]
    return compare.serving(answers, [(m.cpu(), v.cpu()) for m, v in ref], env.config["variance"])


def numbers(state, env):
    for k in ("model", "post"):
        state.pop(k, None)
    if env.device.type == "cuda":
        env.torch.cuda.empty_cache()
    requests = state["requests"]
    idx = sample(env.traffic, env.seed, state["sizes"])
    xqs = [requests[i % len(requests)] for i in idx]
    return _compare(env, [state["answers"][i] for i in idx], xqs, state["X"], state["Y"])


def control(env):
    """The numbers of the reference put in the program's place, computed in
    float32 with TF32 on, over as many requests as a run compares (the
    pool's first, and its largest)."""
    tr = env.traffic
    X, Y = env.reference.data(env.config, tr["n"], env.seed)
    requests = pool(tr, env.seed)
    idx = sample(tr, env.seed, [len(r) for r in requests[: 8 * tr["sample"]]])
    xqs = [requests[i] for i in idx]
    low_post = env.reference.posterior(env.config, X, Y, env.torch.float32, env.device)
    low = [env.reference.predict(env.config, low_post, xq, env.torch.float32) for xq in xqs]
    del low_post
    return _compare(env, [(m.cpu(), v.cpu()) for m, v in low], xqs, X, Y)
