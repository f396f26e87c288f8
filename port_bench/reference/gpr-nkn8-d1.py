"""Plain reference of configuration gpr-nkn8-d1: exact GP regression with a
Neural Kernel Network kernel (Sun, Zhang, Wang, Zeng, Li, Grosse, ICML
2018) on D=1 inputs and Gaussian noise: the paper's time-series network,
8 primitive kernels (2 Linear, 2 Periodic, 2 RBF, 2 RationalQuadratic), then
Linear(8 -> 8), Product(step 2), Linear(4 -> 4), Product(step 2),
Linear(2 -> 1), the Linear layers' weights positive and without biases.

Written from the equations in plain torch (``torch.linalg`` and autograd);
it imports nothing of gpflow_slim_tpu_torch and takes nothing the program
made. Each primitive's Gram, with d = x - x' and sums over the input
dimensions (the configuration has one; the tests also run two, with a
lengthscale, period or variance for each):

- Linear: sum v x x';
- Periodic: var exp(-1/2 sum (sin(pi d / p) / l)^2), GPflow-1.x's 1/2
  where the paper's MacKay form has 2 (the departure of GPflow-Slim, which
  the NKN code is built on);
- RBF: var exp(-sum d^2 / (2 l^2));
- RationalQuadratic: var (1 + sum d^2 / l^2 / (2 alpha))^(-alpha).

d is formed as a difference, not by the ||x||^2 - 2 x x' + ||x'||^2
expansion. A Linear layer is h_o = sum_i W_oi k_i, a Product layer the
elementwise product of consecutive pairs. Every function takes a
``dtype``: float64 is the reference, float32 with TF32 on the control of
lower precision. Parameters live unconstrained, as an optimizer holds them.

At N = 10000 autograd through the network keeps ~45 arrays of N^2 floats
(~36 GB in float64): the harness runs the reference after the program's
state is freed.
"""

import math

import numpy as np
import torch

from port_bench.plain import Precision, adam, positive, unconstrain


def leaves(config):
    """The reference's leaf names, in a fixed order: each primitive's
    parameters, the three weight matrices, the noise."""
    names = []
    for p in config["primitives"]:
        names += [f"{p['name']}.{k}" for k in ("variance", "lengthscale", "period", "alpha") if k in p]
    names += [f"layer{i}.weights" for i, layer in enumerate(config["layers"]) if layer["kind"] == "Linear"]
    return names + ["noise_variance"]


def start(config, seed):
    """The starting values (constrained): the configuration's, and each
    Linear layer's weights uniform(lo, hi) / its input width, drawn in
    layer order from a RandomState of the seed + 1."""
    rng = np.random.RandomState((seed + 1) % 2**32)
    lo, hi = config["weight_init"]
    out = {}
    for p in config["primitives"]:
        out.update({f"{p['name']}.{k}": p[k] for k in ("variance", "lengthscale", "period", "alpha") if k in p})
    for i, layer in enumerate(config["layers"]):
        if layer["kind"] == "Linear":
            out[f"layer{i}.weights"] = rng.uniform(lo, hi, (layer["out"], layer["in"])) / layer["in"]
    out["noise_variance"] = config["noise_variance"]
    return out


def data(config, n, seed):
    """X ~ U[0, 1] (n, 1); Y = 0.5 x + 0.5 sin(2 pi x / 0.25) + 0.3 sin(2 pi x
    / 0.1) + 0.4 exp(-(x - 0.5)^2 / 0.045) + 0.1 eps, float32: a trend, two
    periodic components and a smooth bump, the shape of the paper's
    time-series tasks, from a RandomState of the seed."""
    rng = np.random.RandomState(seed % 2**32)
    X = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    Y = (0.5 * X + 0.5 * np.sin(2 * np.pi * X / 0.25) + 0.3 * np.sin(2 * np.pi * X / 0.1)
         + 0.4 * np.exp(-((X - 0.5) ** 2) / 0.045) + 0.1 * rng.randn(n, 1)).astype(np.float32)
    return X, Y


def primitive(p, X, v):
    """Primitive ``p``'s Gram on X from its constrained values ``v`` (name
    -> tensor)."""
    name = p["name"]
    if p["kind"] == "Linear":
        return (X * v[f"{name}.variance"]) @ X.T
    d = X[:, None, :] - X[None, :, :]  # (N, N, D)
    var, ls = v[f"{name}.variance"], v[f"{name}.lengthscale"]
    if p["kind"] == "Periodic":
        return var * torch.exp(-0.5 * ((torch.sin(math.pi * d / v[f"{name}.period"]) / ls) ** 2).sum(-1))
    r2 = ((d / ls) ** 2).sum(-1)
    if p["kind"] == "RBF":
        return var * torch.exp(-0.5 * r2)
    if p["kind"] == "RationalQuadratic":
        a = v[f"{name}.alpha"]
        return var * (1 + r2 / (2 * a)) ** (-a)
    raise ValueError(f"unknown primitive kind {p['kind']!r}")


def gram(config, X, v):
    """The network's Gram: the primitives, then each layer in turn."""
    ks = [primitive(p, X, v) for p in config["primitives"]]
    for i, layer in enumerate(config["layers"]):
        if layer["kind"] == "Linear":
            W = v[f"layer{i}.weights"]
            ks = [sum(W[o, j] * ks[j] for j in range(layer["in"])) for o in range(layer["out"])]
        else:
            step = layer["step"]
            ks = [math.prod(ks[g * step:(g + 1) * step]) for g in range(layer["in"] // step)]
    return ks[0]


def objective(X, Y, u, config):
    """-log p(Y | theta) = N/2 log 2 pi + 1/2 log det K + 1/2 Y^T K^-1 Y with K
    the network's Gram + noise I, differentiable in u."""
    v = {k: positive(t, config["positive_minimum"]) for k, t in u.items()}
    N = X.shape[0]
    K = gram(config, X, v) + v["noise_variance"] * torch.eye(N, dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(K)
    a = torch.linalg.solve_triangular(L, Y, upper=False)
    return 0.5 * N * math.log(2 * math.pi) + torch.log(torch.diagonal(L)).sum() + 0.5 * (a**2).sum()


def fit(config, traffic, X, Y, steps, dtype, device, seed):
    """``steps`` Adam steps from ``start(config, seed)``: the loss before
    each update, the first gradient and each leaf's change after the
    steps."""
    names = leaves(config)
    with Precision(dtype):
        Xt = torch.as_tensor(X, device=device).to(dtype)
        Yt = torch.as_tensor(Y, device=device).to(dtype)
        u = {k: unconstrain(v, config["positive_minimum"], dtype, device) for k, v in start(config, seed).items()}
        u0 = dict(u)
        state, losses, grad1 = {}, [], None
        for s in range(steps):
            leaves_ = {k: t.detach().requires_grad_() for k, t in u.items()}
            loss = objective(Xt, Yt, leaves_, config)
            g = dict(zip(names, torch.autograd.grad(loss, [leaves_[k] for k in names])))
            losses.append(loss.item())
            del loss
            if s == 0:
                grad1 = {k: t.double() for k, t in g.items()}
            u = {k: t.detach() for k, t in leaves_.items()}
            adam(u, g, state, traffic["learning_rate"])
        return {"losses": losses, "grad1": grad1, "change": {k: (u[k] - u0[k]).double() for k in names}}
