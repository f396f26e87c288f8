"""Plain reference of configuration gpr-rbf-d1: exact GP regression with an
RBF kernel on D=1 inputs and Gaussian noise.

Written from the model's equations in plain torch (``torch.linalg`` and
autograd); it imports nothing of gpflow_slim_tpu_torch and takes nothing
the program made. Every function takes a ``dtype``: float64 is the
reference; float32 with TF32 on is the control of lower precision.
Parameters live unconstrained, as an optimizer holds them.
"""

import math

import numpy as np
import torch

from port_bench.plain import Precision, adam, positive, rbf, unconstrain

LEAVES = ("lengthscale", "variance", "noise_variance")


def data(config, n, seed):
    """X ~ U[0, 1] (n, 1) and Y = sin(12 x) + 0.66 cos(25 x) + 0.1 eps,
    float32: bench.py's data (copied from chip_smoke.py's ``bench_data``),
    its RandomState seeded from ``seed`` in place of 0."""
    rng = np.random.RandomState(seed % 2**32)
    X = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.66 * np.cos(25 * X) + 0.1 * rng.randn(n, 1)).astype(np.float32)
    return X, Y


def objective(X, Y, u, config):
    """-log p(Y | theta) = N/2 log 2 pi + 1/2 log det K + 1/2 Y^T K^-1 Y
    (chip_smoke.py's ``oracle_objective``, differentiable in u)."""
    ls, var, noise = (positive(u[k], config["positive_minimum"]) for k in LEAVES)
    N = X.shape[0]
    K = rbf(X, X, ls, var) + noise * torch.eye(N, dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(K)
    a = torch.linalg.solve_triangular(L, Y, upper=False)
    return 0.5 * N * math.log(2 * math.pi) + torch.log(torch.diagonal(L)).sum() + 0.5 * (a**2).sum()


def fit(config, traffic, X, Y, steps, dtype, device):
    """``steps`` Adam steps from the start: the loss before each update,
    the first gradient and each leaf's change after the steps."""
    with Precision(dtype):
        Xt = torch.as_tensor(X, device=device).to(dtype)
        Yt = torch.as_tensor(Y, device=device).to(dtype)
        u = {k: unconstrain(config[k], config["positive_minimum"], dtype, device) for k in LEAVES}
        u0 = dict(u)
        state, losses, grad1 = {}, [], None
        for s in range(steps):
            leaves = {k: v.detach().requires_grad_() for k, v in u.items()}
            loss = objective(Xt, Yt, leaves, config)
            g = dict(zip(LEAVES, torch.autograd.grad(loss, [leaves[k] for k in LEAVES])))
            losses.append(loss.item())
            if s == 0:
                grad1 = {k: v.double() for k, v in g.items()}
            u = {k: v.detach() for k, v in leaves.items()}
            adam(u, g, state, traffic["learning_rate"])
        return {"losses": losses, "grad1": grad1, "change": {k: (u[k] - u0[k]).double() for k in LEAVES}}


def posterior(config, X, Y, dtype, device):
    """(X, L, alpha): the factor of K + noise I at the configuration's
    hyperparameters and alpha = (K + noise I)^-1 Y."""
    with Precision(dtype):
        Xt = torch.as_tensor(X, device=device).to(dtype)
        Yt = torch.as_tensor(Y, device=device).to(dtype)
        K = rbf(Xt, Xt, config["lengthscale"], config["variance"])
        K.diagonal().add_(config["noise_variance"])
        L = torch.linalg.cholesky(K)
        return Xt, L, torch.cholesky_solve(Yt, L)


def predict(config, post, Xq, dtype):
    """The predictive mean and marginal variance of f at ``Xq``."""
    Xt, L, alpha = post
    with Precision(dtype):
        Xq = torch.as_tensor(Xq, device=Xt.device).to(dtype)
        Kx = rbf(Xt, Xq, config["lengthscale"], config["variance"])
        A = torch.linalg.solve_triangular(L, Kx, upper=False)
        return (Kx.T @ alpha)[:, 0], config["variance"] - (A**2).sum(0)
