"""Plain reference of configuration sgpr-m512-matern32-d11: Titsias's (2009)
collapsed variational bound for sparse GP regression, with a Matern-3/2
kernel with one lengthscale per input (ARD), M inducing points and
Gaussian noise.

Written from the bound's equations in plain torch (``torch.linalg`` and
autograd); it imports nothing of gpflow_slim_tpu_torch and takes nothing
the program made. Every function takes a ``dtype``: float64 is the
reference; float32 with TF32 on is the control of lower precision.
Parameters live unconstrained, as an optimizer holds them (Z as it is).

The N columns are taken in blocks (``BLOCK`` of them at a time): each
block gives its share of the M x M and M x 1 sums the bound needs, and
autograd recomputes the block in the backward (``checkpoint``), so no M x N
matrix is held whole. The bound, with Kuu = K(Z, Z) + jitter I = L L^T,
V = L^-1 K(Z, X), P = V V^T, q = V y and B = I + P / s2 = LB LB^T:

    log N(y | 0, V^T V + s2 I) - tr(Kff - V^T V) / (2 s2)
      = -N/2 log 2 pi - sum log diag LB - N/2 log s2 - |y|^2 / (2 s2)
        + |LB^-1 q|^2 / (2 s2^2) - (N var - tr P) / (2 s2)
"""

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from port_bench.plain import Precision, adam, positive, unconstrain

LEAVES = ("Z", "lengthscale", "variance", "noise_variance")
BLOCK = 65536  # columns a block: its K(Z, X_b) is 0.27 GB in float64 at M = 512
EUCLID_EPS = 1e-12  # r = sqrt(d^2 + 1e-12), GPflow's euclid_dist
S3 = math.sqrt(3.0)


def data(config, n, seed):
    """n rows of standardised inputs X ~ N(0, I) in R^D and Y = sin(s1) +
    0.5 cos(2 s2) + 0.1 eps, s1 the inputs' sum and s2 their alternating
    sum, each over sqrt(D); float32, from a RandomState of the seed."""
    rng = np.random.RandomState(seed % 2**32)
    D = config["input_dim"]
    X = rng.randn(n, D).astype(np.float32)
    sign = np.where(np.arange(D) % 2 == 0, 1.0, -1.0)
    s1 = X.astype(np.float64).sum(1, keepdims=True) / math.sqrt(D)
    s2 = X.astype(np.float64) @ sign[:, None] / math.sqrt(D)
    Y = (np.sin(s1) + 0.5 * np.cos(2 * s2) + 0.1 * rng.randn(n, 1)).astype(np.float32)
    return X, Y


def start(config, X, seed):
    """The starting values: Z a subset of M distinct rows of X drawn from a
    RandomState of the seed + 1, and the configuration's lengthscale (one a
    dimension), variance and noise variance."""
    rng = np.random.RandomState((seed + 1) % 2**32)
    idx = np.sort(rng.choice(X.shape[0], config["num_inducing"], replace=False))
    return {"Z": X[idx].copy(), "lengthscale": np.full(config["input_dim"], config["lengthscale"]),
            "variance": config["variance"], "noise_variance": config["noise_variance"]}


def matern32(A, B, lengthscale, variance):
    """variance (1 + sqrt3 r) exp(-sqrt3 r), r = sqrt(d^2 + 1e-12) and d^2
    the squared distance of the scaled inputs expanded into a matrix
    product, clamped at 0."""
    As, Bs = A / lengthscale, B / lengthscale
    sq = (As**2).sum(1)[:, None] - 2 * As @ Bs.T + (Bs**2).sum(1)[None, :]
    r = torch.sqrt(sq.clamp_min(0) + EUCLID_EPS)
    return variance * (1 + S3 * r) * torch.exp(-S3 * r)


def _block_sums(Z, Xb, Yb, ls, var, L):
    # one block's share of P = V V^T and q = V y
    V = torch.linalg.solve_triangular(L, matern32(Z, Xb, ls, var), upper=False)
    return V @ V.T, V @ Yb


def bound(X, Y, u, config, block=BLOCK):
    """The collapsed bound at the unconstrained leaves ``u``, taking X's
    rows ``block`` at a time."""
    floor = config["positive_minimum"]
    Z = u["Z"]
    ls, var, s2 = (positive(u[k], floor) for k in ("lengthscale", "variance", "noise_variance"))
    N, M = X.shape[0], Z.shape[0]
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    L = torch.linalg.cholesky(matern32(Z, Z, ls, var) + config["jitter"] * eye)
    P = torch.zeros(M, M, dtype=Z.dtype, device=Z.device)
    q = torch.zeros(M, Y.shape[1], dtype=Z.dtype, device=Z.device)
    for i in range(0, N, block):
        Pb, qb = checkpoint(_block_sums, Z, X[i:i + block], Y[i:i + block], ls, var, L, use_reentrant=False)
        P, q = P + Pb, q + qb
    LB = torch.linalg.cholesky(eye + P / s2)
    c = torch.linalg.solve_triangular(LB, q, upper=False)
    return (-0.5 * N * math.log(2 * math.pi) - torch.log(torch.diagonal(LB)).sum() - 0.5 * N * torch.log(s2)
            - 0.5 * (Y**2).sum() / s2 + 0.5 * (c**2).sum() / s2**2 - 0.5 * (N * var - torch.trace(P)) / s2)


def fit(config, traffic, X, Y, steps, dtype, device, seed):
    """``steps`` Adam steps on -bound from the start: the loss before each
    update, the first gradient and each leaf's change after the steps."""
    with Precision(dtype):
        Xt = torch.as_tensor(X, device=device).to(dtype)
        Yt = torch.as_tensor(Y, device=device).to(dtype)
        s = start(config, X, seed)
        floor = config["positive_minimum"]
        u = {"Z": torch.as_tensor(s["Z"], device=device).to(dtype)}
        u.update({k: unconstrain(s[k], floor, dtype, device) for k in LEAVES[1:]})
        u0 = dict(u)
        state, losses, grad1 = {}, [], None
        for step in range(steps):
            leaves = {k: v.detach().requires_grad_() for k, v in u.items()}
            loss = -bound(Xt, Yt, leaves, config)
            g = dict(zip(LEAVES, torch.autograd.grad(loss, [leaves[k] for k in LEAVES])))
            losses.append(loss.item())
            if step == 0:
                grad1 = {k: v.double() for k, v in g.items()}
            u = {k: v.detach() for k, v in leaves.items()}
            adam(u, g, state, traffic["learning_rate"])
        return {"losses": losses, "grad1": grad1, "change": {k: (u[k] - u0[k]).double() for k in LEAVES}}
