"""Plain reference of configuration svgp-bernoulli-m256: an SVGP with an RBF
kernel on D=1 inputs, a Bernoulli (probit) likelihood and M inducing
points, unwhitened, trained by natural gradients on q(u) and Adam on the
hyperparameters (Salimbeni, Eleftheriadis & Hensman 2018).

Written from the equations in plain torch (``torch.linalg`` and
autograd); it imports nothing of gpflow_slim_tpu_torch and works out again
from the inputs whatever the program derives: the minibatch indices (the
same ``torch.randperm`` calls on a generator of the same seed), the Grams,
the factors, the KL, the quadrature and the natgrad update. float64 is the
reference; float32 with TF32 on is the control of lower precision.
"""

import math

import numpy as np
import torch

from port_bench.plain import Precision, adam, positive, rbf, unconstrain

HYPERS = ("lengthscale", "variance", "Z")
LEAVES = HYPERS + ("q_mu", "q_sqrt")


def data(config, seed):
    """X ~ U[0, 1] (N, 1), Y = 1[sin(10 x) > 0], Z on a grid of M points,
    float32: bench_svgp_natgrad's data (copied from chip_smoke.py's
    ``svgp_data``), its RandomState seeded from ``seed`` in place of 0."""
    rng = np.random.RandomState(seed % 2**32)
    X = rng.uniform(0, 1, (config["num_data"], 1)).astype(np.float32)
    Y = (np.sin(10 * X) > 0).astype(np.float32)
    Z = np.linspace(0, 1, config["num_inducing"], dtype=np.float32)[:, None]
    return X, Y, Z


def probit(f, config):
    c = config["probit_clamp"]
    return 0.5 * (1 + torch.erf(f / math.sqrt(2))) * (1 - 2 * c) + c


def neg_elbo(Xb, Yb, h, m, L, config):
    """-(N / B sum of E_q log p(y | f) - KL(q(u) || p(u))) over one batch,
    unwhitened: q(u) = N(m, L L^T), p(u) = N(0, Kuu) (chip_smoke.py's
    ``oracle_elbo``, differentiable in the hyperparameters, m and L)."""
    floor = config["positive_minimum"]
    ls, var, Z = positive(h["lengthscale"], floor), positive(h["variance"], floor), h["Z"]
    M = Z.shape[0]
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    Lu = torch.linalg.cholesky(rbf(Z, Z, ls, var) + config["jitter"] * eye)
    A = torch.linalg.solve_triangular(Lu, rbf(Z, Xb, ls, var), upper=False)
    W = torch.linalg.solve_triangular(Lu.T, A, upper=True)  # Kuu^-1 Kuf
    mean = (W.T @ m)[:, 0]
    fvar = var - (A**2).sum(0) + ((L.T @ W) ** 2).sum(0)
    x, w = np.polynomial.hermite.hermgauss(config["gauss_hermite_points"])
    x, w = torch.as_tensor(x, dtype=Z.dtype, device=Z.device), torch.as_tensor(w, dtype=Z.dtype, device=Z.device)
    f = mean[None, :] + torch.sqrt(2 * fvar)[None, :] * x[:, None]
    p = probit(f, config)
    logp = torch.where(Yb[:, 0][None, :] == 1, torch.log(p), torch.log(1 - p))
    ve = (w[:, None] / math.sqrt(math.pi) * logp).sum(0)
    Lm = torch.linalg.solve_triangular(Lu, m, upper=False)
    LL = torch.linalg.solve_triangular(Lu, L, upper=False)
    kl = 0.5 * ((Lm**2).sum() + (LL**2).sum() - M + 2 * torch.log(torch.diagonal(Lu)).sum()
                - torch.log(torch.diagonal(L) ** 2).sum())
    return -(ve.sum() * (config["num_data"] / Xb.shape[0]) - kl)


def _chol(S):
    L, info = torch.linalg.cholesky_ex(0.5 * (S + S.T))
    return L if int(info) == 0 and bool(torch.isfinite(L).all()) else None


def natgrad(m0, L0, loss_of, gamma, halvings):
    """theta <- theta - gamma dL/deta in the natural parameters theta =
    (S^-1 m, -S^-1 / 2), dL/deta by autograd through the expectation
    parameters eta = (m, S + m m^T); gamma halved up to ``halvings`` times
    until the new q factors. Returns (m, L), q kept where no step factors."""
    e1 = m0.clone().requires_grad_()
    e2 = (L0 @ L0.T + m0 @ m0.T).requires_grad_()
    S = e2 - e1 @ e1.T
    L = torch.linalg.cholesky(0.5 * (S + S.T))
    d1, d2 = torch.autograd.grad(loss_of(e1, L), (e1, e2))
    S_inv = torch.cholesky_inverse(L0)
    th1, th2 = S_inv @ m0, -0.5 * S_inv
    for k in range(halvings + 1):
        g = gamma * 0.5**k
        Lp = _chol(-2 * (th2 - g * d2))  # the new precision's factor
        if Lp is None:
            continue
        S = torch.cholesky_inverse(Lp)
        m, Lq = S @ (th1 - g * d1), _chol(S)
        if Lq is not None and bool(torch.isfinite(m).all()):
            return m, Lq
    return m0, L0


def batches(config, traffic, seed, device):
    """The minibatch indices of each step, from a generator of the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    N = config["num_data"]
    while True:
        yield torch.randperm(N, generator=gen, device=device)[: traffic["batch_size"]]


def fit(config, traffic, X, Y, Z, seed, steps, dtype, device):
    """``steps`` steps of natgrad on q then Adam on the hyperparameters, from
    the start: the batch loss after each natgrad step, the hyperparameters'
    first gradient and each leaf's change after the steps (the positive
    hyperparameters unconstrained, q_sqrt its lower triangle)."""
    with Precision(dtype):
        Xt = torch.as_tensor(X, device=device).to(dtype)
        Yt = torch.as_tensor(Y, device=device).to(dtype)
        M = Z.shape[0]
        floor = config["positive_minimum"]
        h = {"lengthscale": unconstrain(config["lengthscale"], floor, dtype, device),
             "variance": unconstrain(config["variance"], floor, dtype, device),
             "Z": torch.as_tensor(Z, device=device).to(dtype)}
        m = torch.zeros(M, 1, dtype=dtype, device=device)
        L = torch.eye(M, dtype=dtype, device=device)
        start = {**{k: v.clone() for k, v in h.items()}, "q_mu": m.clone(), "q_sqrt": L.clone()}
        state, losses, grad1 = {}, [], None
        idx = batches(config, traffic, seed, device)
        for s in range(steps):
            i = next(idx)
            Xb, Yb = Xt[i], Yt[i]
            m, L = natgrad(m, L, lambda mm, LL: neg_elbo(Xb, Yb, h, mm, LL, config),
                           traffic["gamma"], traffic["max_halvings"])
            leaves = {k: v.detach().requires_grad_() for k, v in h.items()}
            loss = neg_elbo(Xb, Yb, leaves, m.detach(), L.detach(), config)
            g = dict(zip(HYPERS, torch.autograd.grad(loss, [leaves[k] for k in HYPERS])))
            losses.append(loss.item())
            if s == 0:
                grad1 = {k: v.double() for k, v in g.items()}
            h = {k: v.detach() for k, v in leaves.items()}
            adam(h, g, state, traffic["learning_rate"])
            m, L = m.detach(), L.detach()
        end = {**h, "q_mu": m, "q_sqrt": torch.tril(L)}
        return {"losses": losses, "grad1": grad1, "change": {k: (end[k] - start[k]).double() for k in LEAVES}}
