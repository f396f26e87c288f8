"""The plain references against closed forms and finite differences, in
float64 on the CPU at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from port_bench import harness, plain

GPR = harness.load_file(harness.BENCH / "reference" / "gpr-rbf-d1.py", "ref_gpr")
SVGP = harness.load_file(harness.BENCH / "reference" / "svgp-bernoulli-m256.py", "ref_svgp")
F64 = torch.float64
CFG = {"lengthscale": 0.3, "variance": 1.7, "noise_variance": 0.4, "positive_minimum": 1e-6}
SCFG = {"num_data": 500, "num_inducing": 8, "lengthscale": 0.2, "variance": 1.3, "jitter": 1e-4,
        "gauss_hermite_points": 20, "probit_clamp": 1e-3, "positive_minimum": 1e-6, "whiten": False}


def _u(cfg, leaves):
    return {k: plain.unconstrain(cfg[k], cfg["positive_minimum"], F64, "cpu") for k in leaves}


def test_positive_round_trip():
    u = plain.unconstrain(0.1, 1e-6, F64, "cpu")
    assert abs(float(plain.positive(u, 1e-6)) - 0.1) < 1e-15


def test_gpr_objective_one_point():
    X, Y = torch.tensor([[0.3]], dtype=F64), torch.tensor([[0.8]], dtype=F64)
    s2 = CFG["variance"] + CFG["noise_variance"]
    want = 0.5 * math.log(2 * math.pi) + 0.5 * math.log(s2) + 0.5 * 0.8**2 / s2
    assert abs(float(GPR.objective(X, Y, _u(CFG, GPR.LEAVES), CFG)) - want) < 1e-12


def test_gpr_gradient_finite_differences():
    X, Y = (torch.as_tensor(a, dtype=F64) for a in GPR.data(CFG, 7, seed=3))
    u = {k: v.requires_grad_() for k, v in _u(CFG, GPR.LEAVES).items()}
    g = torch.autograd.grad(GPR.objective(X, Y, u, CFG), [u[k] for k in GPR.LEAVES])
    for k, gk in zip(GPR.LEAVES, g):
        h = 1e-6
        up = {j: (v.detach() + (h if j == k else 0)) for j, v in u.items()}
        dn = {j: (v.detach() - (h if j == k else 0)) for j, v in u.items()}
        fd = (GPR.objective(X, Y, up, CFG) - GPR.objective(X, Y, dn, CFG)) / (2 * h)
        assert abs(float(gk) - float(fd)) < 1e-6 * max(1, abs(float(fd)))


def test_gpr_predict_one_point():
    X, Y = np.array([[0.2]], np.float32), np.array([[1.5]], np.float32)
    post = GPR.posterior(CFG, X, Y, F64, "cpu")
    xq = np.array([[0.5]], np.float32)
    mean, var = GPR.predict(CFG, post, xq, F64)
    x0, x1 = float(np.float32(0.2)), float(np.float32(0.5))
    k = CFG["variance"] * math.exp(-0.5 * (x1 - x0) ** 2 / CFG["lengthscale"] ** 2)
    s2 = CFG["variance"] + CFG["noise_variance"]
    assert abs(float(mean[0]) - k * 1.5 / s2) < 1e-12
    assert abs(float(var[0]) - (CFG["variance"] - k * k / s2)) < 1e-12


def test_adam_first_step_is_lr_times_sign():
    p = {"a": torch.tensor([1.0, -2.0], dtype=F64)}
    plain.adam(p, {"a": torch.tensor([3.0, -1e-3], dtype=F64)}, {}, lr=0.01)
    assert torch.allclose(p["a"], torch.tensor([0.99, -1.99], dtype=F64), atol=1e-7)


def _svgp_inputs(seed=5):
    X, Y, Z = SVGP.data(SCFG, seed)
    h = {**_u(SCFG, ("lengthscale", "variance")), "Z": torch.as_tensor(Z, dtype=F64)}
    return torch.as_tensor(X[:40], dtype=F64), torch.as_tensor(Y[:40], dtype=F64), h


def test_svgp_kl_vanishes_at_the_prior():
    """q = p(u) = N(0, Kuu): the KL is 0 and the ELBO is the variational
    expectations alone; with the prior's variance at ~1e-6 each is log
    probit(0) = log 0.5 (the clamp keeps probit(0) at 0.5)."""
    Xb, Yb, h = _svgp_inputs()
    h["variance"] = plain.unconstrain(2e-6, 1e-6, F64, "cpu")  # variance 1e-6
    ls, var = plain.positive(h["lengthscale"], 1e-6), plain.positive(h["variance"], 1e-6)
    M = h["Z"].shape[0]
    Lu = torch.linalg.cholesky(plain.rbf(h["Z"], h["Z"], ls, var) + SCFG["jitter"] * torch.eye(M, dtype=F64))
    got = -float(SVGP.neg_elbo(Xb, Yb, h, torch.zeros(M, 1, dtype=F64), Lu, SCFG))
    want = SCFG["num_data"] * math.log(0.5)
    assert abs(got - want) < 1e-5 * abs(want)


def test_svgp_gradient_finite_differences():
    Xb, Yb, h = _svgp_inputs()
    M = h["Z"].shape[0]
    m = torch.linspace(-1, 1, M, dtype=F64)[:, None]
    L = torch.eye(M, dtype=F64) * 0.5 + 0.1 * torch.tril(torch.ones(M, M, dtype=F64), -1)
    leaves = {k: v.clone().requires_grad_() for k, v in h.items()}
    g = torch.autograd.grad(SVGP.neg_elbo(Xb, Yb, leaves, m, L, SCFG), [leaves["lengthscale"], leaves["Z"]])
    eps = 1e-6
    for k, gk, i in (("lengthscale", g[0], ()), ("Z", g[1], (3, 0))):
        up = {j: v.detach().clone() for j, v in h.items()}
        dn = {j: v.detach().clone() for j, v in h.items()}
        up[k][i] += eps
        dn[k][i] -= eps
        fd = (SVGP.neg_elbo(Xb, Yb, up, m, L, SCFG) - SVGP.neg_elbo(Xb, Yb, dn, m, L, SCFG)) / (2 * eps)
        assert abs(float(gk[i]) - float(fd)) < 1e-5 * max(1, abs(float(fd)))


def test_natgrad_unit_step_lands_on_the_target():
    """For L = KL(q || N(mu, Sigma)), dL/deta = theta(q) - theta(target):
    one step with gamma = 1 lands on the target exactly."""
    M = 5
    gen = torch.Generator().manual_seed(0)
    A = torch.randn(M, M, generator=gen, dtype=F64)
    Sigma = A @ A.T + M * torch.eye(M, dtype=F64)
    mu = torch.randn(M, 1, generator=gen, dtype=F64)

    def kl(m, L):
        Si = torch.linalg.inv(Sigma)
        S = L @ L.T
        d = mu - m
        return 0.5 * (torch.trace(Si @ S) + (d.T @ Si @ d).sum() - M + torch.logdet(Sigma) - torch.logdet(S))

    m, L = SVGP.natgrad(torch.zeros(M, 1, dtype=F64), torch.eye(M, dtype=F64), kl, 1.0, 8)
    assert torch.allclose(m, mu, atol=1e-10)
    assert torch.allclose(L @ L.T, Sigma, atol=1e-9)


@pytest.mark.parametrize("number", ["loss", "grad", "change"])
def test_training_numbers_are_zero_on_equal_runs(number):
    from port_bench import compare

    run = {"losses": [3.0, 2.0], "grad1": {"a": torch.ones(2), "b": torch.ones(1)},
           "change": {"a": torch.ones(2), "b": torch.ones(1)}}
    assert compare.training(run, run)[number] == 0
