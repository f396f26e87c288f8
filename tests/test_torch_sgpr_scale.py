"""SGPR at the configuration of the benchmark's million-row cell
(``port_bench/configs/sgpr-m512-matern32-d11.json``: Matern-3/2 with one
lengthscale per input on D = 11, Z trainable), at a size the CPU runs:
the port's collapsed bound and every gradient against port_bench's plain
reference in float64, on both routes (the kernel route on the CPU runs the
cross Gram's plain version and its closed-form VJP, the padded factor and
the TRSM's Function); the reference's blocked bound against the dense
textbook form; and the spans of ``SGPR.build_likelihood`` and
``GPRFITC.build_likelihood``. This file imports no JAX.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu_torch.ops import linalg as port_linalg
from gpflow_slim_tpu_torch.utils import trace, traced

REF_PATH = Path(__file__).resolve().parents[1] / "port_bench" / "reference" / "sgpr-m512-matern32-d11.py"
CONFIG = json.loads((REF_PATH.parents[1] / "configs" / "sgpr-m512-matern32-d11.json").read_text())
# the program's leaves -> the reference's (port_bench/loops/sgpr_fit.py's map)
LEAVES = {"feature.Z": "Z", "kern.lengthscales": "lengthscale", "kern.variance": "variance",
          "likelihood.variance": "noise_variance"}
N, M = 300, 24
F64 = torch.float64


def _reference():
    spec = importlib.util.spec_from_file_location("reference_sgpr_m512_matern32_d11", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.fixture(params=["plain_route", "kernel_route"])
def route(request, monkeypatch):
    if request.param == "kernel_route":
        calls = []

        def forced(t):
            calls.append(t.dtype)
            return True

        monkeypatch.setattr(port_linalg, "kernels_active", forced)
        yield request.param
        assert calls, "the kernel route was not taken"
    else:
        yield request.param


def _config():
    """The configuration at the CPU's size, with the program's float64
    jitter (the reference adds what the program adds)."""
    return {**CONFIG, "num_inducing": M, "jitter": gft.config.default_jitter(F64)}


def _model(seed, model="SGPR"):
    """The configuration's model at the reference's start, every leaf then
    moved by a seeded random amount (lengthscales about 3, where the 11
    inputs' distances give a Gram far from 0 and 1), and its data."""
    cfg = _config()
    X, Y = REF.data(cfg, N, seed)
    s = REF.start(cfg, X, seed)
    rng = np.random.RandomState(seed)
    kern = gft.kernels.Matern32(11, variance=1.3, lengthscales=3.0 * np.exp(0.2 * rng.randn(11)))
    m = getattr(gft.models, model)(X, Y, kern=kern, Z=s["Z"] + 0.1 * rng.randn(M, 11), device="cpu", dtype=F64)
    with torch.no_grad():
        p = m.likelihood.variance
        p.unconstrained.copy_(p.transform.backward(torch.tensor(0.05 + 0.1 * rng.rand(), dtype=F64)))
    return m, X, Y, cfg


def _dense_bound(X, Y, u, cfg):
    """log N(y | 0, Qff + s2 I) - tr(Kff - Qff) / (2 s2), Qff = Kfu Kuu^-1
    Kuf, formed whole: the textbook form of Titsias's bound."""
    floor = cfg["positive_minimum"]
    ls, var, s2 = (REF.positive(u[k], floor) for k in ("lengthscale", "variance", "noise_variance"))
    Z = u["Z"]
    Kuu = REF.matern32(Z, Z, ls, var) + cfg["jitter"] * torch.eye(M, dtype=F64)
    Kuf = REF.matern32(Z, X, ls, var)
    Qff = Kuf.T @ torch.linalg.solve(Kuu, Kuf)
    C = Qff + s2 * torch.eye(X.shape[0], dtype=F64)
    mvn = torch.distributions.MultivariateNormal(torch.zeros(X.shape[0], dtype=F64), covariance_matrix=C)
    return mvn.log_prob(Y[:, 0]) - (X.shape[0] * var - torch.trace(Qff)) / (2 * s2)


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_sgpr_matches_the_plain_reference(seed, route):
    """The objective and the gradient of Z, the 11 lengthscales, the
    variance and the noise against the reference's -bound, 1e-10 relative:
    the two compute the same float64 numbers in other orders (the reference
    sums its M x M and M x 1 products over blocks of columns), which leaves
    ~1e-13."""
    m, X, Y, cfg = _model(seed)
    loss = m.objective()
    loss.backward()
    leaves = dict(gft.params.trainable_leaves(m))
    assert set(leaves) == set(LEAVES)
    assert leaves["kern.lengthscales"].shape == (11,) and leaves["feature.Z"].shape == (M, 11)
    u = {LEAVES[n]: t.detach().clone().requires_grad_() for n, t in leaves.items()}
    want = -REF.bound(torch.tensor(X, dtype=F64), torch.tensor(Y, dtype=F64), u, cfg, block=128)
    grads = dict(zip(u, torch.autograd.grad(want, list(u.values()))))
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-10)
    for n, t in leaves.items():
        g = grads[LEAVES[n]]
        np.testing.assert_allclose(t.grad.numpy(), g.numpy(), rtol=1e-10, atol=1e-10 * float(g.abs().max()),
                                   err_msg=n)


@pytest.mark.parametrize("block", [N, 128, 37, 1])
def test_blocked_reference_equals_the_dense_bound(block):
    """The reference's bound taken over 1, 3, 9 or 300 blocks of columns,
    and its gradient, against the dense textbook form, 1e-10 relative."""
    m, X, Y, cfg = _model(5)
    u = {LEAVES[n]: t.detach().clone().requires_grad_() for n, t in gft.params.trainable_leaves(m)}
    Xt, Yt = torch.tensor(X, dtype=F64), torch.tensor(Y, dtype=F64)
    got = REF.bound(Xt, Yt, u, cfg, block=block)
    want = _dense_bound(Xt, Yt, u, cfg)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-10)
    g_got = torch.autograd.grad(got, list(u.values()))
    g_want = torch.autograd.grad(want, list(u.values()))
    for k, a, b in zip(u, g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10 * float(b.abs().max()), err_msg=k)


def test_data_and_start_follow_the_seed():
    cfg = _config()
    X, Y = REF.data(cfg, 1000, 2**31 + 1)
    assert X.shape == (1000, 11) and Y.shape == (1000, 1) and X.dtype == Y.dtype == np.float32
    assert abs(float(X.mean())) < 0.05 and abs(float(X.std()) - 1) < 0.05  # standardised
    s = REF.start(cfg, X, 2**31 + 1)
    assert s["Z"].shape == (M, 11) and len({tuple(z) for z in s["Z"]}) == M
    assert all(any(np.array_equal(z, x) for x in X) for z in s["Z"])  # rows of X
    assert s["lengthscale"].shape == (11,) and s["noise_variance"] == 0.1
    X2, _ = REF.data(cfg, 1000, 2**31 + 2)
    assert np.array_equal(REF.data(cfg, 1000, 2**31 + 1)[0], X) and not np.array_equal(X, X2)
    # Y is the stated function of X plus noise of standard deviation 0.1
    s1, s2 = X.sum(1) / math.sqrt(11), (X * np.where(np.arange(11) % 2 == 0, 1, -1)).sum(1) / math.sqrt(11)
    resid = Y[:, 0] - (np.sin(s1) + 0.5 * np.cos(2 * s2))
    assert 0.08 < float(resid.std()) < 0.12


@pytest.mark.parametrize("model,inner", [("SGPR", "gfs.sgpr.likelihood"), ("GPRFITC", "gfs.gprfitc.likelihood")])
def test_sparse_likelihood_span_holds_its_kernels(model, inner, monkeypatch):
    """On (the kernel route forced on the CPU), each sparse model's bound
    lies in its own span, which holds the cross Gram's, the factor's and
    the TRSM's forward spans; off, nothing is recorded; the objective and
    gradients are bitwise those of a run with tracing off."""
    monkeypatch.setattr(port_linalg, "kernels_active", lambda t: True)
    trace.disable()

    def run():
        m, _, _, _ = _model(7, model)
        loss = m.objective()
        loss.backward()
        return [loss.detach(), *(t.grad.clone() for _, t in gft.params.trainable_leaves(m))]

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = run()
    assert not [e.name for e in prof.events() if e.name.startswith("gfs.")]
    with traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    assert not trace.enabled()
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    events = prof.events()
    outer = [e for e in events if e.name == inner]
    assert len(outer) == 1
    for name in ("gfs.gram.fwd", "gfs.cholesky.fwd", "gfs.trsm.fwd"):
        assert any(e.name == name and e.thread == outer[0].thread
                   and outer[0].time_range.start <= e.time_range.start <= e.time_range.end <= outer[0].time_range.end
                   for e in events), name
