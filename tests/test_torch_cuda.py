"""Card-only tests of the port's CUDA kernels against their plain versions.

Each kernel is built from csrc/ and compared, at small and ragged shapes,
with its plain PyTorch version run in float64 on the card. They skip where
there is no CUDA device. On a machine with a card and without JAX (whose
import tests/conftest.py needs)::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import re

import numpy as np
import pytest
import torch

import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu_torch.ops import _build, chol_inverse, cholesky, gram, nkn, trsm
from gpflow_slim_tpu_torch.ops import linalg as ops_linalg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _xs(N, D, dev, seed=0):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.uniform(0, 1, (N, D)) / 0.2, dtype=torch.float32, device=dev)


# the kernel writes bands of 8 rows, 1024 columns a sweep: N = 1003 is not a
# multiple of 8, its pad of 21 rows spans whole pad bands, and 2100 rows
# need three sweeps
@pytest.mark.parametrize("kind", list(gram.KINDS))
@pytest.mark.parametrize("N,D,pad_to", [(1, 1, 64), (130, 2, 192), (333, 5, 384), (1003, 1, 1024),
                                        (1003, 5, 1024), (2100, 1, 2112)])
def test_operand_kernel_matches_plain(dev, kind, N, D, pad_to):
    xs = _xs(N, D, dev)
    var = torch.tensor(1.7, device=dev)
    noise = torch.tensor(0.3, device=dev)
    got = gram.gram_chol_operand_cuda(kind, xs, var, noise, pad_to)
    want = gram.gram_chol_operand_plain(kind, xs.double(), 1.7, 0.3, pad_to)
    lower = torch.ones(pad_to, pad_to, dtype=torch.bool, device=dev).tril_()
    # f32 rounding of exp and d^2: 1e-5 x variance absolute
    assert float((got.double() - want)[lower].abs().max()) <= 1e-5 * 1.7


# the cross Gram's band writer: partial 8-row bands (N = 1, 7, 10001), rows
# that are not 16-byte aligned (M = 1, 3, 1023, 2049: the scalar-store
# variant), last sweeps of one column (M = 1025, 2049), D up to 8; X2s shares
# its first rows with Xs (d = 0, where Matern12 is steepest)
@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("N,M", [(n, m) for n in (1, 7, 10001) for m in (1, 3, 1023, 1024, 1025, 2049)])
def test_cross_gram_edges_match_reference(dev, N, M, D):
    rng = np.random.RandomState(N + M + D)
    xs = torch.tensor(rng.uniform(0, 1, (N, D)) / 0.3, dtype=torch.float32, device=dev)
    x2 = torch.tensor(rng.uniform(0, 1, (M, D)) / 0.3, dtype=torch.float32, device=dev)
    x2[:min(N, M)] = xs[:min(N, M)]
    for kind in gram.KINDS:
        got = gram.gram_cuda(kind, xs, x2, torch.tensor(1.7, device=dev))
        want = gram.gram_reference(kind, xs.double(), x2.double(), 1.7)
        assert float((got.double() - want).abs().max()) <= 1e-5 * 1.7, kind


def test_gram_and_vjp_hold_with_tf32_on(dev):
    # TF32 turned on for the process: the plain Gram's expansion and the
    # kernel route's Gram VJP still run in full precision (the same bits as
    # with TF32 off), and the settings come back as they were
    xs = _xs(3000, 2, dev)
    x2 = _xs(700, 2, dev, seed=1)
    G = torch.tensor(np.random.RandomState(2).randn(3000, 700), dtype=torch.float32, device=dev)

    def run():
        K = gram.gram_reference("matern32", xs, x2, 1.3)
        a, b = xs.clone().requires_grad_(), x2.clone().requires_grad_()
        v = torch.tensor(1.3, device=dev, requires_grad=True)
        return K, torch.autograd.grad(torch.sum(gram.stationary_gram("matern32", a, b, v) * G), (a, b, v))

    K0, g0 = run()
    saved = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        K1, g1 = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()) == saved
    assert torch.equal(K0, K1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    want = gram.gram_reference("matern32", xs.double(), x2.double(), 1.3)
    assert float((K1.double() - want).abs().max()) <= 1e-4 * 1.3
    a, b, v = (t.double().requires_grad_() for t in (xs, x2, torch.tensor(1.3, device=dev)))
    g64 = torch.autograd.grad(torch.sum(gram.gram_reference("matern32", a, b, v) * G.double()), (a, b, v))
    for got, w in zip(g1, g64):
        assert float((got.double() - w).abs().max()) <= 1e-3 * float(w.abs().max())


# 256, 320 and 1000: one full 256-wide panel, then a last panel of 64 and
# of 232 columns
@pytest.mark.parametrize("N,P", [(64, 1), (130, 8), (500, 3), (130, 9), (333, 20), (256, 1), (320, 8),
                                 (1000, 9)])
def test_chol_kernel_matches_plain(dev, N, P):
    Np = N + (-N) % cholesky.BLOCK
    Kp = gram.gram_chol_operand_cuda("matern52", _xs(N, 1, dev), 1.0, 0.5, Np)
    rng = np.random.RandomState(1)
    Dp = torch.zeros(Np, P, device=dev)
    Dp[:N] = torch.tensor(rng.randn(N, P), dtype=torch.float32, device=dev)
    D0 = Dp.clone()
    Lw, aw, hw = cholesky.cholesky_solve_plain(torch.tril(Kp).double(), Dp.double())
    Lg, ag, hg = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
    torch.cuda.synchronize()
    # f32 factorization against f64: relative 1e-5 on the logdet, 1e-4 on
    # alpha and L (max-norm)
    assert abs(float(hg) - float(hw)) <= 1e-5 * abs(float(hw))
    assert float((ag.double() - aw).abs().max()) <= 1e-4 * float(aw.abs().max())
    assert float((torch.tril(Lg).double() - Lw).abs().max()) <= 1e-4 * float(Lw.abs().max())
    assert bool((ag[N:] == 0).all())
    assert torch.equal(Dp, D0)  # Dp untouched


# the trailing update's persistent walk (chol_trailing_kernel_hi): 2112 (a
# last panel of 64 columns, a ragged 128-tile), 4160 and 10048 (the cells'
# side: 40 panels, the last 64 wide, more tiles than the card holds blocks)
# on the cells' operand (RBF, lengthscale 0.1, unit variance and noise),
# fused and factor only, against f64 at test_chol_kernel_matches_plain's
# gates; a second factorization of the same K equal bit for bit
@pytest.mark.parametrize("Np", [2112, 4160, 10048])
@pytest.mark.parametrize("P", [1, 7])
def test_chol_trailing_walk_matches_plain(dev, Np, P):
    N = Np - 37
    xs = torch.tensor(np.random.RandomState(Np).uniform(0, 1, (N, 1)) / 0.1, dtype=torch.float32, device=dev)
    Kp = gram.gram_chol_operand_cuda("rbf", xs, 1.0, 1.0, Np)
    Dp = torch.zeros(Np, P, device=dev)
    Dp[:N] = torch.tensor(np.random.RandomState(P).randn(N, P), dtype=torch.float32, device=dev)
    Lw, aw, hw = cholesky.cholesky_solve_plain(torch.tril(Kp).double(), Dp.double())
    Lg, ag, hg = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
    L2, a2, h2 = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
    Lf = cholesky.cholesky_cuda(Kp.clone())
    torch.cuda.synchronize()
    assert abs(float(hg) - float(hw)) <= 1e-5 * abs(float(hw))
    assert float((ag.double() - aw).abs().max()) <= 1e-4 * float(aw.abs().max())
    for L in (Lg, Lf):
        assert float((torch.tril(L).double() - Lw).abs().max()) <= 1e-4 * float(Lw.abs().max())
    assert bool((ag[N:] == 0).all())
    assert torch.equal(torch.tril(Lg), torch.tril(L2)) and torch.equal(ag, a2) and torch.equal(hg, h2)
    # both modes run the same launches on the factor
    assert torch.equal(torch.tril(Lg), torch.tril(Lf))


# bad: a negative noise (the first pivot fails), or one pivot made negative
# inside the first 256-wide panel (row 150, its third block) or the second
# (row 300)
@pytest.mark.parametrize("bad", [None, 150, 300])
def test_chol_kernel_nan_on_non_positive_pivot(dev, bad):
    if bad is None:
        Kp = gram.gram_chol_operand_cuda("rbf", _xs(100, 1, dev), 1.0, -5.0, 128)
    else:
        Kp = gram.gram_chol_operand_cuda("rbf", _xs(400, 1, dev), 1.0, 0.5, 448)
        Kp[bad, bad] = -10.0
    Np = Kp.shape[0]
    L = cholesky.cholesky_cuda(Kp.clone())
    _, alpha, hld = cholesky.cholesky_solve_cuda(Kp, torch.ones(Np, 1, device=dev))
    torch.cuda.synchronize()
    assert torch.isnan(hld)
    first = 0 if bad is None else bad
    assert bool(torch.isnan(L[first, first]))
    assert bool(torch.isfinite(torch.tril(L[:first, :first])).all())


def test_wrappers_raise_instead_of_falling_back(dev):
    x64 = _xs(10, 1, dev).double()
    with pytest.raises(ValueError, match="float32"):
        gram.gram_chol_operand_cuda("rbf", x64, 1.0, 0.1, 64)
    with pytest.raises(ValueError, match="multiple of 4"):
        gram.gram_chol_operand_cuda("rbf", _xs(10, 1, dev), 1.0, 0.1, 66)
    with pytest.raises(ValueError, match="multiple of 64"):
        cholesky.cholesky_solve_cuda(torch.zeros(100, 100, device=dev), torch.zeros(100, 1, device=dev))
    with pytest.raises(ValueError, match="at least one column"):
        cholesky.cholesky_solve_cuda(torch.zeros(64, 64, device=dev), torch.zeros(64, 0, device=dev))
    L, a, g = torch.eye(64, device=dev), torch.zeros(64, 1, device=dev), torch.zeros((), device=dev)
    with pytest.raises(ValueError, match="float32"):
        chol_inverse.csl_vjp_cuda(L.double(), a, g, g)
    with pytest.raises(ValueError, match="multiple of 64"):
        chol_inverse.csl_vjp_cuda(torch.eye(100, device=dev), torch.zeros(100, 1, device=dev), g, g)
    with pytest.raises(ValueError, match="at least one column"):
        chol_inverse.csl_vjp_cuda(L, torch.zeros(64, 0, device=dev), g, g)
    xs, G = _xs(10, 1, dev), torch.zeros(64, 64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        gram.gram_operand_vjp_cuda("rbf", G, x64, 1.0)
    with pytest.raises(ValueError, match="unknown kind"):
        gram.gram_operand_vjp_cuda("periodic", G, xs, 1.0)
    for bad in (G.double(), G.half(), G.cpu(), G[:9, :9], G.T):
        with pytest.raises(ValueError, match="rows contiguous"):
            gram.gram_operand_vjp_cuda("rbf", bad, xs, 1.0)


def _csl_system(Np, P, dev):
    """A factored padded system of side Np (Np - 37 rows of data, at least
    one) through the kernels: ``(Lp, alpha, N)``."""
    N = max(Np - 37, 1)
    Kp = gram.gram_chol_operand_cuda("rbf", _xs(N, 1, dev), 1.0, 0.5, Np)
    Dp = torch.zeros(Np, P, device=dev)
    Dp[:N] = torch.tensor(np.random.RandomState(3).randn(N, P), dtype=torch.float32, device=dev)
    Lp, alpha, _ = cholesky.cholesky_solve_cuda(Kp, Dp)
    return Lp, alpha, N


# Np = 64: no doubling level; 128: one; 1088 (17 blocks): levels whose last
# pair has a short or no second half; 2048 and 10048: the cells' sides
@pytest.mark.parametrize("Np,P", [(64, 1), (128, 3), (1088, 1), (2048, 1), (10048, 1)])
def test_csl_vjp_kernel_matches_plain(dev, Np, P):
    Lp, alpha, N = _csl_system(Np, P, dev)
    ghl, gq = torch.tensor(0.7, device=dev), torch.tensor(-1.3, device=dev)
    before = _build.launches["gfs_csl_vjp"]
    Kbar, Dbar = chol_inverse.csl_vjp_cuda(Lp, alpha, ghl, gq)
    torch.cuda.synchronize()
    assert _build.launches["gfs_csl_vjp"] == before + 1
    Kw, Dw = chol_inverse.csl_vjp_plain(Lp.double(), alpha.double(), ghl.double(), gq.double())
    # both in f64 from the same f32 factor, in another order of sums: 1e-10
    # of the largest entry, on top of the kernel's one rounding to f32
    for got, want in ((Kbar, Kw), (Dbar, Dw)):
        err = (got.double() - want).abs() - 2.0 ** -24 * want.abs()
        assert float(err.max()) <= 1e-10 * float(want.abs().max())
    assert torch.equal(Kbar, Kbar.T)
    # the pad: beta is 0 there and W the identity, so Kbar's pad block is
    # 1/2 ghl I and its pad rows are 0 against the data, exactly
    half = torch.full((), 0.35, device=dev)
    assert torch.equal(Kbar[N:, N:], half * torch.eye(Np - N, device=dev))
    assert bool((Kbar[N:, :N] == 0).all()) and bool((Dbar[N:] == 0).all())


def test_csl_vjp_kernel_runs_once_a_backward(dev):
    Lp, alpha, N = _csl_system(1088, 2, dev)
    Kp = gram.gram_chol_operand_cuda("rbf", _xs(N, 1, dev), 1.0, 0.5, 1088).requires_grad_()
    Dp = torch.zeros(1088, 2, device=dev)
    Dp[:N] = torch.tensor(np.random.RandomState(3).randn(N, 2), dtype=torch.float32, device=dev)
    Dp.requires_grad_()
    before = _build.launches["gfs_csl_vjp"]
    hl, q = cholesky.cholesky_solve_logdet(Kp.clone(), Dp)
    (0.7 * hl - 1.3 * q).backward()
    assert _build.launches["gfs_csl_vjp"] == before + 1
    Kw, Dw = chol_inverse.csl_vjp_plain(Lp.double(), alpha.double(), torch.tensor(0.7).double(),
                                        torch.tensor(-1.3).double())
    assert float((Kp.grad.double() - Kw).abs().max()) <= 1e-6 * float(Kw.abs().max())
    assert float((Dp.grad.double() - Dw).abs().max()) <= 1e-6 * float(Dw.abs().max())
    # under torch.func: grad of each system of a batch, through the
    # kernels' Function (one launch a system)
    before = _build.launches["gfs_csl_vjp"]
    Ks = torch.stack([Kp.detach(), Kp.detach()])
    gK = torch.func.vmap(torch.func.grad(lambda k: cholesky.cholesky_solve_logdet(k, Dp.detach())[0]))(Ks)
    assert _build.launches["gfs_csl_vjp"] == before + 2
    Kh, _ = chol_inverse.csl_vjp_plain(Lp.double(), alpha.double(), torch.tensor(1.0).double(),
                                       torch.tensor(0.0).double())
    for g in gK:
        assert float((g.double() - Kh).abs().max()) <= 1e-6 * float(Kh.abs().max())


def test_csl_vjp_backward_launches_no_library_product(dev):
    # the N = 10000 fit's backward of the fused factor: the kinv kernels
    # alone, no cuBLAS GEMM or GEMV and no TRSM (the solve against I)
    Lp, alpha, N = _csl_system(10048, 1, dev)
    Kp = gram.gram_chol_operand_cuda("rbf", _xs(N, 1, dev), 1.0, 0.5, 10048).requires_grad_()
    hl, q = cholesky.cholesky_solve_logdet(Kp.clone(), alpha)
    loss = 0.5 * hl + q
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert {"kinv_diag_kernel", "kinv_left_kernel", "kinv_kbar_kernel"} <= {
        m.group(0) for n in names for m in [re.search(r"kinv_\w+_kernel", n)] if m}
    assert not [n for n in names if re.search("gemm|gemv|trsm", n, re.IGNORECASE)], names


def _opnd_vjp_inputs(N, D, Np, dev, seed=0):
    """Inputs with points repeated off the diagonal (d^2 = 0) and a
    cotangent with no symmetry, nonzero in its pad rows and columns."""
    xs = _xs(N, D, dev, seed)
    if N >= 3:
        xs[N // 2] = xs[0]
        xs[N - 1] = xs[1]
    G = torch.tensor(np.random.RandomState(seed + 1).randn(Np, Np), dtype=torch.float32, device=dev)
    return xs, G


def _opnd_vjp_close(got, want):
    # both f64 from the same inputs, in another order of sums (and d^2 by
    # differences, not the expansion): 1e-9 of each leaf's largest entry on
    # top of the kernel's one rounding to f32
    for g, w in zip(got, want):
        err = (g.double() - w).abs() - 2.0 ** -24 * w.abs()
        assert float(err.max()) <= 1e-9 * float(w.abs().max()), (float(err.max()), float(w.abs().max()))


# N = 1 (one tile, no pair), 63 and 64 (one ragged and one full tile), 1000,
# 2048 and 10000 (the cells' sides); Np past N with a nonzero pad
@pytest.mark.parametrize("kind", list(gram.KINDS))
@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("N", [1, 63, 64, 1000, 2048, 10000])
def test_operand_vjp_kernel_matches_plain(dev, kind, D, N):
    Np = N + (-N) % 64 + 64
    xs, G = _opnd_vjp_inputs(N, D, Np, dev)
    var = torch.tensor(1.7, device=dev)
    before = _build.launches["gfs_gram_operand_vjp"]
    got = gram.gram_operand_vjp_cuda(kind, G, xs, var)
    assert _build.launches["gfs_gram_operand_vjp"] == before + 1
    _opnd_vjp_close(got, gram.gram_operand_vjp_plain(kind, G, xs, var))


def test_operand_vjp_kernel_reads_g_in_place(dev):
    # g with its row stride: a view of a wider matrix
    N = 1000
    wide = torch.randn(N, 1500, device=dev)
    xs, var = _xs(N, 2, dev), torch.tensor(0.6, device=dev)
    _opnd_vjp_close(gram.gram_operand_vjp_cuda("rbf", wide[:, 100:1300], xs, var),
                    gram.gram_operand_vjp_plain("rbf", wide[:, 100:1300], xs, var))


def test_operand_vjp_kernel_is_bitwise_repeatable(dev):
    for N, D in ((10000, 1), (2048, 3)):
        xs, G = _opnd_vjp_inputs(N, D, N + (-N) % 64, dev)
        var = torch.tensor(1.1, device=dev)
        a = gram.gram_operand_vjp_cuda("matern32", G, xs, var)
        b = gram.gram_operand_vjp_cuda("matern32", G, xs, var)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_operand_vjp_runs_once_a_backward(dev):
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (700, 2)).astype(np.float32)
    Y = (np.sin(12 * X[:, :1]) + 0.1 * rng.randn(700, 1)).astype(np.float32)
    m = gft.models.GPR(X, Y, kern=gft.kernels.Matern52(2, lengthscales=0.1), device=dev, dtype=torch.float32)
    before = _build.launches["gfs_gram_operand_vjp"]
    m.objective().backward()
    assert _build.launches["gfs_gram_operand_vjp"] == before + 1
    # under torch.func: grad of each system of a batch, through the VJP's
    # Function (one launch a system), against autograd on each
    Np = 704
    xs = _xs(700, 2, dev)
    Dp = torch.zeros(Np, 1, device=dev)
    Dp[:700] = torch.tensor(Y, device=dev)
    var, noise = torch.tensor(1.2, device=dev), torch.tensor(0.3, device=dev)

    def loss(x, v):
        return sum(cholesky.cholesky_solve_logdet(gram.gram_chol_operand("rbf", x, v, noise, Np), Dp))

    batch = torch.stack([xs, 1.1 * xs])
    before = _build.launches["gfs_gram_operand_vjp"]
    gx, gv = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)), in_dims=(0, None))(batch, var)
    assert _build.launches["gfs_gram_operand_vjp"] == before + 2
    for i in range(2):
        x, v = batch[i].clone().requires_grad_(), var.clone().requires_grad_()
        loss(x, v).backward()
        assert float((gx[i] - x.grad).abs().max()) <= 1e-6 * float(x.grad.abs().max())
        assert abs(float(gv[i]) - float(v.grad)) <= 1e-6 * abs(float(v.grad))


def test_operand_vjp_backward_launches_only_its_kernels(dev):
    # the N = 10000 fit's operand backward: the VJP kernel and its reduce,
    # no torch elementwise or reduction kernel, no cuBLAS GEMV, no host
    # sync; the most launches of each over three profiled backwards (the
    # profiler may lose events)
    xs = _xs(10000, 1, dev).requires_grad_()
    var, noise = torch.tensor(1.0, device=dev, requires_grad=True), torch.tensor(0.5, device=dev, requires_grad=True)
    G = torch.randn(10048, 10048, device=dev)
    most, syncs = {}, gft.utils.trace.host_syncs
    for _ in range(3):
        Kp = gram.gram_chol_operand("rbf", xs, var, noise, 10048)
        torch.cuda.synchronize()
        with gft.utils.traced(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            grads = torch.autograd.grad(Kp, (xs, var, noise), G)  # no accumulation into .grad
            torch.cuda.synchronize()
        assert [tuple(g.shape) for g in grads] == [(10000, 1), (), ()]
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [m.group(0) for n in names for m in [re.search(r"gram_operand_vjp(_reduce)?_kernel", n)] if m]
        assert len(ours) == len(names), names
        for k in set(ours):
            most[k] = max(most.get(k, 0), ours.count(k))
    assert most == {"gram_operand_vjp_kernel": 1, "gram_operand_vjp_reduce_kernel": 1}, most
    assert gft.utils.trace.host_syncs == syncs
    # the span that holds them
    Kp = gram.gram_chol_operand("rbf", xs, var, noise, 10048)
    with gft.utils.traced(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        Kp.backward(G)
        torch.cuda.synchronize()
    assert "gfs.gram_operand.bwd" in {e.name for e in prof.events()}


@pytest.mark.parametrize("P", [1, 11])
def test_gpr_kernel_route_matches_f64_plain(dev, P):
    # P = 11: a Y wider than the diag kernel's 8-column shared-memory chunk
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (700, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.1 * rng.randn(700, P)).astype(np.float32)
    m32 = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=dev,
                         dtype=torch.float32)
    m64 = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=dev,
                         dtype=torch.float64)
    gft.interop.load_unconstrained(m64, {
        n: p.unconstrained.detach().cpu().numpy() for n, p in gft.params.parameters(m32)})
    before = (_build.launches["gfs_gram_chol_operand"], _build.launches["gfs_chol_solve_logdet"])
    loss32 = m32.objective()
    loss32.backward()
    after = (_build.launches["gfs_gram_chol_operand"], _build.launches["gfs_chol_solve_logdet"])
    assert after == (before[0] + 1, before[1] + 1)
    loss64 = m64.objective()
    loss64.backward()
    # f32 kernels against the f64 plain route: the bench gate on the value,
    # 1e-3 on each gradient
    assert abs(loss32.item() - loss64.item()) <= 1e-5 * abs(loss64.item())
    g64 = dict(gft.params.parameters(m64))
    for n, p in gft.params.parameters(m32):
        want = float(g64[n].unconstrained.grad)
        assert abs(float(p.unconstrained.grad) - want) <= 1e-3 * abs(want), n


@pytest.mark.parametrize("kind", list(gram.KINDS))
@pytest.mark.parametrize("N,M,D", [(1, 1, 1), (130, 33, 2), (333, 200, 5)])
def test_gram_kernels_match_plain(dev, kind, N, M, D):
    xs, x2s = _xs(N, D, dev), _xs(M, D, dev, seed=1)
    var = torch.tensor(1.7, device=dev)
    got = gram.gram_cuda(kind, xs, x2s, var)
    want = gram.gram_reference(kind, xs.double(), x2s.double(), 1.7)
    # f32 rounding of exp and d^2: 1e-5 x variance absolute
    assert float((got.double() - want).abs().max()) <= 1e-5 * 1.7
    low = gram.gram_lower_cuda(kind, xs, var)
    want = gram.gram_lower_plain(kind, xs.double(), 1.7)
    t = torch.arange(N, device=dev) // gram.TILE
    upper_tiles = t[:, None] < t[None, :]
    assert bool((low[upper_tiles] == 0).all())
    assert float((low.double() - want).abs().max()) <= 1e-5 * 1.7


# the lower-tile Gram's bands, tiles and sweeps: 1-row bands below N = 2112
# (1 .. 1003), 8-row bands above, partial bands and tiles, N % 4 != 0 on the
# scalar-store variant, last 1024-column sweeps of one column (4097, 10001)
@pytest.mark.parametrize("D", [1, 2, 5, 8])
@pytest.mark.parametrize("N", [1, 7, 31, 32, 33, 255, 1003, 2047, 2048, 4097, 10001])
def test_lower_gram_edges_match_plain(dev, N, D):
    xs = torch.tensor(np.random.RandomState(N + D).uniform(0, 1, (N, D)) / 0.3, dtype=torch.float32, device=dev)
    t = torch.arange(N, device=dev) // gram.TILE
    upper_tiles = t[:, None] < t[None, :]
    var = torch.tensor(1.7, device=dev)
    for kind in gram.KINDS:
        before = _build.launches["gfs_gram_lower"]
        got = gram.gram_lower_cuda(kind, xs, var)
        assert _build.launches["gfs_gram_lower"] == before + 1
        assert bool((got[upper_tiles] == 0).all()), kind
        # every entry, the diagonal tiles' upper ones included; f32 rounding
        # of exp and d^2: 1e-5 x variance absolute
        want = gram.gram_lower_plain(kind, xs.double(), 1.7)
        assert float((got.double() - want).abs().max()) <= 1e-5 * 1.7, kind


@pytest.mark.parametrize("N", [1, 63, 64, 65, 130, 200, 333, 256, 320, 1000])
def test_cholesky_kernel_matches_plain(dev, N):
    Np = N + (-N) % cholesky.BLOCK
    Kp = gram.gram_chol_operand_cuda("matern52", _xs(N, 1, dev), 1.0, 0.5, Np)
    Lw = cholesky.cholesky_plain(torch.tril(Kp).double())
    Lg = cholesky.cholesky_cuda(Kp.clone())
    torch.cuda.synchronize()
    # f32 factorization against f64: 1e-4 relative on L (max-norm), 1e-5 on
    # the half-logdet from its diagonal (f64 pivots, as the fused kernel)
    assert float((torch.tril(Lg).double() - Lw).abs().max()) <= 1e-4 * float(Lw.abs().max())
    hw = float(torch.log(torch.diagonal(Lw)).sum())
    assert abs(float(torch.log(torch.diagonal(Lg).double()).sum()) - hw) <= 1e-5 * max(abs(hw), 1.0)
    # the padded, masked wrapper on the kernel route
    K = gram.gram_lower_cuda("matern52", _xs(N, 1, dev), 1.0)
    K.diagonal().add_(0.5)
    before = _build.launches["gfs_cholesky"]
    L = cholesky.cholesky(K)
    assert _build.launches["gfs_cholesky"] == before + 1
    assert float((L.double() - Lw[:N, :N]).abs().max()) <= 1e-4 * float(Lw.abs().max())
    assert bool((torch.triu(L, 1) == 0).all())


# P <= 64 runs the thin schedule (one launch), P > 64 the wide one: 64 and
# 65 are the boundary. 333 and 577: more than one group of four block
# columns (one, and two and a half)
@pytest.mark.parametrize("N,P", [(1, 1), (63, 7), (64, 1), (65, 130), (200, 64), (333, 3),
                                 (577, 130), (1000, 1), (1000, 64), (1000, 65)])
def test_trsm_kernel_matches_plain(dev, N, P):
    Np = N + (-N) % cholesky.BLOCK
    Kp = gram.gram_chol_operand_cuda("rbf", _xs(N, 1, dev), 1.0, 0.3, Np)
    L = cholesky.cholesky_cuda(Kp)[:N, :N].tril_()  # a view with row stride Np
    B = torch.tensor(np.random.RandomState(2).randn(N, P), dtype=torch.float32, device=dev)
    B0 = B.clone()
    Ld = L.double()
    for T, Td, lower in ((L, Ld, True), (L.T, Ld.T, False), (L.contiguous(), Ld, True),
                         (L.T.contiguous(), Ld.T, False)):
        before = _build.launches.copy()
        got = trsm.trsm_cuda(T, B, lower)
        want = torch.linalg.solve_triangular(Td, B.double(), upper=not lower)
        # f32 substitution against f64: 1e-3 relative (max-norm), the fused
        # kernel's alpha gate
        assert float((got.double() - want).abs().max()) <= 1e-3 * float(want.abs().max())
        schedule = "thin" if P <= 64 else "wide"
        assert _build.launches["gfs_trsm", schedule] == before["gfs_trsm", schedule] + 1
    assert torch.equal(B, B0)  # B untouched


def test_serving_kernels_at_svgp_shapes(dev):
    # the cross Gram, factor-only Cholesky and TRSM as base_conditional runs
    # them on the SVGP benchmark's Kuu (256 points on [0, 1], lengthscale
    # 0.2, jitter 1e-4: cond ~1e6) and a 1024-point Kuf. The factor is held
    # within 2x cuSOLVER's f32 error + 1e-4 (f32's own error is ~6e-4 at
    # this conditioning), the solves at 1e-3 relative
    Zs = torch.linspace(0, 1, 256, device=dev)[:, None] / 0.2
    Xs = _xs(1024, 1, dev)  # on [0, 1], scaled by the lengthscale 0.2
    Kzz, Kuf = (gram.gram_cuda("rbf", Zs, X2, 1.0) for X2 in (Zs, Xs))
    for K, X2 in ((Kzz, Zs), (Kuf, Xs)):
        want = gram.gram_reference("rbf", Zs.double(), X2.double(), 1.0)
        assert float((K.double() - want).abs().max()) <= 1e-5
    Kuu = Kzz + 1e-4 * torch.eye(256, device=dev)
    L_ref = cholesky.cholesky_plain(Kuu.double())
    Lm = cholesky.cholesky_cuda(Kuu.clone()).tril_()
    e_kernel = float((Lm.double() - L_ref).abs().max())
    e_lib = float((torch.linalg.cholesky(Kuu).double() - L_ref).abs().max())
    assert e_kernel <= 2 * e_lib + 1e-4 * float(L_ref.abs().max()), (e_kernel, e_lib)
    A = trsm.trsm_cuda(Lm, Kuf, True)
    for got, T, B, lower in ((A, Lm, Kuf, True), (trsm.trsm_cuda(Lm.T, A, False), Lm.T, A, False)):
        want = torch.linalg.solve_triangular(T.double(), B.double(), upper=not lower)
        assert float((got.double() - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_serving_wrappers_raise_instead_of_falling_back(dev):
    x = _xs(10, 1, dev)
    with pytest.raises(ValueError, match="CUDA float32"):
        gram.gram_cuda("rbf", x.cpu(), x.cpu(), 1.0)
    with pytest.raises(ValueError, match="CUDA float32"):
        gram.gram_lower_cuda("rbf", x.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        gram.gram_cuda("rbf", x, torch.cat([x, x], 1)[:, :1], 1.0)
    with pytest.raises(ValueError, match="bad inputs"):
        gram.gram_cuda("rbf", x, _xs(10, 2, dev), 1.0)
    with pytest.raises(ValueError, match="multiple of 64"):
        cholesky.cholesky_cuda(torch.eye(100, device=dev))
    with pytest.raises(ValueError, match="CUDA float32"):
        cholesky.cholesky_cuda(torch.eye(64))
    L = torch.eye(64, device=dev)
    with pytest.raises(ValueError, match="CUDA float32"):
        trsm.trsm_cuda(L.cpu(), torch.ones(64, 1), True)
    with pytest.raises(ValueError, match="contiguous B"):
        trsm.trsm_cuda(L, torch.ones(64, 2, device=dev)[:, :1], True)
    with pytest.raises(ValueError, match="row major or transposed"):
        trsm.trsm_cuda(torch.eye(128, device=dev)[::2, ::2], torch.ones(64, 1, device=dev), True)
    with pytest.raises(ValueError, match="bad shapes"):
        trsm.trsm_cuda(L, torch.ones(63, 1, device=dev), True)


def test_posterior_kernel_route_matches_f64_plain(dev):
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (700, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.1 * rng.randn(700, 2)).astype(np.float32)
    Xq = rng.uniform(0, 1, (333, 1)).astype(np.float32)
    m32 = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=dev,
                         dtype=torch.float32)
    m64 = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=dev,
                         dtype=torch.float64)
    kernels = ("gfs_gram", "gfs_gram_lower", "gfs_cholesky", "gfs_trsm")
    before = [_build.launches[k] for k in kernels]
    with torch.no_grad():
        mean, var = m32.posterior().predict_f(Xq)
        after = [_build.launches[k] for k in kernels]
        mean64, var64 = m64.posterior().predict_f(Xq)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert after[3] == before[3] + 3  # TRSM: two for alpha, one for A
    # f32 kernels against the f64 plain route: the conditioning of K + noise I
    # here (noise 1) keeps the f32 error near 1e-5
    assert float((mean.double() - mean64).abs().max()) <= 1e-4 * float(mean64.abs().max())
    assert float((var.double() - var64).abs().max()) <= 1e-4


def _tri_batch(P, M, dev, seed=0):
    # well-conditioned lower triangles, as tests/test_pallas.py makes them
    rng = np.random.RandomState(seed)
    L = np.stack([np.tril(rng.randn(M, M)) + M * np.eye(M) for _ in range(P)])
    return torch.tensor(L, dtype=torch.float32, device=dev)


# chip_smoke.py's phase-3 shapes, the work items' edges: one block row
# (M <= 64), M = 1, 65 and 200 ragged against the 64-row block, K = 32 and
# 33 a whole and a ragged 32-column strip, and at (16, 1024, 1024) more
# items than the card has SMs (16 x 32 strips x 16 block rows); 1024 is the
# TPU kernel's stated size
@pytest.mark.parametrize("P", [1, 16])
@pytest.mark.parametrize("M", [1, 64, 65, 200, 256, 1024])
@pytest.mark.parametrize("Kc", ["1", "32", "33", "40", "M"])
def test_batched_trsm_kernel_matches_plain(dev, P, M, Kc):
    K = M if Kc == "M" else int(Kc)
    L = _tri_batch(P, M, dev)
    B = torch.tensor(np.random.RandomState(1).randn(P, M, K), dtype=torch.float32, device=dev)
    B0 = B.clone()
    Ld = L.double()
    L0, Ld0 = L[:1].expand(P, -1, -1), Ld[:1].expand(P, -1, -1)  # a stride-0 batch
    cases = [(L, Ld, True), (L.mT, Ld.mT, False),  # lower, and upper through the transposed view
             (L0, Ld0, True), (L0.mT, Ld0.mT, False)]
    for T, Td, lower in cases:
        before = _build.launches["gfs_batched_trsm"]
        got = trsm.batched_trsm_cuda(T, B, lower)
        assert _build.launches["gfs_batched_trsm"] == before + 1  # one launch, whatever the items
        want = trsm.solve_triangular_plain(Td, B.double(), lower)
        # f32 substitution against f64: 1e-3 relative (max-norm), TRSM_TOL
        assert float((got.double() - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert torch.equal(B, B0)  # B untouched: the solve is out of place


@pytest.mark.parametrize("M", [65, 256])
def test_batched_trsm_backward_kernel_matches_plain(dev, M):
    P, K = 4, 40
    L = _tri_batch(1, M, dev, 3)
    B = torch.tensor(np.random.RandomState(4).randn(P, M, K), dtype=torch.float32, device=dev)
    G = torch.tensor(np.random.RandomState(5).randn(P, M, K), dtype=torch.float32, device=dev)
    grads = []
    for dtype in (torch.float32, torch.float64):
        t = L.to(dtype).clone().requires_grad_()  # fresh leaves in each dtype
        b = B.to(dtype).clone().requires_grad_()
        before = _build.launches["gfs_batched_trsm"]
        X = (trsm.batched_solve_lower if dtype == torch.float32 else
             lambda a, c: trsm.solve_triangular_plain(a, c, True))(t.expand(P, -1, -1), b)
        torch.sum(X * G.to(dtype)).backward()
        if dtype == torch.float32:  # forward and backward both launched the kernel
            assert _build.launches["gfs_batched_trsm"] == before + 2
        grads.append((t.grad.double(), b.grad.double()))
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_batched_trsm_wrapper_raises_instead_of_falling_back(dev):
    L = torch.eye(64, device=dev)[None]
    with pytest.raises(ValueError, match="CUDA float32"):
        trsm.batched_trsm_cuda(L.double(), torch.ones(1, 64, 1, device=dev, dtype=torch.float64), True)
    with pytest.raises(ValueError, match="contiguous B"):
        trsm.batched_trsm_cuda(L, torch.ones(1, 64, 2, device=dev)[:, :, :1], True)
    with pytest.raises(ValueError, match="row major or transposed"):
        trsm.batched_trsm_cuda(torch.eye(128, device=dev)[None, ::2, ::2], torch.ones(1, 64, 1, device=dev),
                               True)
    with pytest.raises(ValueError, match="bad shapes"):
        trsm.batched_trsm_cuda(L, torch.ones(2, 64, 1, device=dev), True)


@pytest.mark.parametrize("whiten", [False, True])
def test_svgp_elbo_kernel_route_matches_f64_plain(dev, whiten):
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (2000, 1)).astype(np.float32)
    Y = (np.sin(10 * X) > 0).astype(np.float32)
    Z = np.linspace(0, 1, 64, dtype=np.float32)[:, None]
    Xb, Yb = X[:512], Y[:512]

    def elbo_and_grads(dtype, use_kernels):
        m = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.2),
                            likelihood=gft.likelihoods.Bernoulli(), Z=Z, whiten=whiten,
                            device=dev, dtype=dtype)
        # the f32 jitter on every route, so the three compute one function
        with gft.config.temp_settings(use_kernels=use_kernels, jitter=1e-4):
            loss = -m.build_likelihood_batch(Xb, Yb)
            loss.backward()
        return loss.item(), {n: p.unconstrained.grad.double() for n, p in gft.params.parameters(m)}

    kernels = ("gfs_gram", "gfs_cholesky", "gfs_trsm", "gfs_batched_trsm")
    before = [_build.launches[k] for k in kernels]
    k32 = elbo_and_grads(torch.float32, True)
    after = [_build.launches[k] for k in kernels]
    assert all(a > b for a, b in zip(after[:3], before[:3])), (before, after)
    assert (after[3] > before[3]) == (not whiten)  # only the unwhitened KL solves in a batch
    p32 = elbo_and_grads(torch.float32, False)
    assert [_build.launches[k] for k in kernels] == after  # use_kernels=False launches nothing
    v64, g64 = elbo_and_grads(torch.float64, False)
    # the kernel route within 2x the stock f32 route's error against f64,
    # plus 1e-6 relative on the value and 1e-5 (max-norm) on each gradient:
    # the f32 conditioning of Kuu sets the scale of both routes' errors
    err = [abs(v - v64) / abs(v64) for v, _ in (k32, p32)]
    assert err[0] <= 2 * err[1] + 1e-6, err
    for n, want in g64.items():
        # (whitened, at q = N(0, I) the ELBO does not depend on Z or the
        # lengthscale: an exact 0 is compared in absolute terms)
        scale = float(want.abs().max()) or 1.0
        e = [float((g[n] - want).abs().max()) / scale for _, g in (k32, p32)]
        assert e[0] <= 2 * e[1] + 1e-5, (n, e)


# natgrad_step's batched pass replayed from its CUDA graph equals the same
# pass run eagerly, call after call (the graph's input buffers are refreshed
# on each call); d2 ~ -10 I makes the first step sizes fail
@pytest.mark.parametrize("scale,halves", [(0.01, False), (10.0, True)])
def test_natgrad_pass_replays_its_graph_as_eager(dev, scale, halves):
    from gpflow_slim_tpu_torch.training import natgrad

    rng = np.random.RandomState(3)
    M, P = 16, 2

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    for _ in range(3):
        m0, d1 = f32(rng.randn(M, P)), f32(rng.randn(M, P))
        L0 = f32(np.tril(rng.randn(P, M, M) * 0.1) + np.eye(M))
        B = rng.randn(P, M, M) * 0.01
        d2 = f32(-scale * (np.eye(M) + B + B.transpose(0, 2, 1)))
        want = natgrad._attempts(m0, L0, d1, d2, 1.0)
        got = natgrad._update(m0, L0, d1, d2, 1.0)
        assert bool(got[2]) and (int(got[3]) > 0) == halves
        assert bool(want[2]) and int(want[3]) == int(got[3])
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# -- BASELINE config #2's sparse path (SGPR, GPRFITC, the composite GPR) ----

def _config2_kern():
    return gft.kernels.Matern32(1, lengthscales=0.2) + gft.kernels.Periodic(1, period=0.16, lengthscales=0.5)


def _config2_kuu(n, dev):
    # config #2's Kuu on n grid points with the f32 jitter, padded to a
    # multiple of 64 with a unit diagonal, as ops.cholesky pads it
    Z = torch.linspace(0, 1, n, device=dev)[:, None]
    with torch.no_grad():
        K = _config2_kern().to(device=dev, dtype=torch.float32).K(Z) + 1e-4 * torch.eye(n, device=dev)
    Kp, _ = ops_linalg.pad_system(K, torch.zeros(n, 1, device=dev))
    return K, Kp


# the factor of M = 64 and 100 inducing points: Np = 64 and 128, less than
# one 256-wide panel. Both modes against f64, each error within twice
# cuSOLVER's f32 error plus the fixed gate (factor 1e-4, half-logdet 1e-5,
# alpha 1e-3, relative): Kuu's f32 conditioning sets both (cuSOLVER's f32
# alpha is ~2e-3 off f64 at M = 100, chip_smoke.py phase 3); alpha's pad
# rows exactly 0
@pytest.mark.parametrize("n", [64, 100])
def test_cholesky_modes_at_inducing_sides(dev, n):
    _, Kp = _config2_kuu(n, dev)
    Np = Kp.shape[0]
    Dp = torch.zeros(Np, 1, device=dev)
    Dp[:n] = torch.tensor(np.random.RandomState(n).randn(n, 1), dtype=torch.float32, device=dev)
    L_ref, a_ref, h_ref = cholesky.cholesky_solve_plain(torch.tril(Kp).double(), Dp.double())
    L_lib, a_lib, h_lib = cholesky.cholesky_solve_plain(torch.tril(Kp), Dp)
    Lg = torch.tril(cholesky.cholesky_cuda(Kp.clone()))
    _, a_got, h_got = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)

    def rel(a, b):
        return float((a.double() - b).abs().max()) / float(b.abs().max())

    def half_logdet(L):
        return torch.log(torch.diagonal(L).double()).sum()

    assert rel(Lg, L_ref) <= 2 * rel(L_lib, L_ref) + 1e-4
    h_lib = half_logdet(L_lib)
    for got in (half_logdet(Lg), h_got):
        assert rel(got, h_ref) <= 2 * rel(h_lib, h_ref) + 1e-5
    assert rel(a_got, a_ref) <= 2 * rel(a_lib, a_ref) + 1e-3
    assert bool((a_got[n:] == 0).all())


# the wide TRSM with a ragged triangle of two block rows (N = 100) under the
# widths of config #2's path: the thin schedule at P = 1, the wide one at
# N* = 2047 and N = 10000; lower, and upper through the transposed view of
# the padded factor
@pytest.mark.parametrize("P", [1, 2047, 10000])
def test_trsm_at_inducing_shapes(dev, P):
    _, Kp = _config2_kuu(100, dev)
    L = cholesky.cholesky_cuda(Kp)[:100, :100].tril_()  # row stride 128
    B = torch.tensor(np.random.RandomState(P).randn(100, P), dtype=torch.float32, device=dev)
    Ld = L.double()
    for T, Td, lower in ((L, Ld, True), (L.T, Ld.T, False)):
        got = trsm.trsm_cuda(T, B, lower)
        want = torch.linalg.solve_triangular(Td, B.double(), upper=not lower)
        assert float((got.double() - want).abs().max()) <= 1e-3 * float(want.abs().max())


# the cross Gram at 100 rows: 13 eight-row bands, the last half empty (or
# 1-row bands where the grid is small), the scalar-store variant at 2047
@pytest.mark.parametrize("M", [100, 2047, 10000])
def test_cross_gram_at_inducing_rows(dev, M):
    zs = torch.linspace(0, 1, 100, device=dev)[:, None] / 0.2
    xs = _xs(M, 1, dev)
    for kind in gram.KINDS:
        got = gram.gram_cuda(kind, zs, xs, torch.tensor(1.7, device=dev))
        want = gram.gram_reference(kind, zs.double(), xs.double(), 1.7)
        assert float((got.double() - want).abs().max()) <= 1e-5 * 1.7, kind


def _no_library_linalg(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("torch.linalg was called on the kernel route")

    for name in ("cholesky", "cholesky_ex", "solve_triangular"):
        monkeypatch.setattr(torch.linalg, name, boom)


_solve_triangular = torch.linalg.solve_triangular


def _config2_data(N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.3 * np.sin(40 * X) + 0.1 * rng.randn(N, 1)).astype(np.float32)
    return X, Y


def test_composite_gpr_runs_the_padded_fused_kernel(dev, monkeypatch):
    # a kernel without a fused map: K_lower(X) + noise I padded into the
    # fused factor/solve/logdet, never the operand, never torch.linalg
    X, Y = _config2_data(700)
    m32 = gft.models.GPR(X, Y, kern=_config2_kern(), device=dev, dtype=torch.float32)
    kernels = ("gfs_gram_chol_operand", "gfs_chol_solve_logdet", "gfs_gram")
    before = [_build.launches[k] for k in kernels]
    with monkeypatch.context() as mp, torch.no_grad():
        _no_library_linalg(mp)
        value = m32.objective().item()
    after = [_build.launches[k] for k in kernels]
    assert after == [before[0], before[1] + 1, before[2] + 1], (before, after)
    m64 = gft.models.GPR(X, Y, kern=_config2_kern(), device=dev, dtype=torch.float64)
    loss64 = m64.objective()
    loss64.backward()
    m32.objective().backward()
    v64 = loss64.item()
    assert abs(value - v64) <= 1e-5 * abs(v64)  # bench.py's gate
    g64 = dict(gft.params.parameters(m64))
    for n, p in gft.params.parameters(m32):
        want = float(g64[n].unconstrained.grad)
        assert abs(float(p.unconstrained.grad) - want) <= 1e-3 * abs(want), n


@pytest.mark.parametrize("model", ["SGPR", "GPRFITC"])
def test_sparse_kernel_route_matches_f64_plain(dev, model, monkeypatch):
    # config #2 at N = 3000, M = 100: the value and every gradient of the
    # kernel route within 2x the stock f32 route's error against f64, plus
    # bench.py's 1e-5 (value, relative) and the GPR gradient gate 1e-3
    # (gradients, max-norm relative): chip_smoke.py's sparse gates. The
    # objective and its gradient launch the Gram, factor and both TRSM
    # schedules and call no torch.linalg
    X, Y = _config2_data(3000)
    Z = np.linspace(0, 1, 100, dtype=np.float32)[:, None]

    def run(dtype, use_kernels, forbid=False):
        m = getattr(gft.models, model)(X, Y, kern=_config2_kern(), Z=Z, device=dev, dtype=dtype)
        with gft.config.temp_settings(use_kernels=use_kernels, jitter=1e-4), monkeypatch.context() as mp:
            if forbid:
                _no_library_linalg(mp)
            loss = m.objective()
            loss.backward()
        return loss.item(), {n: p.unconstrained.grad.double() for n, p in gft.params.parameters(m)}

    kernels = ("gfs_gram", "gfs_cholesky")
    before = _build.launches.copy()
    k32 = run(torch.float32, True, forbid=True)
    assert all(_build.launches[k] > before[k] for k in kernels), before
    assert all(_build.launches["gfs_trsm", s] > before["gfs_trsm", s] for s in ("thin", "wide"))
    p32 = run(torch.float32, False)
    v64, g64 = run(torch.float64, False)
    err = [abs(v - v64) / abs(v64) for v, _ in (k32, p32)]
    assert err[0] <= 2 * err[1] + 1e-5, err
    for n, want in g64.items():
        scale = float(want.abs().max())
        e = [float((g[n] - want).abs().max()) / scale for _, g in (k32, p32)]
        assert e[0] <= 2 * e[1] + 1e-3, (n, e)


def test_sgpr_posterior_kernel_route_matches_f64_plain(dev):
    X, Y = _config2_data(3000)
    Z = np.linspace(0, 1, 100, dtype=np.float32)[:, None]
    Xq = np.random.RandomState(4).uniform(0, 1, (333, 1)).astype(np.float32)
    out = {}
    for key, dtype, flag in (("kernels", torch.float32, True), ("plain", torch.float32, False),
                             ("f64", torch.float64, False)):
        m = gft.models.SGPR(X, Y, kern=_config2_kern(), Z=Z, device=dev, dtype=dtype)
        with gft.config.temp_settings(use_kernels=flag, jitter=1e-4), torch.no_grad():
            post = m.posterior()
            assert post.L.device.type == "cuda"
            out[key] = post.predict_f(Xq) + post.predict_f(Xq[:50], full_cov=True)
    for k, p, w in zip(out["kernels"], out["plain"], out["f64"]):
        e = [float((t.double() - w).abs().max()) for t in (k, p)]
        assert e[0] <= 2 * e[1] + 1e-6, e


def test_robust_cholesky_on_the_factor_kernel(dev):
    rng = np.random.RandomState(0)
    A = rng.randn(100, 5)
    K = torch.tensor(A @ A.T, dtype=torch.float32, device=dev)  # rank 5
    before = _build.launches["gfs_cholesky"]
    L, jit = ops_linalg.robust_cholesky(K)
    assert _build.launches["gfs_cholesky"] > before
    assert bool(torch.isfinite(L).all())
    scale = float(torch.mean(torch.diagonal(K)))
    assert float((L @ L.T - K).abs().max()) <= 10 * float(jit) + 1e-3 * scale


def _config4(dev, dtype, N=1000):
    """benchmarks/bench_svgp_nuts.py bench_nuts's GPR (BASELINE config #4)."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(6 * X) + 0.2 * rng.randn(N, 1)
    k = gft.kernels.RBF(1, lengthscales=0.3)
    k.variance = gft.params.Param(1.0, transform=gft.transforms.positive(), prior=gft.priors.LogNormal(0.0, 1.0))
    k.lengthscales = gft.params.Param(0.3, transform=gft.transforms.positive(),
                                      prior=gft.priors.LogNormal(-1.0, 1.0))
    m = gft.models.GPR(X, Y, kern=k, device=dev, dtype=dtype)
    m.likelihood.variance = gft.params.Param(0.05, transform=gft.transforms.positive(),
                                             prior=gft.priors.LogNormal(-2.0, 1.0))
    return m.to(device=dev, dtype=dtype)


def _chains(x0, C=8, seed=11):
    return x0[None] + torch.tensor(0.5 * np.random.RandomState(seed).randn(C, x0.numel()), dtype=x0.dtype,
                                   device=x0.device)


def test_config4_batched_logprob_on_the_kernels_matches_f64(dev):
    from gpflow_slim_tpu_torch.mcmc.base import batched_value_and_grad

    lp, x0, _ = gft.mcmc.model_logprob(_config4(dev, torch.float32))
    lp64, _, _ = gft.mcmc.model_logprob(_config4(dev, torch.float64))
    zs = _chains(x0)
    before = (_build.launches["gfs_gram_chol_operand"], _build.launches["gfs_chol_solve_logdet"])
    lps, gs = batched_value_and_grad(lp)(zs)
    after = (_build.launches["gfs_gram_chol_operand"], _build.launches["gfs_chol_solve_logdet"])
    assert (after[0] - before[0], after[1] - before[1]) == (8, 8)  # once per chain
    with gft.config.temp_settings(use_kernels=False):
        lps_stock, gs_stock = batched_value_and_grad(lp)(zs)
    l64, g64 = batched_value_and_grad(lp64)(zs.double())

    def rel(a):
        return float(((a.double() - l64).abs() / l64.abs()).max())

    def grel(a):
        return float(((a.double() - g64).abs().amax(1) / g64.abs().amax(1)).max())

    # f32 carries ~1e-3 in this log posterior (K rounded to f32, noise
    # 0.05): within twice the stock f32 route's error + bench.py's 1e-5,
    # and the gradients + 1e-3, as chip_smoke.py gates config #4
    assert rel(lps) <= 2 * rel(lps_stock) + 1e-5
    assert grel(gs) <= 2 * grel(gs_stock) + 1e-3


def test_config4_batched_logprob_equals_a_loop_on_the_card(dev):
    from gpflow_slim_tpu_torch.mcmc.base import batched_value_and_grad

    m = _config4(dev, torch.float32)
    lp, x0, unpack = gft.mcmc.model_logprob(m)
    zs = _chains(x0, C=4)
    lps, gs = batched_value_and_grad(lp)(zs)
    for c in range(4):
        with torch.no_grad():
            for n, t in unpack(zs[c]).items():
                m.get_parameter(n).copy_(t)
        m.zero_grad(set_to_none=True)
        v = m.log_posterior()
        v.backward()
        g = torch.cat([m.get_parameter(n).grad.reshape(-1) for n in unpack(zs[c])])
        assert abs(lps[c].item() - v.item()) <= 1e-6 * abs(v.item())
        # the lengthscale's gradient is a cancelling f32 sum that a batched
        # reduction adds in another order: held to the gradient gate
        assert float((gs[c] - g).abs().max()) <= 1e-3 * float(g.abs().max())


def test_config4_leaf_that_does_not_factor_diverges(dev):
    # noise at its floor (1e-6) and lengthscale ~3: K + noise I does not
    # factor in f32, the fused kernel gives NaN, and a leaf landing there
    # counts as a divergence with no weight
    import importlib

    from gpflow_slim_tpu_torch.mcmc.base import batched_value_and_grad, kinetic_energy

    nuts_mod = importlib.import_module("gpflow_slim_tpu_torch.mcmc.nuts")
    lp, x0, unpack = gft.mcmc.model_logprob(_config4(dev, torch.float32))
    names = list(unpack(x0))
    fn = batched_value_and_grad(lp)
    bad = x0.clone()
    bad[names.index("kern.lengthscales.unconstrained")] = 3.0
    bad[names.index("likelihood.variance.unconstrained")] = -30.0
    assert not bool(torch.isfinite(fn(bad[None])[0]).all())
    z0 = x0[None]
    lp0, g0 = fn(z0)
    r0 = (bad[None] - z0) - 0.5 * g0
    ones = torch.ones_like(z0)
    sub = nuts_mod._build_subtree(fn, z0, r0, g0, 0, ones[:, 0], ones[:, 0], ones, lp0 - kinetic_energy(r0, ones),
                                  torch.Generator(device=dev))
    assert bool(sub.diverging[0]) and float(sub.sum_accept[0]) == 0.0
    assert float(sub.log_weight[0]) == float("-inf")


def test_config4_short_nuts_run_is_finite(dev):
    m = _config4(dev, torch.float32, N=300)
    lp, x0, _ = gft.mcmc.model_logprob(m)
    before = _build.launches["gfs_gram_chol_operand"]
    samples, info = gft.parallel.sample_chains(lp, x0[None].repeat(4, 1), torch.Generator(device=dev).manual_seed(0),
                                               16, num_warmup=30, max_depth=6)
    assert samples.shape == (4, 16, 3) and bool(torch.isfinite(samples).all())
    # one launch per active chain per leaf, and one per chain at the start
    # of the warmup and of the sampling
    assert _build.launches["gfs_gram_chol_operand"] - before >= int(info["num_leaves"].sum()) + 4


def _vgp_pair(which, dev, N=500, steps=3):
    """The full-data variational slice's models (chip_smoke.py phase 4g's,
    at N = 500): a Poisson VGP on a 25 x 20 grid, or a 3-class Opper-
    Archambeau VGP, float32 on the kernel route after ``steps`` Adam steps
    (every gradient away from 0), and the same point in float32 and
    float64 models."""
    rng = np.random.RandomState(0)
    if which == "VGP":
        gx, gy = np.meshgrid(np.linspace(0, 1, 25), np.linspace(0, 1, 20), indexing="ij")
        X = np.stack([gx.ravel(), gy.ravel()], 1)
        Y = rng.poisson(np.exp(np.sin(6 * X[:, :1]) * np.cos(4 * X[:, 1:])))
        lik = gft.likelihoods.Poisson
        kw = {}
    else:
        X = rng.uniform(0, 1, (N, 2))
        Y = np.argmax(np.stack([np.sin(6 * X[:, 0]), np.cos(5 * X[:, 1]), X[:, 0] - X[:, 1]], 1), 1)[:, None]
        lik = lambda: gft.likelihoods.MultiClass(3)  # noqa: E731
        kw = {"num_latent": 3}
    cls = gft.models.VGP if which == "VGP" else gft.models.VGPOpperArchambeau

    def make(dtype):
        return cls(X.astype(np.float32), Y.astype(np.float32), kern=gft.kernels.RBF(2, lengthscales=0.1),
                   likelihood=lik(), device=dev, dtype=dtype, **kw)

    m32 = make(torch.float32)
    gft.training.fit(m32, num_steps=steps, learning_rate=0.01)
    values = {n: p.unconstrained.detach().cpu().numpy() for n, p in gft.params.parameters(m32)}
    twins = [make(dtype) for dtype in (torch.float32, torch.float64)]
    for m in twins:
        gft.interop.load_unconstrained(m, values)
    return m32, *twins


@pytest.mark.parametrize("which", ["VGP", "OA"])
def test_vgp_kernel_route_matches_f64_plain(dev, which, monkeypatch):
    # chip_smoke.py phase 4g's gates: the ELBO and every gradient of the
    # kernel route within 2x the stock f32 route's error against f64, plus
    # 1e-5 (value, relative) and 1e-3 (gradients, max-norm relative). The
    # VGP's ELBO and gradient launch the lower-tile Gram, the factor and the
    # wide TRSM and call no torch.linalg; Opper-Archambeau's the cross Gram
    # and the factor once per latent, and no torch.linalg factorization
    # (its solves are torch.linalg's, as the JAX package's are jax.scipy's)
    m32, p32, m64 = _vgp_pair(which, dev)

    def run(m, flag, forbid=False):
        m.zero_grad(set_to_none=True)
        with gft.config.temp_settings(use_kernels=flag, jitter=1e-4), monkeypatch.context() as mp:
            if forbid:
                _no_library_linalg(mp)
                if which == "OA":
                    mp.setattr(torch.linalg, "solve_triangular", _solve_triangular)
            loss = m.objective()
            loss.backward()
        return loss.item(), {n: p.unconstrained.grad.double() for n, p in gft.params.parameters(m)}

    kernels = ("gfs_gram_lower" if which == "VGP" else "gfs_gram", "gfs_cholesky", ("gfs_trsm", "wide"))
    before = [_build.launches[k] for k in kernels]
    k32 = run(m32, True, forbid=True)
    after = [_build.launches[k] for k in kernels]
    assert after[0] - before[0] == 1 and after[1] - before[1] == (1 if which == "VGP" else 3), (before, after)
    assert after[2] > before[2]
    s32, v64 = run(p32, False), run(m64, False)
    err = [abs(v - v64[0]) / abs(v64[0]) for v, _ in (k32, s32)]
    assert err[0] <= 2 * err[1] + 1e-5, err
    for n, want in v64[1].items():
        scale = float(want.abs().max())
        e = [float((g[n] - want).abs().max()) / scale for _, g in (k32, s32)]
        assert e[0] <= 2 * e[1] + 1e-3, (n, e)


@pytest.mark.parametrize("which", ["VGP", "OA"])
def test_vgp_predictions_kernel_route_match_f64_plain(dev, which):
    m32, p32, m64 = _vgp_pair(which, dev)
    Xq = np.random.RandomState(3).uniform(0, 1, (300, 2)).astype(np.float32)
    out = {}
    for key, m, flag in (("kernels", m32, True), ("plain", p32, False), ("f64", m64, False)):
        with gft.config.temp_settings(use_kernels=flag, jitter=1e-4), torch.no_grad():
            out[key] = m.predict_f(Xq) + m.predict_y(Xq) + m.predict_f_full_cov(Xq[:40])
    for k, p, w in zip(out["kernels"], out["plain"], out["f64"]):
        assert bool(torch.isfinite(k).all())
        e = [float((t.double() - w).abs().max()) for t in (k, p)]
        assert e[0] <= 2 * e[1] + 1e-6, e


def test_fit_lbfgs_on_the_entry_gpr(dev):
    # entry()'s flagship GPR (N = 2048, float32) on the operand and the
    # fused Cholesky: 3 L-BFGS steps, finite non-increasing losses, the
    # final objective within bench.py's 1e-5 of the f64 plain path
    fn, (m,) = gft.entry.entry()
    assert m.X.is_cuda
    before = _build.launches["gfs_chol_solve_logdet"]
    loss, grads = fn(m)
    assert _build.launches["gfs_chol_solve_logdet"] > before and np.isfinite(loss.item())
    _, losses = gft.training.fit_lbfgs(m, num_steps=3)
    losses = losses.cpu().numpy()
    assert np.isfinite(losses).all() and (np.diff(losses) <= 0).all() and losses[-1] < losses[0]
    m64 = gft.entry.flagship_model(device=dev, dtype=np.float64)
    gft.interop.load_unconstrained(m64, {n: p.unconstrained.detach().cpu().numpy()
                                         for n, p in gft.params.parameters(m)})
    with torch.no_grad():
        got, want = m.objective().item(), m64.objective().item()
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("jitter", [1e-4, 1e-3, 1e-2])
def test_half_logdet_on_an_ill_conditioned_K(dev, jitter):
    # fault l's gate (chip_smoke.py phase 4g): the RBF Gram of a 64 x 32
    # grid over [0, 1]^2 (lengthscale 0.1) + jitter I, Np = 2048 (cond 1.1e6
    # at 1e-4): both Cholesky modes' half-logdet within twice cuSOLVER's
    # f32 error + 1e-6 of the f64 factor of the same f32 input
    gx, gy = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 32), indexing="ij")
    xs = torch.tensor(np.stack([gx.ravel(), gy.ravel()], 1) / 0.1, dtype=torch.float32, device=dev)
    K = gram.gram_lower_cuda("rbf", xs, torch.tensor(1.0, device=dev))
    K.diagonal().add_(jitter)
    ref = float(torch.log(torch.diagonal(cholesky.cholesky_plain(torch.tril(K).double()))).sum())
    lib = float(torch.log(torch.diagonal(cholesky.cholesky_plain(torch.tril(K))).double()).sum())
    fac = float(torch.log(torch.diagonal(cholesky.cholesky_cuda(K.clone())).double()).sum())
    fused = float(cholesky.cholesky_solve_cuda(K.clone(), torch.zeros(2048, 1, device=dev))[2])
    tol = 2 * abs(lib - ref) / abs(ref) + 1e-6
    for got in (fac, fused):
        assert abs(got - ref) / abs(ref) <= tol, (got, ref, lib)


def _deep_cg(dev, dtype, like=None):
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (3000, 2))
    Y = np.sin(3 * (X[:, :1] + 0.5 * X[:, 1:2])) + 0.05 * rng.randn(3000, 1)
    kern = gft.kernels_deep.DeepKernel(2, gft.kernels.RBF(1, lengthscales=0.5),
                                       gft.kernels_deep.mlp_warp([2, 8, 1], torch.Generator().manual_seed(0)))
    m = gft.models.GPRCG(X.astype(np.float32), Y.astype(np.float32), kern=kern, materialize_k=False, cg_iters=60,
                         slq_steps=20, device=dev, dtype=dtype)
    if like is not None:
        m.load_state_dict(like.state_dict())
    return m


def test_gprcg_streaming_on_the_cross_gram_matches_f64_plain(dev, monkeypatch):
    # config #5's path at N = 3000 with 1024-row panels (3 panels, a ragged
    # last one), on given probes: the cross Gram launches once a panel a
    # matvec (+ the surrogate's panels, forward and backward); the value and
    # every gradient (the warp's layer by layer) within 2x the stock f32
    # route's error against f64 + 1e-5 / 1e-3; the warp's last bias, which
    # shifts every warped input alike, has a gradient of zero to f64 rounding
    from gpflow_slim_tpu_torch.models import cg_gpr
    from gpflow_slim_tpu_torch.ops import iterative

    monkeypatch.setattr(cg_gpr, "STREAM_BLOCK", 1024)
    Z = tuple(iterative.rademacher(torch.tensor(3, device=dev), s, (3000, 16), torch.float64) for s in (0, 1))
    monkeypatch.setattr(iterative, "cg_probes", lambda params, n, p, dtype: tuple(z.to(dtype) for z in Z))
    m32 = _deep_cg(dev, torch.float32)
    m64 = _deep_cg(dev, torch.float64, like=m32)

    def run(m, flag):
        m.zero_grad(set_to_none=True)
        with gft.config.temp_settings(use_kernels=flag):
            loss = m.objective()
            loss.backward()
        return loss.item(), {n: t.grad.double() for n, t in gft.params.trainable_leaves(m)}

    before = _build.launches["gfs_gram"]
    k32 = run(m32, True)
    assert _build.launches["gfs_gram"] - before == 3 * (60 + 20 + 2)
    s32, v64 = run(m32, False), run(m64, False)
    err = [abs(v - v64[0]) / abs(v64[0]) for v, _ in (k32, s32)]
    assert err[0] <= 2 * err[1] + 1e-5, err
    shift = f"kern.warp.layers.{len(m32.kern.warp.layers) - 1}.bias"
    top = max(float(w.abs().max()) for w in v64[1].values())
    assert float(v64[1].pop(shift).abs().max()) <= 1e-8 * top
    for n, want in v64[1].items():
        scale = float(want.abs().max())
        e = [float((g[n] - want).abs().max()) / scale for _, g in (k32, s32)]
        assert e[0] <= 2 * e[1] + 1e-3, (n, e)


def test_gplvm_latent_gradient_matches_f64_plain(dev):
    # the X gradient of a GPLVM (example 08's data at N = 1024) goes through
    # the lower-tile Gram's closed-form VJP in f32: within 2x the stock f32
    # route's error against f64 + 1e-3 (max-norm relative), the value 1e-5
    rng = np.random.RandomState(0)
    Xt = rng.randn(1024, 2)
    Y = (np.tanh(Xt @ rng.randn(2, 12)) + 0.05 * rng.randn(1024, 12)).astype(np.float32)
    m32 = gft.models.GPLVM(Y, 2, kern=gft.kernels.RBF(2, ARD=True), device=dev, dtype=torch.float32)
    m64 = gft.models.GPLVM(Y, 2, kern=gft.kernels.RBF(2, ARD=True), device=dev, dtype=torch.float64)
    m64.load_state_dict(m32.state_dict())

    def run(m, flag):
        m.zero_grad(set_to_none=True)
        with gft.config.temp_settings(use_kernels=flag):
            loss = m.objective()
            loss.backward()
        return loss.item(), m.X.unconstrained.grad.double()

    before = _build.launches["gfs_gram_lower"]
    k32 = run(m32, True)
    assert _build.launches["gfs_gram_lower"] > before
    s32, v64 = run(m32, False), run(m64, False)
    err = [abs(v - v64[0]) / abs(v64[0]) for v, _ in (k32, s32)]
    assert err[0] <= 2 * err[1] + 1e-5, err
    scale = float(v64[1].abs().max())
    e = [float((g - v64[1]).abs().max()) / scale for _, g in (k32, s32)]
    assert e[0] <= 2 * e[1] + 1e-3, e


def test_factor_and_solve_take_strided_inputs(dev):
    # a transposed right-hand side (the BayesianGPLVM's psi1^T) and a
    # matrix whose side is a multiple of 64 in another layout (no pad to
    # copy it into rows) reach the kernels contiguous, and the input is not
    # overwritten
    rng = np.random.RandomState(4)
    A = torch.tensor(rng.randn(128, 128), dtype=torch.float32, device=dev)
    K = (A @ A.T + 128 * torch.eye(128, device=dev)).T.contiguous().T  # column-major
    assert not K.is_contiguous()
    K0 = K.clone()
    before = _build.launches["gfs_cholesky"]
    L = ops_linalg.cholesky(K)
    assert _build.launches["gfs_cholesky"] == before + 1 and torch.equal(K, K0)
    B = torch.tensor(rng.randn(300, 128), dtype=torch.float32, device=dev)
    X = ops_linalg.solve_lower(L, B.T)
    want = torch.linalg.solve_triangular(L.double(), B.T.double(), upper=False)
    assert float((X.double() - want).abs().max() / want.abs().max()) <= 1e-5
    half, quad = ops_linalg.chol_logdet_quad(K, B.T[:, :3])
    L64 = torch.linalg.cholesky(K.double())
    assert abs(float(half) - float(torch.log(L64.diagonal()).sum())) <= 1e-5 * abs(float(half))


def test_gprcg_streaming_under_torch_func_on_the_card(dev, monkeypatch):
    # fault m on the kernels: batched_value_and_grad over two rows of the
    # streaming deep-kernel GPRCG (N = 3000, 1024-row panels) on given
    # probes: the cross Gram once a panel a matvec a row; each row's value
    # and gradient within 2x plain autograd's error at that row against f64
    # + 1e-5 / 1e-3 (max-norm)
    from gpflow_slim_tpu_torch.models import cg_gpr
    from gpflow_slim_tpu_torch.ops import iterative

    monkeypatch.setattr(cg_gpr, "STREAM_BLOCK", 1024)
    Z = tuple(iterative.rademacher(torch.tensor(3, device=dev), s, (3000, 16), torch.float64) for s in (0, 1))
    monkeypatch.setattr(iterative, "cg_probes", lambda params, n, p, dtype: tuple(z.to(dtype) for z in Z))
    m32 = _deep_cg(dev, torch.float32)
    lp, x0, _ = gft.mcmc.model_logprob(m32)
    lp64 = gft.mcmc.model_logprob(_deep_cg(dev, torch.float64, like=m32))[0]
    z = torch.stack([x0, x0 + 0.01 * torch.randn(x0.shape, generator=torch.Generator(device=dev).manual_seed(1),
                                                 device=dev)])
    before = _build.launches["gfs_gram"]
    vals, grads = gft.mcmc.base.batched_value_and_grad(lp)(z)
    assert _build.launches["gfs_gram"] - before == 2 * 3 * (60 + 20 + 2)
    for r in range(2):
        refs = []
        for fn, v in ((lp, z[r]), (lp64, z[r].double())):
            v = v.clone().requires_grad_()
            val = fn(v)
            refs.append((val.item(), torch.autograd.grad(val, v)[0].double()))
        (va, ga), (v64, g64) = refs
        assert abs(float(vals[r]) - v64) <= 2 * abs(va - v64) + 1e-5 * abs(v64)
        scale = float(g64.abs().max())
        assert float((grads[r].double() - g64).abs().max()) <= 2 * float((ga - g64).abs().max()) + 1e-3 * scale


def test_dp_step_from_pinned_batches_on_the_card(dev, tmp_path):
    # minibatches read from disk into pinned memory, copied without
    # blocking, through make_svgp_step on the kernels; and a step that draws
    # its batch on the card from a CUDA generator
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (4096, 1)).astype(np.float32)
    Y = (np.sin(10 * X) > 0).astype(np.float32)
    path = gft.io.write_gfsb(str(tmp_path / "xy.gfsb"), np.hstack([X, Y]))
    m = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.2), likelihood=gft.likelihoods.Bernoulli(),
                        Z=np.linspace(0, 1, 32)[:, None], device=dev, dtype=torch.float32)
    step, _ = gft.parallel.make_svgp_step(m, lambda ps: torch.optim.Adam(ps, lr=0.01), batch_size=256)
    ds = gft.io.BinaryDataset(path)
    before = (_build.launches["gfs_gram"], _build.launches["gfs_cholesky"], _build.launches["gfs_trsm"])
    losses = []
    for batch in ds.minibatches(torch.Generator().manual_seed(0), 256, 5, pin_memory=True):
        assert batch.is_pinned()
        b = batch.to(dev, non_blocking=True)
        losses.append(step(batch=(b[:, :1], b[:, 1:])))
    ds.close()
    losses.append(step(torch.Generator(device=dev).manual_seed(1)))
    after = (_build.launches["gfs_gram"], _build.launches["gfs_cholesky"], _build.launches["gfs_trsm"])
    assert all(a >= b + 6 for a, b in zip(after, before))
    assert bool(torch.isfinite(torch.stack(losses)).all())


def test_restored_posterior_serves_bit_for_bit(dev, tmp_path):
    # posterior() -> save_checkpoint -> load_checkpoint into a template of
    # the same shapes whose buffers are empty: the same answers, bit for
    # bit, and no factorization on the restored side
    rng = np.random.RandomState(1)
    X = rng.uniform(0, 1, (2000, 1)).astype(np.float32)
    Y = np.sin(12 * X).astype(np.float32)
    m = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=dev, dtype=torch.float32)
    with torch.no_grad():
        post = m.posterior()
    path = gft.utils.save_checkpoint(str(tmp_path / "post"), post)
    fresh = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1), device=dev, dtype=torch.float32)
    template = gft.models.posterior.GPRPosterior(fresh.kern, fresh.likelihood, fresh.mean_function, fresh.X,
                                                 torch.empty(post.L.shape, device=dev),
                                                 torch.empty_like(post.alpha), 1)
    restored = gft.utils.load_checkpoint(path, template)
    Xq = torch.tensor(rng.uniform(0, 1, (512, 1)), dtype=torch.float32, device=dev)
    before = (_build.launches["gfs_cholesky"], _build.launches["gfs_gram"], _build.launches["gfs_trsm"])
    with torch.no_grad():
        got = restored.predict_f(Xq, full_cov=True)
    after = (_build.launches["gfs_cholesky"], _build.launches["gfs_gram"], _build.launches["gfs_trsm"])
    assert after[0] == before[0] and after[1] > before[1] and after[2] > before[2]
    with torch.no_grad():
        want = post.predict_f(Xq, full_cov=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_blocked_factor_and_solves_on_the_kernels(dev):
    # ops.blocked on a CUDA float32 tensor: each diagonal block on the
    # factor-only Cholesky kernel and each panel and diagonal solve on the
    # wide TRSM, against the f64 plain path; Murray's adjoint through the
    # same solves against 1/2 K^-1
    from gpflow_slim_tpu_torch.ops import blocked

    rng = np.random.RandomState(3)
    N, bs = 1000, 250
    A = rng.randn(N, N) / np.sqrt(N)
    K64 = torch.tensor(A @ A.T + np.eye(N), device=dev)
    K = K64.float()
    before = (_build.launches["gfs_cholesky"], _build.launches["gfs_trsm"])
    L = blocked.blocked_cholesky(K, bs)
    after = (_build.launches["gfs_cholesky"], _build.launches["gfs_trsm"])
    assert after[0] - before[0] == N // bs and after[1] - before[1] == N // bs - 1
    L64 = torch.linalg.cholesky(K64)
    assert float((L.double() - L64).abs().max()) / float(L64.abs().max()) <= 1e-4
    B = torch.tensor(rng.randn(N, 3), dtype=torch.float32, device=dev)
    X = blocked.blocked_solve_lower(L, B, bs)
    want = torch.linalg.solve_triangular(L64, B.double(), upper=False)
    assert float((X.double() - want).abs().max()) / float(want.abs().max()) <= 1e-3
    U = blocked.blocked_solve_upper(L.T, B[:, 0], bs)
    want = torch.linalg.solve_triangular(L64.T, B[:, :1].double(), upper=True)[:, 0]
    assert float((U.double() - want).abs().max()) / float(want.abs().max()) <= 1e-3
    Kg = K.clone().requires_grad_()
    (g,) = torch.autograd.grad(torch.log(torch.diagonal(blocked.blocked_cholesky(Kg, bs))).sum(), Kg)
    want = 0.5 * torch.cholesky_inverse(L64)
    sym = 0.5 * (g + g.T).double()
    assert float((sym - want).abs().max()) / float(want.abs().max()) <= 1e-3


def _one_rank_world():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    gft.parallel.initialize_distributed(f"localhost:{port}", 1, 0)  # nccl


def test_distributed_gpr_on_a_one_rank_nccl_world(dev):
    # make_distributed_gpr_loss on a 1-rank nccl world equals the single
    # device's GPR objective (the fused route), value and gradients, within
    # the f32 gates against each other's f64
    rng = np.random.RandomState(4)
    X = rng.uniform(0, 1, (2000, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.1 * rng.randn(2000, 1)).astype(np.float32)
    m = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=dev, dtype=torch.float32)
    m64 = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=dev, dtype=torch.float64)
    m64.load_state_dict(m.state_dict())
    named = gft.params.trainable_leaves(m)
    _one_rank_world()
    try:
        loss = gft.parallel.make_distributed_gpr_loss(m, gft.parallel.make_mesh({"rows": 1}), axis="rows",
                                                      block_size=250)(m)
        grads = torch.autograd.grad(loss, [t for _, t in named])
    finally:
        torch.distributed.destroy_process_group()
    with gft.config.temp_settings(use_kernels=False):
        want = m64.objective()
        want_g = torch.autograd.grad(want, [t for _, t in gft.params.trainable_leaves(m64)])
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    for g, w in zip(grads, want_g):
        assert float((g.double() - w).abs().max()) <= 1e-3 * float(w.abs().max())


def test_dryrun_multichip_on_the_card(dev):
    _one_rank_world()
    try:
        out = gft.entry.dryrun_multichip(1)
    finally:
        torch.distributed.destroy_process_group()
    assert set(out) == {"dist_gpr", "dp_svgp", "dist_cg", "grid_gpr", "chains"}


# -- the split trailing-update modes (syrk) ------------------------------------

SPLIT_MODES = ("s3", "s4", "s3d", "s4d")


# one m16n8k16 product through the split trailing update's stage layout,
# fragment loads and C map (csrc/chol_solve.cu `gfs_split_mma_check`). On
# small integers (bf16-exact, lo = 0) every pass count gives A B^T exactly,
# so a misplaced row, column or inner index fails here before any factor;
# on general floats it is the split product of `split_product_plain`, to
# the f32 rounding of 16-term sums (1e-6 relative)
@pytest.mark.parametrize("passes", [1, 3, 4])
def test_split_mma_fragment_layout(dev, passes):
    rng = np.random.RandomState(passes)
    for integer in (True, False):
        if integer:
            A, B = rng.randint(-8, 9, (16, 16)), rng.randint(-8, 9, (8, 16))
        else:
            A, B = rng.randn(16, 16), rng.randn(8, 16)
        a = torch.tensor(A, dtype=torch.float32, device=dev)
        b = torch.tensor(B, dtype=torch.float32, device=dev)
        C = torch.full((16, 8), float("nan"), device=dev)
        _build.launch("gfs_split_mma_check", a.data_ptr(), b.data_ptr(), C.data_ptr(), passes, on=a)
        torch.cuda.synchronize()
        got = C.cpu().double()
        if integer:
            assert torch.equal(got, torch.tensor(A @ B.T, dtype=torch.float64))
        else:
            if passes == 1:
                want = cholesky.bf16_split(a.cpu())[0].double() @ cholesky.bf16_split(b.cpu())[0].double().T
            else:
                want = cholesky.split_product_plain(a.cpu(), b.cpu(), "s3" if passes == 3 else "s4").double()
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# one trailing update alone (`gfs_chol_trailing_update`, the first panel's)
# on panel entries x = 2^e (1 + 3 2^-10 + 2^-18), e in {-1, 0}: hi = 2^e, lo
# = 3 2^(e-10), a remainder 2^(e-18), so every product errs one way in each
# mode and the modes' updates part by ~6e-6 of the largest entry ("s3"
# drops ll = 9 2^-20 hh, "s4" the remainder's 2^-17, "d" keeps the diagonal
# tiles exact), ~40x the float32 rounding of a 256-term sum. Each mode's
# update, strictly lower entries, within 1e-6 of its own exact reference
# (f64 sums of the split halves' products), which is more than 3x that
# from every other mode's; the f64 pivots are the exact sums of squares
def _structured_update(Np, syrk, dev, seed=0):
    rng = np.random.RandomState(seed)
    X = 2.0 ** rng.randint(-1, 1, (Np - 256, 256)) * (1 + 3 * 2.0**-10 + 2.0**-18)
    C = rng.randint(-64, 65, (Np - 256, Np - 256)).astype(np.float64)
    K = np.zeros((Np, Np))
    K[256:, :256], K[256:, 256:] = X, C
    Kd = torch.tensor(K, dtype=torch.float32, device=dev)
    dpiv = torch.zeros(Np, dtype=torch.float64, device=dev)
    _build.launch("gfs_chol_trailing_update", Kd.data_ptr(), Np, 0, dpiv.data_ptr(), cholesky._mode_code(syrk), on=Kd)
    torch.cuda.synchronize()
    X, C = torch.tensor(X), torch.tensor(C)
    refs = {}
    for m in ("hi",) + SPLIT_MODES:
        exact = X @ X.T
        if m == "hi":
            P = exact
        else:
            h, lo = cholesky.bf16_split(X)
            P = h @ h.T + h @ lo.T + lo @ h.T + (lo @ lo.T if m.startswith("s4") else 0)
            if m.endswith("d"):
                t = torch.arange(256, Np) // cholesky.TILE
                P = torch.where(t[:, None] == t[None, :], exact, P)
        refs[m] = C - P
    lower = torch.tril(torch.ones(Np - 256, Np - 256, dtype=torch.bool), -1)
    got = Kd[256:, 256:].cpu().double()[lower]
    return got, {m: r[lower] for m, r in refs.items()}, dpiv.cpu(), -(X**2).sum(1)


@pytest.mark.parametrize("syrk", SPLIT_MODES)
@pytest.mark.parametrize("Np", [704, 768])
def test_split_trailing_update_is_its_own_mode(dev, syrk, Np):
    got, refs, dpiv, piv = _structured_update(Np, syrk, dev)
    own = _rel(got, refs[syrk])
    assert own <= 1e-6
    assert min(_rel(r, refs[syrk]) for m, r in refs.items() if m != syrk) > 3 * 1e-6
    assert torch.equal(dpiv[:256], torch.zeros(256, dtype=torch.float64))
    assert float((dpiv[256:] - piv).abs().max()) <= 1e-13 * float(piv.abs().max())


def _split_system(N, Np, P, dev):
    Kp = gram.gram_chol_operand_cuda("matern52", _xs(N, 1, dev), 1.0, 0.5, Np)
    Dp = torch.zeros(Np, P, device=dev)
    Dp[:N] = torch.tensor(np.random.RandomState(P).randn(N, P), dtype=torch.float32, device=dev)
    return Kp, Dp


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()) / float(b.double().abs().max())


# a last 256-wide panel of 64 (320) and of 192 columns (448), and larger
# sides (2112 = 16.5 tiles: a last tile of 64 columns, which has no second
# 64-column half). Each mode's kernel against its plain split version in
# f32 on the same input (L 1e-4 relative max-norm, half-logdet 1e-5, alpha
# 1e-4: the "hi" kernel's gates against f64, test_chol_kernel_matches_plain),
# both within the JAX package's hardware gate on a split factor against
# f64 (Frobenius 5e-4, tests/test_tpu_compiled.py), and not equal to "hi",
# but for a "d" mode at 320, whose one trailing tile is diagonal: exact
@pytest.mark.parametrize("syrk", SPLIT_MODES)
@pytest.mark.parametrize("Np", [320, 448, 2048, 2112])
def test_split_kernel_matches_split_plain(dev, syrk, Np):
    N = Np - 7
    Kp, _ = _split_system(N, Np, 1, dev)
    L64 = cholesky.cholesky_plain(torch.tril(Kp).double())
    Lw = cholesky.cholesky_split_plain(Kp, syrk)
    Lg = torch.tril(cholesky.cholesky_cuda(Kp.clone(), syrk))
    Lhi = torch.tril(cholesky.cholesky_cuda(Kp.clone()))
    torch.cuda.synchronize()
    assert _rel(Lg, Lw) <= 1e-4
    for L in (Lg, Lw):
        assert float(torch.linalg.norm(L.double() - L64) / torch.linalg.norm(L64)) < 5e-4
    assert torch.equal(Lg, Lhi) == (syrk.endswith("d") and Np == 320)  # the split ran where it should

    def half_logdet(L):
        return torch.log(torch.diagonal(L).double()).sum()

    assert abs(float(half_logdet(Lg) - half_logdet(Lw))) <= 1e-5 * abs(float(half_logdet(Lw)))
    for P in (1, 7):
        _, Dp = _split_system(N, Np, P, dev)
        D0 = Dp.clone()
        _, a_w, h_w = cholesky.cholesky_solve_split_plain(Kp.clone(), Dp, syrk)
        Lf, a_g, h_g = cholesky.cholesky_solve_cuda(Kp.clone(), Dp, syrk)
        torch.cuda.synchronize()
        assert abs(float(h_g) - float(h_w)) <= 1e-5 * abs(float(h_w))
        assert _rel(a_g, a_w) <= 1e-4
        assert _rel(torch.tril(Lf), Lw) <= 1e-4
        assert bool((a_g[N:] == 0).all())
        assert torch.equal(Dp, D0)


# one 256-wide panel or less: no trailing update, so every mode is "hi"
# bit for bit, factor and fused alike
@pytest.mark.parametrize("Np", [64, 128])
def test_split_modes_without_a_trailing_update_equal_hi(dev, Np):
    Kp, Dp = _split_system(Np - 5, Np, 3, dev)
    # the factor's lower triangle: the operand leaves the strictly-upper
    # entries outside the diagonal blocks unspecified (they may be NaN)
    L_hi = torch.tril(cholesky.cholesky_cuda(Kp.clone()))
    _, a_hi, h_hi = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
    for syrk in cholesky.SYRK_MODES:
        assert torch.equal(torch.tril(cholesky.cholesky_cuda(Kp.clone(), syrk)), L_hi), syrk
        L, a, h = cholesky.cholesky_solve_cuda(Kp.clone(), Dp, syrk)
        assert torch.equal(torch.tril(L), L_hi) and torch.equal(a, a_hi) and torch.equal(h, h_hi), syrk


# a unit-diagonal pad (N = 700 in Np = 768, the pad rows in the last panel,
# under two split trailing updates): the pad block of L stays the identity
# and L's pad rows 0 left of it, exactly, so the pad's logdet terms are log
# 1 and alpha's pad rows 0
@pytest.mark.parametrize("syrk", SPLIT_MODES)
def test_split_pad_invariants(dev, syrk):
    N, Np = 700, 768
    Kp, Dp = _split_system(N, Np, 2, dev)
    L = cholesky.cholesky_cuda(Kp.clone(), syrk)
    Lf, alpha, hld = cholesky.cholesky_solve_cuda(Kp.clone(), Dp, syrk)
    torch.cuda.synchronize()
    eye = torch.eye(Np - N, device=dev)
    for F in (L, Lf):
        assert torch.equal(torch.tril(F[N:, N:]), eye)
        assert bool((F[N:, :N] == 0).all())
    assert bool((alpha[N:] == 0).all())
    assert bool(torch.isfinite(hld))


# as test_chol_kernel_nan_on_non_positive_pivot, in each split mode
@pytest.mark.parametrize("syrk", SPLIT_MODES)
@pytest.mark.parametrize("bad", [None, 150, 300])
def test_split_kernel_nan_on_non_positive_pivot(dev, syrk, bad):
    if bad is None:
        Kp = gram.gram_chol_operand_cuda("rbf", _xs(100, 1, dev), 1.0, -5.0, 128)
    else:
        Kp = gram.gram_chol_operand_cuda("rbf", _xs(400, 1, dev), 1.0, 0.5, 448)
        Kp[bad, bad] = -10.0
    Np = Kp.shape[0]
    L = cholesky.cholesky_cuda(Kp.clone(), syrk)
    _, alpha, hld = cholesky.cholesky_solve_cuda(Kp, torch.ones(Np, 1, device=dev), syrk)
    torch.cuda.synchronize()
    assert torch.isnan(hld)
    first = 0 if bad is None else bad
    assert bool(torch.isnan(L[first, first]))
    assert bool(torch.isfinite(torch.tril(L[:first, :first])).all())


def _trailing_launches(fn):
    # launches of each trailing kernel in one call of fn, by arithmetic
    # ("hi": chol_trailing_kernel_hi; "3", "4": chol_trailing_kernel<passes>),
    # the most over three profiled calls (the profiler may lose events)
    best = {}
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            m = re.search(r"chol_trailing_kernel(?:<(\d+)>|_(hi))", e.name)
            if m and e.device_type == torch.autograd.DeviceType.CUDA:
                seen[m[1] or m[2]] = seen.get(m[1] or m[2], 0) + 1
        best = {k: max(best.get(k, 0), seen.get(k, 0)) for k in set(best) | set(seen)}
    return best


# the hand path of each mode launches the trailing kernel of its
# arithmetic, and no other, once for the next panel's columns and once for
# the columns beyond after each panel but the last: 2112 = 8 full panels
# and one of 64 columns, 17 tile columns, so 8 + 7 launches
@pytest.mark.parametrize("syrk", ["hi"] + list(SPLIT_MODES))
def test_split_trailing_kernel_launches_by_profiler(dev, syrk):
    Kp, Dp = _split_system(2100, 2112, 1, dev)
    want = {"hi" if syrk == "hi" else syrk[1]: 15}
    assert _trailing_launches(lambda: cholesky.cholesky_cuda(Kp.clone(), syrk)) == want
    assert _trailing_launches(lambda: cholesky.cholesky_solve_cuda(Kp.clone(), Dp, syrk)) == want
    before = _build.launches["gfs_cholesky", syrk]
    cholesky.cholesky(Kp[:2100, :2100], syrk=syrk)
    assert _build.launches["gfs_cholesky", syrk] == before + 1


def test_split_wrappers_raise_instead_of_falling_back(dev):
    Kp, Dp = _split_system(100, 128, 1, dev)
    with pytest.raises(ValueError, match="syrk"):
        cholesky.cholesky_cuda(Kp.clone(), "s5")
    with pytest.raises(ValueError, match="float32"):
        cholesky.cholesky_solve_cuda(Kp.double(), Dp.double(), "s4")
    work = torch.empty(128, dtype=torch.float64, device=dev)
    # no such pass count, an unknown bit, the exact-diagonal bit on "hi"
    for bad in (1, 5, 3 | 16, 4 | 32, 3 | 64, 8):
        with pytest.raises(RuntimeError, match="gfs_cholesky: CUDA error"):
            _build.launch("gfs_cholesky", Kp.data_ptr(), 128, work.data_ptr(), bad, on=Kp)


# -- the paper's NKN on the one-pass operand (csrc/nkn_operand.cu) -------------

NKN_KINDS = {1: (7, 7, 8, 8, 0, 0, 6, 6), 2: (1, 2, 3, 4, 5, 8, 6, 7)}  # D = 2: every kind of primitive


def _nkn_theta(D, kinds, seed, dev):
    # a point of the operand's parameter vector (ops.nkn's layout)
    rng = np.random.RandomState(seed)
    th = np.zeros(nkn.theta_size(D), np.float32)
    S = nkn.slot(D)
    for k, kind in enumerate(kinds):
        th[k * S] = rng.uniform(0.5, 3.0)
        th[k * S + 1:k * S + 1 + D] = rng.uniform(0.5, 5.0, D)
        if kind == nkn.PERIODIC:
            th[k * S + 1 + D:k * S + 1 + 2 * D] = rng.uniform(3.0, 30.0, D)
        if kind == nkn.RQ:
            th[k * S + 1 + D] = rng.uniform(0.3, 3.0)
    th[8 * S:] = rng.uniform(0.2, 1.0, th.size - 8 * S) / 4
    return torch.tensor(th, device=dev)


# N = 10000 (the cell's size), 1003 and 2100 (not multiples of the forward's
# 8-row bands, pads of whole pad bands, three 1024-column sweeps), 1, D = 2
@pytest.mark.parametrize("N,D,pad_to", [(10000, 1, 10048), (1003, 1, 1024), (2100, 2, 2112), (1, 1, 64),
                                        (130, 2, 192)])
def test_nkn_operand_kernel_matches_plain(dev, N, D, pad_to):
    X = _xs(N, D, dev, seed=N) * 0.2
    kinds = NKN_KINDS[D]
    th = _nkn_theta(D, kinds, N + D, dev)
    got = nkn.nkn_operand_cuda(X, th, torch.tensor(0.3, device=dev), kinds, pad_to)
    assert _build.launches["gfs_nkn_operand"] > 0
    want = nkn.nkn_gram_plain(X.double(), th.double(), kinds)
    want.diagonal().add_(0.3)
    # float32 rounding of ~150 operations an entry: 2e-6 of the largest entry
    scale = float(want.abs().max())
    low = torch.ones(N, N, dtype=torch.bool, device=dev).tril_()
    assert float((got[:N, :N].double() - want)[low].abs().max()) <= 2e-6 * scale
    del want, low
    # the pad: zeros below the diagonal, ones on it, exactly
    assert torch.equal(got[N:, :N], torch.zeros_like(got[N:, :N]))
    assert torch.equal(torch.tril(got[N:, N:]), torch.eye(pad_to - N, device=dev))


@pytest.mark.parametrize("D", [1, 2])
def test_nkn_vjp_kernel_matches_f64_autograd(dev, D):
    # N = 2048: the kernel's gradient of <G, K_NKN + noise I> by every
    # parameter and the noise against float64 autograd through the plain
    # composite, for a symmetric G read on and below the diagonal
    N = 2048
    X = _xs(N, D, dev, seed=7) * 0.2
    kinds = NKN_KINDS[D]
    th = _nkn_theta(D, kinds, 8 + D, dev)
    G = torch.randn(N, N, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    G = G + G.T
    gt, gn = nkn.nkn_vjp_cuda(G, X, th, kinds)
    assert gt.dtype == torch.float64
    th64 = th.double().requires_grad_()
    noise = torch.tensor(0.3, dtype=torch.float64, device=dev, requires_grad=True)
    K = nkn.nkn_gram_plain(X.double(), th64, kinds) + noise * torch.eye(N, dtype=torch.float64, device=dev)
    wt, wn = torch.autograd.grad(K, [th64, noise], G.double())
    # float32 entries, summed in float64 past a warp: 1e-5 of the largest
    # gradient (measured ~5e-7)
    scale = float(wt.abs().max())
    assert float((gt - wt).abs().max()) <= 1e-5 * scale
    assert abs(float(gn) - float(wn)) <= 1e-5 * abs(float(wn))


def _nkn_gpr(N, dev, dtype, published=True):
    rng = np.random.RandomState(4)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.5 * X + 0.1 * rng.randn(N, 1)).astype(np.float32)
    k, nk = gft.kernels, gft.kernels_nkn
    if published:
        prims = [k.Linear(1, variance=2.0), k.Linear(1, variance=4.0), k.Periodic(1, period=0.25, variance=3.0),
                 k.Periodic(1, period=0.1, variance=3.0, lengthscales=0.5), k.RBF(1, variance=3.0, lengthscales=0.05),
                 k.RBF(1, variance=3.0, lengthscales=0.3),
                 k.RationalQuadratic(1, variance=3.0, lengthscales=0.1, alpha=0.5),
                 k.RationalQuadratic(1, variance=3.0, lengthscales=0.5, alpha=2.0)]
        layers = [nk.NKNLinear(8, 8), nk.NKNProduct(8, 2), nk.NKNLinear(4, 4), nk.NKNProduct(4, 2), nk.NKNLinear(2, 1)]
    else:  # example 06's network: not covered
        prims = [k.RBF(1, lengthscales=0.5), k.Periodic(1, period=0.7), k.Linear(1), k.Matern32(1)]
        layers = [nk.NKNLinear(4, 4), nk.NKNProduct(4, 2), nk.NKNLinear(2, 1)]
    m = gft.models.GPR(X, Y, kern=nk.NKN(1, prims, layers), device=dev, dtype=dtype)
    with torch.no_grad():
        p = m.likelihood.variance
        p.unconstrained.copy_(p.transform.backward(torch.tensor(0.1, dtype=torch.float64)))
    return m


@pytest.mark.parametrize("published", [True, False])
def test_nkn_gpr_route_and_gradients_on_the_card(dev, published, monkeypatch):
    # N = 3000: the published network takes the NKN operand and its VJP (one
    # launch each) into the fused factor; example 06's network takes the
    # composite route (no NKN launch, the padded fused factor). Both: the
    # value within 1e-5 and every gradient within 1e-3 of float64's, and no
    # library factorization or solve
    m32 = _nkn_gpr(3000, dev, torch.float32, published)
    kernels = ("gfs_nkn_operand", "gfs_nkn_vjp", "gfs_chol_solve_logdet")
    before = [_build.launches[k] for k in kernels]
    with monkeypatch.context() as mp:
        _no_library_linalg(mp)
        loss = m32.objective()
        loss.backward()
    after = [_build.launches[k] for k in kernels]
    assert after == [before[0] + published, before[1] + published, before[2] + 1], (before, after)
    m64 = _nkn_gpr(3000, dev, torch.float64, published)
    m64.load_state_dict(m32.state_dict())
    loss64 = m64.objective()
    loss64.backward()
    assert abs(loss.item() - loss64.item()) <= 1e-5 * abs(loss64.item())
    g64 = dict(gft.params.parameters(m64))
    for n, p in gft.params.parameters(m32):
        want = g64[n].unconstrained.grad
        err = float((p.unconstrained.grad.double() - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()) + 1e-6, n


def test_nkn_gpr_at_n10000_keeps_no_gram_for_the_backward(dev):
    # the acceptance gate: one objective and backward of the published
    # network at N = 10000 peaks under 10 GB above the model (the composite
    # route keeps ~23 GB of N x N arrays)
    m = _nkn_gpr(10000, dev, torch.float32)
    m.objective().backward()  # builds and loads the kernels
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m.zero_grad(set_to_none=True)
    m.objective().backward()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 10e9


# -- SGPR at the widths of port_bench's sgpr-m512-matern32-d11 (M = 512, D = 11) --

def _sgpr_d11(N, dev, dtype, seed=0):
    """Titsias's SGPR on standardised 11-d inputs, Matern32 with one
    lengthscale per input (2 to 3: a Gram far from 0 and 1), Z 512 rows of
    X."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, 11).astype(np.float32)
    Y = (np.sin(X.sum(1, keepdims=True) / np.sqrt(11)) + 0.1 * rng.randn(N, 1)).astype(np.float32)
    Z = X[np.sort(rng.choice(N, 512, replace=False))]
    kern = gft.kernels.Matern32(11, lengthscales=2.0 + 0.1 * np.arange(11))
    return gft.models.SGPR(X, Y, kern=kern, Z=Z, device=dev, dtype=dtype)


def test_sgpr_m512_d11_kernel_route_matches_f64_plain(dev):
    # N = 20000: the value and every gradient of the kernel route within 2x
    # the stock f32 route's error against f64, plus 1e-5 (value, relative)
    # and 1e-3 (gradients, max-norm relative): the sparse gates of
    # test_sparse_kernel_route_matches_f64_plain. The kernel route launches
    # the cross Gram, the factor and both TRSM schedules
    def run(dtype, use_kernels):
        m = _sgpr_d11(20000, dev, dtype)
        with gft.config.temp_settings(use_kernels=use_kernels, jitter=1e-4):
            loss = m.objective()
            loss.backward()
        return loss.item(), {n: p.unconstrained.grad.double() for n, p in gft.params.parameters(m)}

    before = _build.launches.copy()
    k32 = run(torch.float32, True)
    assert all(_build.launches[k] > before[k] for k in ("gfs_gram", "gfs_cholesky"))
    assert all(_build.launches["gfs_trsm", s] > before["gfs_trsm", s] for s in ("thin", "wide"))
    p32 = run(torch.float32, False)
    v64, g64 = run(torch.float64, False)
    err = [abs(v - v64) / abs(v64) for v, _ in (k32, p32)]
    assert err[0] <= 2 * err[1] + 1e-5, err
    assert set(g64) == {"feature.Z", "kern.lengthscales", "kern.variance", "likelihood.variance"}
    for n, want in g64.items():
        scale = float(want.abs().max())
        e = [float((g[n] - want).abs().max()) / scale for _, g in (k32, p32)]
        assert e[0] <= 2 * e[1] + 1e-3, (n, e)


def test_wide_trsm_against_a_512_row_factor_at_ragged_p(dev):
    # the SGPR cell's L^-1 Kuf and its VJP's solve on L.T: a 512-row factor
    # of an 11-d Matern32 Kuu against P = 200003 columns (no multiple of 64
    # or 128: ragged strips and tiles), lower and through the transposed
    # view; 1e-3 relative (max-norm), the TRSM gate above
    zs = torch.randn(512, 11, generator=torch.Generator().manual_seed(1)).to(dev) / 2.0
    K = gram.gram_cuda("matern32", zs, zs, torch.tensor(1.0, device=dev))
    K.diagonal().add_(1e-4)
    L = cholesky.cholesky_cuda(K.contiguous()).tril_()
    B = torch.randn(512, 200003, generator=torch.Generator().manual_seed(2)).to(dev)
    Ld = L.double()
    for T, Td, lower in ((L, Ld, True), (L.T, Ld.T, False)):
        before = _build.launches["gfs_trsm", "wide"]
        got = trsm.trsm_cuda(T, B, lower)
        want = trsm.solve_triangular_plain(Td, B.double(), lower)
        assert _build.launches["gfs_trsm", "wide"] == before + 1
        assert float((got.double() - want).abs().max()) <= 1e-3 * float(want.abs().max())
        del got, want


def test_sgpr_step_makes_no_host_sync(dev):
    # one Adam step of the SGPR fit (objective, backward, update) at M =
    # 512, D = 11 with tracing on: no sync inside the program's spans, and
    # the bound lies in its span; and none anywhere in a step, autograd's
    # device thread included, where the spans' counter does not look
    from gpflow_slim_tpu_torch.training.optimize import make_step_fn
    from gpflow_slim_tpu_torch.utils import trace

    m = _sgpr_d11(20000, dev, torch.float32)
    step_fn, _ = make_step_fn(m, lambda ps: torch.optim.Adam(ps, lr=0.01))
    step_fn()  # builds and loads the kernels
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    syncs = trace.host_syncs
    with gft.utils.traced(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step_fn()
        torch.cuda.synchronize()
    assert trace.host_syncs == syncs
    names = {e.name for e in prof.events()}
    assert {"gfs.sgpr.likelihood", "gfs.gram.bwd", "gfs.trsm.bwd", "gfs.cholesky.bwd", "gfs.step.update"} <= names
