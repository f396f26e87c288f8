"""Card-only tests of the port's CUDA kernels against their plain versions.

Each kernel is built from csrc/ and compared, at small and ragged shapes,
with its plain PyTorch version run in float64 on the card. They skip where
there is no CUDA device. On a machine with a card and without JAX (whose
import tests/conftest.py needs)::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu_torch.ops import cholesky, gram, trsm
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
    before = (gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches)
    loss32 = m32.objective()
    loss32.backward()
    after = (gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches)
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
    before = cholesky.cholesky_cuda.launches
    L = cholesky.cholesky(K)
    assert cholesky.cholesky_cuda.launches == before + 1
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
        before = dict(trsm.trsm_cuda.by_schedule)
        got = trsm.trsm_cuda(T, B, lower)
        want = torch.linalg.solve_triangular(Td, B.double(), upper=not lower)
        # f32 substitution against f64: 1e-3 relative (max-norm), the fused
        # kernel's alpha gate
        assert float((got.double() - want).abs().max()) <= 1e-3 * float(want.abs().max())
        schedule = "thin" if P <= 64 else "wide"
        assert trsm.trsm_cuda.by_schedule[schedule] == before[schedule] + 1
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
    kernels = (gram.gram_cuda, gram.gram_lower_cuda, cholesky.cholesky_cuda, trsm.trsm_cuda)
    before = [k.launches for k in kernels]
    with torch.no_grad():
        mean, var = m32.posterior().predict_f(Xq)
        after = [k.launches for k in kernels]
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
        before = trsm.batched_trsm_cuda.launches
        got = trsm.batched_trsm_cuda(T, B, lower)
        assert trsm.batched_trsm_cuda.launches == before + 1  # one launch, whatever the items
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
        before = trsm.batched_trsm_cuda.launches
        X = (trsm.batched_solve_lower if dtype == torch.float32 else
             lambda a, c: trsm.solve_triangular_plain(a, c, True))(t.expand(P, -1, -1), b)
        torch.sum(X * G.to(dtype)).backward()
        if dtype == torch.float32:  # forward and backward both launched the kernel
            assert trsm.batched_trsm_cuda.launches == before + 2
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

    kernels = (gram.gram_cuda, cholesky.cholesky_cuda, trsm.trsm_cuda, trsm.batched_trsm_cuda)
    before = [k.launches for k in kernels]
    k32 = elbo_and_grads(torch.float32, True)
    after = [k.launches for k in kernels]
    assert all(a > b for a, b in zip(after[:3], before[:3])), (before, after)
    assert (after[3] > before[3]) == (not whiten)  # only the unwhitened KL solves in a batch
    p32 = elbo_and_grads(torch.float32, False)
    assert [k.launches for k in kernels] == after  # use_kernels=False launches nothing
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
    before = (gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches, gram.gram_cuda.launches)
    with monkeypatch.context() as mp, torch.no_grad():
        _no_library_linalg(mp)
        value = m32.objective().item()
    after = (gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches, gram.gram_cuda.launches)
    assert after == (before[0], before[1] + 1, before[2] + 1), (before, after)
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

    kernels = (gram.gram_cuda, cholesky.cholesky_cuda)
    before = [k.launches for k in kernels] + [dict(trsm.trsm_cuda.by_schedule)]
    k32 = run(torch.float32, True, forbid=True)
    assert all(k.launches > b for k, b in zip(kernels, before)), before
    assert all(trsm.trsm_cuda.by_schedule[s] > before[2][s] for s in ("thin", "wide"))
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
    before = cholesky.cholesky_cuda.launches
    L, jit = ops_linalg.robust_cholesky(K)
    assert cholesky.cholesky_cuda.launches > before
    assert bool(torch.isfinite(L).all())
    scale = float(torch.mean(torch.diagonal(K)))
    assert float((L @ L.T - K).abs().max()) <= 10 * float(jit) + 1e-3 * scale
