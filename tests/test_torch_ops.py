"""Parity of the port's kernel modules (gpflow_slim_tpu_torch.ops) with the
JAX package, on the CPU in float64.

The JAX side runs the Pallas kernels in interpret mode, as tests/test_pallas.py
does; the port's side runs the plain versions that stand beside its CUDA
kernels (a wrapper takes them for CPU tensors). Inputs come from numpy with
a fixed seed.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import solve_triangular

import gpflow_slim_tpu as gfs
from gpflow_slim_tpu.ops import linalg as jax_linalg
from gpflow_slim_tpu.ops import pallas_cholesky, pallas_gram, pallas_trsm
from gpflow_slim_tpu_torch import config, likelihoods, quadrature, transforms
from gpflow_slim_tpu_torch.ops import _build, cholesky, gram, linalg, trsm

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
KINDS = list(gram.KINDS)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=requires_grad)


def _inputs(N, D, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 1, (N, D)) / 0.3, rng


def _spd_operand(N, pad_to, P, seed=0):
    """A padded operand from the port's plain operand, and a zero-padded RHS."""
    Xs, rng = _inputs(N, 1, seed)
    Kp = gram.gram_chol_operand_plain("rbf", _t(Xs), 1.1, 0.3, pad_to)
    Dp = np.zeros((pad_to, P))
    Dp[:N] = rng.randn(N, P)
    return Kp.numpy(), Dp


@pytest.mark.parametrize("kind,D", [(k, 1) for k in KINDS] + [("rbf", 3), ("matern52", 3)])
def test_operand_plain_matches_pallas_interpret(kind, D):
    N, pad_to = 200, 256
    Xs, _ = _inputs(N, D)
    var, noise = 1.3, 0.2
    ref = np.asarray(pallas_gram._gram_chol_operand_pallas(
        kind, jnp.asarray(Xs), jnp.asarray(var), jnp.asarray(noise), pad_to,
        tile=128, interpret=True))
    got = gram.gram_chol_operand_plain(kind, _t(Xs), var, noise, pad_to).numpy()
    lower = np.tril_indices(pad_to)
    # the same f64 formula on both sides: only rounding differs
    np.testing.assert_allclose(got[lower], ref[lower], rtol=0, atol=1e-10)


def test_gram_reference_matches_jax():
    Xs, rng = _inputs(40, 2)
    X2s = rng.uniform(0, 1, (30, 2)) / 0.3
    for kind in KINDS:
        ref = np.asarray(pallas_gram._gram_reference(kind, jnp.asarray(Xs), jnp.asarray(X2s), 0.7))
        got = gram.gram_reference(kind, _t(Xs), _t(X2s), 0.7).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("P", [1, 3])
def test_cholesky_solve_plain_matches_pallas_interpret(P):
    N, pad_to = 200, 256
    Kp, Dp = _spd_operand(N, pad_to, P)
    Lref, aref, href = pallas_cholesky._cholesky_solve_pallas(
        jnp.asarray(Kp), jnp.asarray(Dp), block_size=64, interpret=True)
    Lp, alpha, hld = cholesky.cholesky_solve_plain(_t(Kp), _t(Dp))
    # the interpret-mode kernel accumulates its panel product in f32 even
    # for f64 inputs (preferred_element_type, pallas_cholesky.py:448-452):
    # it is off the exact answer by ~2e-7 in L, ~4e-6 in alpha, ~1e-9 in
    # half_logdet here, so the comparison with it is at that level ...
    assert abs(float(hld) - float(href)) <= 1e-8 * abs(float(href))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(aref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.tril(Lp.numpy()), np.tril(np.asarray(Lref)), rtol=0, atol=1e-6)
    # ... and the comparison with an f64 oracle is tight
    L = np.linalg.cholesky(Kp)
    a = solve_triangular(L, Dp, lower=True)
    assert abs(float(hld) - np.log(np.diag(L)).sum()) <= 1e-12 * abs(float(hld))
    np.testing.assert_allclose(alpha.numpy(), a, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.tril(Lp.numpy()), L, rtol=0, atol=1e-10)
    # pad rows: alpha exactly 0, unit diagonal factor (log 1 = 0)
    assert (alpha[N:] == 0).all()
    assert (torch.diagonal(Lp)[N:] == 1).all()


def test_cholesky_solve_plain_in_place_and_nan_on_failure():
    Kp, Dp = _spd_operand(100, 128, 1)
    K = _t(Kp)
    Lp, _, _ = cholesky.cholesky_solve_plain(K, _t(Dp))
    assert Lp is K  # factored in place, as the kernel does
    bad = _t(Kp)
    bad[5, 5] = -1.0
    _, alpha, hld = cholesky.cholesky_solve_plain(bad, _t(Dp))
    assert torch.isnan(hld) and torch.isnan(alpha).all()


def test_cholesky_solve_logdet_backward_matches_jax():
    N, pad_to, P = 100, 128, 2
    Kp, Dp = _spd_operand(N, pad_to, P)
    g1, g2 = 0.7, -1.3

    K0 = _t(Kp, requires_grad=True)
    D0 = _t(Dp, requires_grad=True)
    hl, q = cholesky.cholesky_solve_logdet(K0.clone(), D0)
    (g1 * hl + g2 * q).backward()

    # _csl_bwd on the same f64 residuals (Lp, alpha) the port saved: the
    # same backward formula in f64 on both sides
    Lp, alpha, _ = cholesky.cholesky_solve_plain(_t(Kp), _t(Dp))
    Kbar, Dbar = pallas_cholesky._csl_bwd(
        64, "hi", (jnp.asarray(Lp.numpy()), jnp.asarray(alpha.numpy())), (g1, g2))
    np.testing.assert_allclose(K0.grad.numpy(), np.asarray(Kbar), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(D0.grad.numpy(), np.asarray(Dbar), rtol=1e-9, atol=1e-12)

    def obj_ref(K, D):
        L = jnp.linalg.cholesky(K)
        a = jax.scipy.linalg.solve_triangular(L, D, lower=True)
        return g1 * jnp.sum(jnp.log(jnp.diagonal(L))) + g2 * jnp.sum(jnp.square(a))

    gK, gD = jax.grad(obj_ref, argnums=(0, 1))(jnp.asarray(Kp), jnp.asarray(Dp))
    sym = lambda g: 0.5 * (np.asarray(g) + np.asarray(g).T)  # noqa: E731
    np.testing.assert_allclose(sym(K0.grad.numpy()), sym(gK), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(D0.grad.numpy(), np.asarray(gD), rtol=1e-8, atol=1e-10)


def test_cholesky_solve_logdet_backward_runs_in_f64_for_f32():
    # f32 inputs get an f64 backward (an f32 inverse loses the variance
    # gradient at N = 10000), returned in f32
    Kp, Dp = _spd_operand(100, 128, 1)
    K32 = torch.tensor(Kp, dtype=torch.float32, requires_grad=True)
    D32 = torch.tensor(Dp, dtype=torch.float32, requires_grad=True)
    hl, q = cholesky.cholesky_solve_logdet(K32.clone(), D32)
    (hl + 0.5 * q).backward()
    assert K32.grad.dtype == torch.float32 and D32.grad.dtype == torch.float32
    Lp, alpha, _ = cholesky.cholesky_solve_plain(K32.detach().clone(), D32.detach())
    Kbar, Dbar = pallas_cholesky._csl_bwd(
        64, "hi", (jnp.asarray(Lp.double().numpy()), jnp.asarray(alpha.double().numpy())), (1.0, 0.5))
    # the f64 backward of the f32 factor, then one rounding to f32
    np.testing.assert_allclose(K32.grad.numpy(), np.asarray(Kbar), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(D32.grad.numpy(), np.asarray(Dbar), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_gram_chol_operand_backward_matches_jax(kind):
    N, pad_to = 60, 64
    Xs, rng = _inputs(N, 2)
    G = rng.randn(pad_to, pad_to)
    var, noise = 1.3, 0.2

    xs, v, n = _t(Xs, True), _t(var, True), _t(noise, True)
    out = gram.gram_chol_operand(kind, xs, v, n, pad_to)
    torch.sum(out * _t(G)).backward()

    ref = pallas_gram._opnd_bwd(
        kind, pad_to, (jnp.asarray(Xs), jnp.asarray(var), jnp.asarray(noise)), jnp.asarray(G))
    for got, want in zip((xs.grad, v.grad, n.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)

    def f(a, vv, nn):
        K = pallas_gram._gram_reference(kind, a, a, vv) + nn * jnp.eye(N)
        return jnp.sum(jnp.asarray(G)[:N, :N] * K)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(Xs), jnp.asarray(var), jnp.asarray(noise))
    for got, w in zip((xs.grad, v.grad, n.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)


def _grid_inputs(N, D, seed):
    # multiples of 1/8 in [-5, 5): the interpret-mode Gram kernel forms its
    # cross product in f32 even for f64 inputs (preferred_element_type,
    # pallas_gram.py:64-68), and on this grid that product is exact, so the
    # two sides differ by f64 rounding only; coincident points (d = 0, where
    # sqrt(d^2 + 1e-12) is steepest) occur too
    return np.random.RandomState(seed).randint(-40, 40, (N, D)) / 8.0


@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_gram_plain_matches_pallas_interpret(kind, D):
    Xs, X2s = _grid_inputs(200, D, 0), _grid_inputs(130, D, 1)  # ragged against the 128 tile
    ref = np.asarray(pallas_gram.gram_interpret_mode(kind, jnp.asarray(Xs), jnp.asarray(X2s), 1.3))
    got = gram.gram_reference(kind, _t(Xs), _t(X2s), 1.3).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    # the autograd entry point takes the plain version for CPU tensors
    np.testing.assert_array_equal(gram.stationary_gram(kind, _t(Xs), _t(X2s), 1.3).numpy(), got)


@pytest.mark.parametrize("kind", ["rbf", "matern12", "cosine"])
def test_gram_lower_plain_matches_pallas_interpret(kind):
    N = 200
    Xs = _grid_inputs(N, 2, 2)
    ref = np.asarray(pallas_gram._gram_lower_pallas(
        kind, jnp.asarray(Xs), jnp.asarray(1.3), tile=64, interpret=True))
    got = gram.gram_lower_plain(kind, _t(Xs), 1.3).numpy()
    lower = np.tril_indices(N)
    np.testing.assert_allclose(got[lower], ref[lower], rtol=0, atol=1e-12)
    # strictly-upper TILE x TILE tiles are written as zero: they include the
    # JAX kernel's zero tiles (a multiple of TILE), and the rest of the
    # upper triangle inside the diagonal tiles equals the full Gram
    t = np.arange(N) // gram.TILE
    upper_tiles = t[:, None] < t[None, :]
    assert np.all(got[upper_tiles] == 0.0) and np.all(got[ref == 0.0] == 0.0)
    full = gram.gram_reference(kind, _t(Xs), _t(Xs), 1.3).numpy()
    np.testing.assert_array_equal(got[~upper_tiles], full[~upper_tiles])
    np.testing.assert_array_equal(gram.stationary_gram_lower(kind, _t(Xs), 1.3).numpy(), got)


def _spd(N, seed=0):
    A = np.random.RandomState(seed).randn(N, N)
    return A @ A.T + N * np.eye(N)


@pytest.mark.parametrize("N", [1, 63, 64, 65, 130, 200])
def test_cholesky_padded_wrapper_matches_pallas_interpret(N):
    K = _spd(N)
    L = cholesky.cholesky(_t(K))
    want = np.linalg.cholesky(K)
    np.testing.assert_allclose(L.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert np.all(np.triu(L.numpy(), 1) == 0.0)
    if N in (64, 130, 200):
        # the interpret-mode kernel accumulates its panel products in f32
        # even for f64 inputs: ~1e-7 relative in L here
        ref = np.asarray(pallas_cholesky.cholesky_interpret(jnp.asarray(K), block_size=64))
        np.testing.assert_allclose(L.numpy(), ref, rtol=0, atol=1e-6 * np.abs(want).max())
    # only the lower triangle is read, as the lower-tile Gram requires
    junk = np.tril(K) + np.triu(np.full((N, N), 7.0), 1)
    np.testing.assert_array_equal(cholesky.cholesky(_t(junk)).numpy(), L.numpy())


def test_cholesky_nan_on_failure_and_routing():
    K = _spd(70)
    K[3, 3] = -1.0
    lower = np.tril_indices(70)
    assert torch.isnan(cholesky.cholesky(_t(K))[lower]).all()
    assert torch.isnan(linalg.cholesky(_t(K))[lower]).all()
    # CPU tensors take the plain route
    np.testing.assert_allclose(linalg.cholesky(_t(_spd(70))).numpy(), np.linalg.cholesky(_spd(70)),
                               rtol=0, atol=1e-12)


def _tri(N, seed=0):
    A = np.random.RandomState(seed).randn(N, N)
    return np.tril(A) + N * np.eye(N)


@pytest.mark.parametrize("N,P", [(128, 64), (200, 7), (64, 130), (1, 3), (63, 1), (65, 2)])
def test_solves_match_pallas_interpret(N, P):
    L = _tri(N)
    B = np.random.RandomState(1).randn(N, P)
    lo = trsm.solve_lower(_t(L), _t(B)).numpy()
    up = trsm.solve_upper(_t(L).T, _t(B)).numpy()  # the transposed view, as GPR.posterior
    np.testing.assert_allclose(lo, solve_triangular(L, B, lower=True), rtol=0, atol=1e-12)
    np.testing.assert_allclose(up, solve_triangular(L.T, B, lower=False), rtol=0, atol=1e-12)
    if N >= 64:
        # the interpret-mode kernel applies its inverted diagonal blocks with
        # f32-accumulated products (pallas_trsm.py:49-53): ~2e-9 here
        ref_lo = np.asarray(pallas_trsm.solve_lower_interpret(jnp.asarray(L), jnp.asarray(B)))
        ref_up = np.asarray(pallas_trsm.solve_upper_interpret(jnp.asarray(L.T), jnp.asarray(B)))
        np.testing.assert_allclose(lo, ref_lo, rtol=0, atol=1e-8)
        np.testing.assert_allclose(up, ref_up, rtol=0, atol=1e-8)


def test_solves_vector_rhs_and_cho_solve():
    N = 64
    L = _tri(N, 2)
    b = np.random.RandomState(3).randn(N)
    x = trsm.solve_lower(_t(L), _t(b))
    assert x.shape == (N,)
    ref = np.asarray(pallas_trsm.solve_lower_interpret(jnp.asarray(L), jnp.asarray(b)))
    assert ref.shape == (N,)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), solve_triangular(L, b, lower=True), rtol=0, atol=1e-12)
    u = trsm.solve_upper(_t(L).T, _t(b))
    np.testing.assert_allclose(u.numpy(), solve_triangular(L.T, b, lower=False), rtol=0, atol=1e-12)
    K = L @ L.T
    np.testing.assert_allclose(linalg.cho_solve_lower(_t(L), _t(b)).numpy(), np.linalg.solve(K, b),
                               rtol=1e-10)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_gram_backwards_match_jax(kind):
    Xs, rng = _inputs(30, 2)
    X2s = rng.uniform(0, 1, (20, 2)) / 0.3
    var = 1.3
    G = rng.randn(30, 20)
    xs, x2s, v = _t(Xs, True), _t(X2s, True), _t(var, True)
    torch.sum(gram.stationary_gram(kind, xs, x2s, v) * _t(G)).backward()
    ref = pallas_gram._bwd(kind, (jnp.asarray(Xs), jnp.asarray(X2s), jnp.asarray(var)),
                           jnp.asarray(G))
    for got, want in zip((xs.grad, x2s.grad, v.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)

    # the lower-tile Gram, with a cotangent on the lower triangle (what a
    # Cholesky consumer gives it)
    Gl = np.tril(rng.randn(30, 30))
    xs, v = _t(Xs, True), _t(var, True)
    torch.sum(gram.stationary_gram_lower(kind, xs, v) * _t(Gl)).backward()
    ref = pallas_gram._lower_bwd(kind, (jnp.asarray(Xs), jnp.asarray(var)), jnp.asarray(Gl))
    for got, want in zip((xs.grad, v.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("N", [48, 70])
def test_cholesky_backward_matches_jax(N):
    K = _spd(N, 4)
    G = np.random.RandomState(5).randn(N, N)
    k = _t(K, True)
    L = cholesky.cholesky(k)
    torch.sum(L * _t(G)).backward()
    (Kbar,) = pallas_cholesky._chol_vjp_bwd(jnp.asarray(L.detach().numpy()), jnp.asarray(G))
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(Kbar), rtol=1e-10, atol=1e-14)
    # K-bar is the full symmetric matrix: its symmetric part equals the
    # symmetrized gradient of XLA's Cholesky
    gK = jax.grad(lambda a: jnp.sum(jnp.linalg.cholesky(a) * jnp.asarray(G)))(jnp.asarray(K))
    np.testing.assert_allclose(k.grad.numpy(), k.grad.numpy().T, rtol=0, atol=1e-15)
    np.testing.assert_allclose(k.grad.numpy(), 0.5 * (np.asarray(gK) + np.asarray(gK).T),
                               rtol=1e-8, atol=1e-12)


def test_cholesky_backward_runs_in_f64_for_f32():
    # an f32 factor gets an f64 VJP (its solves on the f32 TRSM, refined on
    # f64 residuals), returned in f32: JAX's f64 VJP of the same f32 factor,
    # then one rounding, on a Kuu-like matrix of condition ~1e6
    Z = np.linspace(0, 1, 90)[:, None]
    K = np.exp(-0.5 * (Z - Z.T) ** 2 / 0.2 ** 2) + 1e-4 * np.eye(90)
    G = np.random.RandomState(5).randn(90, 90)
    k = torch.tensor(K, dtype=torch.float32, requires_grad=True)
    L = cholesky.cholesky(k)
    torch.sum(L * torch.tensor(G, dtype=torch.float32)).backward()
    assert k.grad.dtype == torch.float32
    L64 = jnp.asarray(L.detach().double().numpy())
    (Kbar,) = pallas_cholesky._chol_vjp_bwd(L64, jnp.asarray(G.astype(np.float32).astype(np.float64)))
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(Kbar), rtol=1e-6, atol=1e-6 * np.abs(Kbar).max())


@pytest.mark.parametrize("lower", [True, False])
def test_trsm_backward_matches_jax(lower, monkeypatch):
    N, P = 70, 5
    L = _tri(N, 6)
    T = L if lower else L.T
    B = np.random.RandomState(7).randn(N, P)
    G = np.random.RandomState(8).randn(N, P)
    t, b = _t(T, True), _t(B, True)
    X = (trsm.solve_lower if lower else trsm.solve_upper)(t, b)
    torch.sum(X * _t(G)).backward()
    # `_trsm_bwd` solves with the Pallas kernel; on the CPU it runs in
    # interpret mode (f32-accumulated products: ~1e-9 here)
    interp = pallas_trsm._trsm_pallas
    monkeypatch.setattr(pallas_trsm, "_trsm_pallas",
                        lambda *a, **k: interp(*a, block_size=64, interpret=True, **k))
    dT, gB = pallas_trsm._trsm_bwd(lower, (jnp.asarray(T), jnp.asarray(X.detach().numpy())),
                                   jnp.asarray(G))
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gB), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(dT), rtol=0, atol=1e-8)
    # and tight against the autograd of XLA's triangular solve
    gT, gB = jax.grad(
        lambda a, c: jnp.sum(jax.scipy.linalg.solve_triangular(a, c, lower=lower) * jnp.asarray(G)),
        argnums=(0, 1))(jnp.asarray(T), jnp.asarray(B))
    tri = np.tril if lower else np.triu
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gB), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.grad.numpy(), tri(np.asarray(gT)), rtol=0, atol=1e-12)


def _tri_batch(P, M, seed=0):
    # tests/test_pallas.py's well-conditioned triangles
    rng = np.random.RandomState(seed)
    return np.stack([np.tril(rng.randn(M, M)) + M * np.eye(M) for _ in range(P)])


@pytest.mark.parametrize("entry", ["plain", "function", "routed"])
def test_batched_trsm_matches_pallas_interpret(entry, monkeypatch):
    # tests/test_pallas.py::test_batched_trsm_matches_vmapped_xla's shapes;
    # the interpret-mode kernel is f32 inside (atol 2e-5 there too)
    P, M, K = 3, 96, 40
    L = _tri_batch(P, M)
    B = np.random.RandomState(1).randn(P, M, K)
    solve = {"plain": lambda T, b, lower: trsm.solve_triangular_plain(T, b, lower),
             "function": lambda T, b, lower: (trsm.batched_solve_lower if lower
                                              else trsm.batched_solve_upper)(T, b),
             "routed": lambda T, b, lower: (linalg.batched_solve_lower if lower
                                            else linalg.batched_solve_upper)(T, b)}[entry]
    if entry == "routed":
        monkeypatch.setattr(linalg, "kernels_active", lambda t: True)
    lo = solve(_t(L), _t(B), True).numpy()
    up = solve(_t(L).mT, _t(B), False).numpy()  # the transposed view, read in place
    ref_lo = np.asarray(pallas_trsm.batched_solve_lower_interpret(jnp.asarray(L, jnp.float32),
                                                                  jnp.asarray(B, jnp.float32)))
    ref_up = np.asarray(pallas_trsm.batched_solve_upper_interpret(
        jnp.asarray(np.swapaxes(L, 1, 2), jnp.float32), jnp.asarray(B, jnp.float32)))
    np.testing.assert_allclose(lo, ref_lo, rtol=0, atol=2e-5)
    np.testing.assert_allclose(up, ref_up, rtol=0, atol=2e-5)
    want = np.stack([solve_triangular(l, b, lower=True) for l, b in zip(L, B)])
    np.testing.assert_allclose(lo, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(linalg.batched_cho_solve_lower(_t(L), _t(B)).numpy(),
                               np.linalg.solve(L @ np.swapaxes(L, 1, 2), B), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("M", [1, 63, 65])
@pytest.mark.parametrize("broadcast", [False, True])
def test_batched_trsm_backward_matches_jax(M, broadcast, monkeypatch):
    # the autograd Function against JAX's VJP of ops.linalg.batched_solve_lower
    # (XLA's solve on the CPU) and against `_batched_trsm_bwd` run through the
    # interpret-mode kernel; ``broadcast``: one triangle expanded over the
    # batch (stride 0), the KL's Lp, whose gradient sums over it
    P, K = 3, 5
    L = _tri_batch(1 if broadcast else P, M, 6)
    B = np.random.RandomState(7).randn(P, M, K)
    G = np.random.RandomState(8).randn(P, M, K)
    t, b = _t(L, True), _t(B, True)
    T = t.expand(P, -1, -1) if broadcast else t
    if broadcast:
        assert T.stride(0) == 0 and trsm._layout(T) == (0, M, 0)
    X = trsm.batched_solve_lower(T, b)
    torch.sum(X * _t(G)).backward()

    def f(l, c):
        lb = jnp.broadcast_to(l, (P, M, M))
        return jnp.sum(jax_linalg.batched_solve_lower(lb, c) * jnp.asarray(G))

    gL, gB = jax.grad(f, argnums=(0, 1))(jnp.asarray(L), jnp.asarray(B))
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gB), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.grad.numpy(), np.tril(np.asarray(gL)), rtol=0, atol=1e-12)
    if M > 1:  # the interpret-mode kernel computes in f32: ~1e-7 here
        Lb = np.broadcast_to(L, (P, M, M))
        interp = pallas_trsm._batched_trsm_pallas
        monkeypatch.setattr(pallas_trsm, "_batched_trsm_pallas",
                            lambda *a, **k: interp(*a, interpret=True, **k))
        dL, dB = pallas_trsm._batched_trsm_bwd(
            True, (jnp.asarray(Lb), jnp.asarray(X.detach().numpy())), jnp.asarray(G))
        dL = np.asarray(dL).sum(0, keepdims=True) if broadcast else np.asarray(dL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(dB), rtol=0, atol=1e-5)
        np.testing.assert_allclose(t.grad.numpy(), dL, rtol=0, atol=1e-5)


def test_batched_trsm_layouts():
    L = torch.zeros(4, 10, 12, dtype=torch.float64)[:, :, :10]
    assert trsm._layout(L) == (120, 12, 0)
    assert trsm._layout(L.mT) == (120, 12, 1)
    assert trsm._layout(torch.zeros(10, 10).expand(3, -1, -1).mT) == (0, 10, 1)
    assert trsm._layout(torch.zeros(3, 20, 20)[:, ::2, ::2]) is None
    # one triangle: the 2-D kernel's reads, with no batch stride
    assert trsm._layout(torch.zeros(10, 12)[:, :10]) == (0, 12, 0)
    assert trsm._layout(torch.zeros(10, 12)[:, :10].T) == (0, 12, 1)
    assert trsm._layout(torch.zeros(20, 20)[::2, ::2]) is None


@pytest.mark.parametrize("P,squeeze", [(1, False), (3, False), (1, True)])
def test_lower_triangular_matches_jax(P, squeeze):
    M = 6
    jt = gfs.transforms.LowerTriangular(M, num_matrices=P, squeeze=squeeze)
    tt = transforms.LowerTriangular(M, num_matrices=P, squeeze=squeeze)
    x = np.random.RandomState(9).randn(P * M * (M + 1) // 2)
    want = np.asarray(jt.forward(x))
    got = tt.forward(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)  # the packing order of np.tril_indices
    np.testing.assert_array_equal(tt.backward(got).numpy(), x)
    np.testing.assert_array_equal(tt.backward(got).numpy(), np.asarray(jt.backward(want)))
    assert float(tt.log_jacobian(_t(x))) == 0.0
    # autograd sees the embedding: the gradient of a lower-triangle sum is 1
    xt = _t(x, True)
    tt.forward(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_ndiagquad_matches_jax():
    rng = np.random.RandomState(10)
    Fmu, Fvar, Y = rng.randn(7, 2), rng.uniform(0.1, 1.0, (7, 2)), rng.randn(7, 2)
    jq, tq = gfs.quadrature, quadrature
    for H in (5, 20):
        for logspace in (False, True):
            want = jq.ndiagquad(lambda f, Y: -0.5 * (f - Y) ** 2, H, Fmu, Fvar, logspace=logspace, Y=Y)
            got = tq.ndiagquad(lambda f, Y: -0.5 * (f - Y) ** 2, H, _t(Fmu), _t(Fvar),
                               logspace=logspace, Y=_t(Y))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-14)
        # a list of functions of two latents
        funcs = [lambda a, b: a * b, lambda a, b: np.exp(0) * (a + b) ** 2]
        want = jq.ndiagquad(funcs, H, (Fmu[:, 0], Fmu[:, 1]), (Fvar[:, 0], Fvar[:, 1]))
        got = tq.ndiagquad(funcs, H, (_t(Fmu[:, 0]), _t(Fmu[:, 1])), (_t(Fvar[:, 0]), _t(Fvar[:, 1])))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13, atol=1e-14)
    x, w = tq.mvhermgauss(4, 2)
    jx, jw = jq.mvhermgauss(4, 2)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(w, jw)


def test_bernoulli_matches_jax():
    rng = np.random.RandomState(11)
    F, Fv = 2.0 * rng.randn(9, 1), rng.uniform(0.05, 2.0, (9, 1))
    Y = (rng.rand(9, 1) > 0.5).astype(float)
    jl, tl = gfs.likelihoods.Bernoulli(), likelihoods.Bernoulli()
    pairs = [
        (tl.logp(_t(F), _t(Y)), jl.logp(F, Y)),
        (tl.conditional_mean(_t(F)), jl.conditional_mean(F)),
        (tl.conditional_variance(_t(F)), jl.conditional_variance(F)),
        (tl.variational_expectations(_t(F), _t(Fv), _t(Y)), jl.variational_expectations(F, Fv, Y)),
        (tl.predict_density(_t(F), _t(Fv), _t(Y)), jl.predict_density(F, Fv, Y)),
        *zip(tl.predict_mean_and_var(_t(F), _t(Fv)), jl.predict_mean_and_var(F, Fv)),
        # the quadrature defaults of the base class, through another link
        *zip(likelihoods.Likelihood.predict_mean_and_var(tl, _t(F), _t(Fv)),
             gfs.likelihoods.Likelihood.predict_mean_and_var(jl, F, Fv)),
        (likelihoods.Likelihood.predict_density(tl, _t(F), _t(Fv), _t(Y)),
         gfs.likelihoods.Likelihood.predict_density(jl, F, Fv, Y)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(likelihoods.probit(_t(F)).numpy(), np.asarray(gfs.likelihoods.probit(F)),
                               rtol=1e-14)


def test_wrappers_take_plain_versions_on_cpu():
    # a CPU tensor runs the plain version and launches nothing
    Xs, _ = _inputs(30, 1)
    before = (gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches)
    with config.temp_settings(use_kernels=True):
        Kp = gram.gram_chol_operand("rbf", _t(Xs), 1.0, 0.1, 64)
        hl, q = cholesky.cholesky_solve_logdet(Kp.detach().clone(), torch.zeros(64, 1, dtype=torch.float64))
    assert Kp.shape == (64, 64) and torch.isfinite(hl) and q == 0
    assert before == (gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(10, 1)
    with pytest.raises(ValueError, match="CUDA float32"):
        gram.gram_chol_operand_cuda("rbf", x, 1.0, 0.1, 64)
    with pytest.raises(ValueError, match="CUDA float32"):
        cholesky.cholesky_solve_cuda(torch.zeros(64, 64), torch.zeros(64, 1))
    with pytest.raises(ValueError, match="unknown kind"):
        gram.gram_chol_operand_cuda("periodic", x, 1.0, 0.1, 64)


def test_serving_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(10, 1)
    with pytest.raises(ValueError, match="CUDA float32"):
        gram.gram_cuda("rbf", x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA float32"):
        gram.gram_lower_cuda("rbf", x, 1.0)
    with pytest.raises(ValueError, match="unknown kind"):
        gram.gram_lower_cuda("periodic", x, 1.0)
    with pytest.raises(ValueError, match="CUDA float32"):
        cholesky.cholesky_cuda(torch.eye(64))
    with pytest.raises(ValueError, match="CUDA float32"):
        trsm.trsm_cuda(torch.eye(64), torch.ones(64, 1), True)
    with pytest.raises(ValueError, match="CUDA float32"):
        trsm.batched_trsm_cuda(torch.eye(64)[None], torch.ones(1, 64, 1), True)


@pytest.mark.parametrize("P,schedule", [(1, "thin"), (7, "thin"), (64, "thin"), (65, "wide"),
                                        (2048, "wide")])
def test_trsm_schedule_rule(P, schedule):
    # the static rule on P that picks csrc/trsm.cu's schedule, and the
    # scratch each needs: the thin one's ticket and one ready flag per
    # 64-row block row (int32 words, zeroed by the wrapper); none for wide
    assert trsm.trsm_schedule(P) == schedule
    for N, nb in ((1, 1), (64, 1), (65, 2), (10000, 157)):
        assert trsm.trsm_scratch(N, P) == (nb + 1 if schedule == "thin" else 0)


@pytest.mark.parametrize("P,M,K", [(1, 1, 1), (1, 64, 32), (1, 65, 33), (3, 200, 40), (1, 256, 256),
                                   (16, 256, 256), (1, 1024, 1024), (16, 1024, 1024)])
def test_batched_trsm_items_and_scratch(P, M, K):
    # one work item per (batch entry, 32-column strip, 64-row block row),
    # counted directly; the scratch is the ticket and one flag per item
    items = sum(1 for _ in range(P) for _ in range(0, K, trsm.STRIP) for _ in range(0, M, trsm.BLOCK))
    assert trsm.batched_trsm_items(P, M, K) == items
    assert trsm.batched_trsm_scratch(P, M, K) == items + 1


def test_batched_trsm_items_refuse_an_empty_batch():
    for shape in ((0, 4, 4), (1, 0, 4), (1, 4, 0)):
        with pytest.raises(ValueError, match="P, M, K >= 1"):
            trsm.batched_trsm_scratch(*shape)


@pytest.mark.parametrize("pad_to", [9, 66, 1022])
def test_operand_kernel_wrapper_refuses_pad_to_off_its_rows(pad_to):
    # the kernel stores 16-byte runs of a row: pad_to is a multiple of 4
    # (and at least N); checked before the tensor's device
    with pytest.raises(ValueError, match="multiple of 4"):
        gram.gram_chol_operand_cuda("rbf", torch.zeros(8, 1), 1.0, 0.1, pad_to)
    with pytest.raises(ValueError, match="at least N"):
        gram.gram_chol_operand_cuda("rbf", torch.zeros(pad_to + 3, 1), 1.0, 0.1, pad_to - pad_to % 4)


def test_trsm_schedule_refuses_an_empty_right_hand_side():
    with pytest.raises(ValueError, match="at least one column"):
        trsm.trsm_schedule(0)
    with pytest.raises(ValueError, match="at least one column"):
        trsm.trsm_scratch(10, 0)


def test_serving_route_on_cpu_launches_nothing(monkeypatch):
    # the kernel route forced on for CPU tensors runs every wrapper's plain
    # version: the same answers as the plain route, and no launch
    monkeypatch.setattr(linalg, "kernels_active", lambda t: True)
    kernels = (gram.gram_cuda, gram.gram_lower_cuda, cholesky.cholesky_cuda, trsm.trsm_cuda)
    before = [k.launches for k in kernels]
    Xs, rng = _inputs(70, 1)
    K = gram.stationary_gram_lower("rbf", _t(Xs), 1.0)
    K.diagonal().add_(0.1)
    L = linalg.cholesky(K)
    assert L.stride() == (128, 1)  # a view into the padded buffer, read in place below
    B = _t(rng.randn(70, 3))
    X = linalg.cho_solve_lower(L, B)
    Kfull = gram.gram_reference("rbf", _t(Xs), _t(Xs), 1.0) + 0.1 * torch.eye(70, dtype=torch.float64)
    np.testing.assert_allclose(X.numpy(), np.linalg.solve(Kfull.numpy(), B.numpy()), rtol=1e-9)
    assert [k.launches for k in kernels] == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="exit code 3(.|\n)*no such target"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_keyed_by_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libgfs_kernels_")
    assert {f.name for f in _build.CSRC.glob("*.cu")} == {
        "gram_operand.cu", "chol_solve.cu", "gram.cu", "trsm.cu", "batched_trsm.cu"}
    assert set(_build._ENTRIES) == {"gfs_gram_chol_operand", "gfs_chol_solve_logdet", "gfs_gram",
                                    "gfs_gram_lower", "gfs_cholesky", "gfs_trsm",
                                    "gfs_batched_trsm"}


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax():
    # static: the test process has jax imported already
    files = sorted((REPO / "gpflow_slim_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_gpr.py",
        REPO / "tools" / "profile_torch_svgp.py", REPO / "tools" / "profile_torch_kernels.py",
        REPO / "tools" / "svgp_rate.py", REPO / "tools" / "profile_gram_host.py",
        REPO / "tools" / "svgp_parts.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "flax", "gpflow_slim_tpu"), (f, mod)
