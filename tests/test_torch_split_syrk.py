"""The port's split-bf16 trailing-update modes (``syrk`` = "s3", "s4", "s3d",
"s4d" and their "x2" names) against the JAX package, on the CPU in float64.

The JAX side runs ``pallas_cholesky``'s kernel in interpret mode, as
tests/test_pallas.py does; the port's side runs the plain split versions
that stand beside its CUDA kernel (a wrapper takes them for CPU tensors).
Inputs come from numpy with a fixed seed.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from gpflow_slim_tpu.ops import pallas_cholesky
from gpflow_slim_tpu_torch.ops import cholesky, gram

torch.set_num_threads(2)

SPLIT = ("s3", "s4", "s3d", "s4d")
# the JAX package's own gate on a split factor against f64
# (tests/test_pallas.py::test_pallas_cholesky_syrk_modes_interpret)
SPLIT_TOL = 2e-3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _spd(N, seed=0):
    # tests/test_pallas.py's spd: A A^T + N I
    A = np.random.RandomState(seed).randn(N, N)
    return A @ A.T + N * np.eye(N)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def _jax_split(x):
    # `_bf16_split` of _make_chol_kernel, written out (it is local to the kernel)
    hi = x.astype(jnp.bfloat16)
    lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, lo


def _jax_dot_nt(x, y):
    # `_dot_nt` of _make_chol_kernel
    import jax
    return jax.lax.dot_general(x, y, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)


def _split_inputs(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(4000) * np.exp(rng.uniform(-20, 20, 4000))
    # exact ties of bf16 rounding (the low 16 bits of an f32 at 0x8000),
    # a hair either side of them, zeros and +-1
    f = rng.randn(2000).astype(np.float32)
    ties = ((f.view(np.uint32) & np.uint32(0xFFFF0000)) | np.uint32(0x8000)).view(np.float32)
    ties = ties.astype(np.float64)
    x = np.concatenate([x, ties, ties * (1 + 2.0**-30), ties * (1 - 2.0**-30), ties * (1 + 2.0**-20),
                        [0.0, -0.0, 1.0, -1.0]])
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_split_equals_jax_bit_for_bit(dtype):
    x = _split_inputs(dtype)
    hi, lo = cholesky.bf16_split(torch.tensor(x))
    jhi, jlo = _jax_split(jnp.asarray(x))
    assert hi.dtype == lo.dtype == torch.from_numpy(x).dtype
    for got, want in ((hi, jhi), (lo, jlo)):
        want = np.asarray(want.astype(jnp.float64))
        np.testing.assert_array_equal(got.double().numpy().view(np.uint64), want.view(np.uint64))
    # hi is bf16-valued, and hi + lo carries x to about 2^-16 relative
    assert np.array_equal(hi.numpy(), hi.numpy().astype(ml_dtypes.bfloat16).astype(dtype))
    nz = x != 0
    assert np.all(np.abs((hi + lo).numpy()[nz] - x[nz]) <= 2.0**-15 * np.abs(x[nz]))


@pytest.mark.parametrize("syrk", ["s3", "s4", "s4dx2"])
def test_split_product_plain_matches_jax_dot_nt(syrk):
    rng = np.random.RandomState(1)
    A, B = rng.randn(70, 48), rng.randn(50, 48)
    got = cholesky.split_product_plain(_t(A), _t(B), syrk)
    assert got.dtype == torch.float32
    ah, al = _jax_split(jnp.asarray(A))
    bh, bl = _jax_split(jnp.asarray(B))
    want = _jax_dot_nt(ah, bh) + _jax_dot_nt(ah, bl) + _jax_dot_nt(al, bh)
    if syrk.startswith("s4"):
        want = want + _jax_dot_nt(al, bl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * np.abs(want).max())
    # the split's error against the exact product: ~2^-16 (s3), ~2^-17 (s4)
    assert _rel(got.double(), A @ B.T) < (3e-5 if syrk == "s3" else 1e-5)


@pytest.mark.parametrize("syrk", list(SPLIT) + ["s4x2"])
def test_split_factor_matches_pallas_interpret(syrk):
    # tests/test_pallas.py's N = 200 case: the JAX kernel at block 64, the
    # plain split version at panel = tile = 64 (its "d" blocks). With
    # exact_pivots=False the plain version splits the diagonal entries too,
    # as the JAX update does, and the two differ by the float32 rounding of
    # their products alone (1.2e-7 here); the port's own form, exact pivots,
    # by 1.8e-7-4.0e-7
    K = _spd(200)
    Lref = np.linalg.cholesky(K)
    got = cholesky.cholesky_split_plain(_t(K), syrk, panel=64, tile=64).numpy()
    as_jax = cholesky.cholesky_split_plain(_t(K), syrk, panel=64, tile=64, exact_pivots=False).numpy()
    want = np.asarray(pallas_cholesky.cholesky_interpret(jnp.asarray(K), 64, syrk))
    for L in (got, want):
        assert _rel(L, Lref) < SPLIT_TOL
    assert _rel(as_jax, want) < 1e-6
    assert _rel(got, want) < 1e-6
    assert np.abs(np.triu(got, 1)).max() == 0.0
    # the split ran: not the exact factor
    assert _rel(got, Lref) > 1e-12


def _structured_spd(N, seed=0):
    # K = L L^T, L = 64 I + a strictly-lower part whose entries split with
    # one sign: x = 2^e (1 + 3 2^-10 + 2^-18), e in {-1, 0}, has hi = 2^e,
    # lo = 3 2^(e-10) and a remainder 2^(e-18) that "s4" drops. Every
    # trailing product then errs one way in each mode (ll = 9 2^-20 hh in
    # "s3"), so the modes' factors part by more than the float32 rounding
    # of the products; in A A^T + N I the modes stay within that rounding
    # of each other (a max-norm 1.5e-7 apart, 1.1e-7 from JAX's)
    E = 2.0 ** np.random.RandomState(seed).randint(-1, 1, (N, N)) * (1 + 3 * 2.0**-10 + 2.0**-18)
    L = np.tril(E, -1) + 64 * np.eye(N)
    return L @ L.T


@pytest.fixture(scope="module")
def structured_factors():
    K = _structured_spd(200)
    jax_L = {m: np.asarray(pallas_cholesky.cholesky_interpret(jnp.asarray(K), 64, m)) for m in SPLIT}
    jax_L["hi"] = np.linalg.cholesky(K)
    return K, jax_L


# each mode's plain version (exact_pivots=False, the JAX update's form) is
# within 3e-8 of the JAX kernel in that mode, and at least 3x nearer to it
# than to the JAX kernel in any other mode or the exact factor (the own
# mode 1.1e-8-1.5e-8 off, the nearest other 8.4e-8); the port's exact
# pivots move a non-"d" mode 1.1e-7-1.8e-7 (bounded at 3e-7)
@pytest.mark.parametrize("syrk", SPLIT)
def test_split_modes_are_told_apart_against_pallas_interpret(structured_factors, syrk):
    K, jax_L = structured_factors
    got = cholesky.cholesky_split_plain(_t(K), syrk, panel=64, tile=64, exact_pivots=False).numpy()
    own = _rel(got, jax_L[syrk])
    assert own < 3e-8
    assert 3 * own < min(_rel(got, jax_L[m]) for m in jax_L if m != syrk)
    shipped = cholesky.cholesky_split_plain(_t(K), syrk, panel=64, tile=64).numpy()
    assert _rel(shipped, jax_L[syrk]) < (3e-8 if syrk.endswith("d") else 3e-7)


@pytest.mark.parametrize("syrk", list(SPLIT) + ["s4x2", True])
def test_cholesky_entry_runs_the_split_on_the_cpu(syrk):
    # 640 > 256: three 256-wide panels of the kernel's geometry, two
    # trailing updates (a K inside one panel runs no split at all)
    K = _spd(640, seed=2)
    Lref = np.linalg.cholesky(K)
    L = cholesky.cholesky(_t(K), syrk=syrk).numpy()
    hi = cholesky.cholesky(_t(K)).numpy()
    assert _rel(L, Lref) < SPLIT_TOL
    assert _rel(L, hi) > 1e-12
    assert np.abs(np.triu(L, 1)).max() == 0.0
    want = cholesky.cholesky_split_plain(_t(K), syrk).numpy()
    np.testing.assert_array_equal(L, want)


def _padded_system(N=150, Np=192, P=2, seed=3):
    K = _spd(N, seed)
    Kp = np.eye(Np)
    Kp[:N, :N] = K
    Dp = np.zeros((Np, P))
    Dp[:N] = np.random.RandomState(seed + 1).randn(N, P)
    return Kp, Dp


@pytest.mark.parametrize("syrk", list(SPLIT) + ["s4x2"])
def test_split_solve_logdet_matches_pallas_interpret(syrk):
    # a unit-diagonal pad (150 -> 192: three 64-blocks); scalars at 1e-6
    Kp, Dp = _padded_system()
    Kw = _t(Kp)
    L, alpha, hl = cholesky.cholesky_solve_split_plain(Kw, _t(Dp), syrk, panel=64, tile=64)
    q = float(torch.sum(alpha**2))
    jhl, jq = pallas_cholesky.cholesky_solve_logdet_interpret(jnp.asarray(Kp), jnp.asarray(Dp), 64, syrk)
    assert abs(float(hl) - float(jhl)) <= 1e-6 * abs(float(jhl))
    assert abs(q - float(jq)) <= 1e-6 * abs(float(jq))
    assert bool((alpha[150:] == 0).all())
    assert torch.equal(L, Kw)  # factored in place
    # the padded public entry (the kernel's geometry; Np = 640: three panels)
    Kp, Dp = _padded_system(600, 640, 2, seed=4)
    Lref = np.linalg.cholesky(Kp)
    hl_ref = np.log(np.diag(Lref)).sum()
    hl, q = cholesky.cholesky_solve_logdet(_t(Kp), _t(Dp), syrk=syrk)
    _, a_w, hl_w = cholesky.cholesky_solve_split_plain(_t(Kp), _t(Dp), syrk)
    assert float(hl) == float(hl_w) and float(q) == float(torch.sum(a_w**2))
    assert abs(float(hl) - hl_ref) <= SPLIT_TOL * abs(hl_ref)
    assert float(hl) != float(cholesky.cholesky_solve_logdet(_t(Kp), _t(Dp))[0])


def test_split_solve_logdet_gradient_matches_jax_csl_bwd():
    # the backward ignores the mode (JAX's _csl_bwd too): on the same split
    # factor, the port's Kbar and Dbar are JAX's
    Kp, Dp = _padded_system(600, 640, 2, seed=5)
    K, D = _t(Kp).requires_grad_(), _t(Dp).requires_grad_()
    hl, q = cholesky.cholesky_solve_logdet(K.clone(), D, syrk="s4")
    gK, gD = torch.autograd.grad(0.7 * hl + 1.3 * q, (K, D))
    Lp, alpha, _ = cholesky.cholesky_solve_split_plain(_t(Kp), _t(Dp), "s4")
    jK, jD = pallas_cholesky._csl_bwd(64, "s4", (jnp.asarray(Lp.numpy()), jnp.asarray(alpha.numpy())),
                                      (jnp.float64(0.7), jnp.float64(1.3)))
    np.testing.assert_allclose(gK.numpy(), np.asarray(jK), rtol=0, atol=1e-8 * np.abs(np.asarray(jK)).max())
    np.testing.assert_allclose(gD.numpy(), np.asarray(jD), rtol=0, atol=1e-8 * np.abs(np.asarray(jD)).max())


def test_norm_syrk_aliases_and_unknown_modes():
    assert cholesky.norm_syrk(True) == "s3"
    assert cholesky.norm_syrk(False) == cholesky.norm_syrk(None) == "hi"
    assert set(cholesky.SYRK_MODES) == {b + x for b in ("hi", "s3", "s4", "s3d", "s4d") for x in ("", "x2")}
    assert cholesky.syrk_base("s4dx2") == "s4d"
    K = _t(_spd(20))
    for bad in ("s5", "hix3", "S4", "x2", 1):
        with pytest.raises(ValueError, match="syrk"):
            cholesky.norm_syrk(bad)
        with pytest.raises(ValueError, match="syrk"):
            cholesky.cholesky(K, syrk=bad)
        with pytest.raises(ValueError, match="syrk"):
            cholesky.cholesky_solve_logdet(K.clone(), K[:, :1], syrk=bad)
    with pytest.raises(ValueError, match="split mode"):
        cholesky.split_product_plain(K, K, "hi")


def _operand(N, pad_to, seed):
    Xs = np.random.RandomState(seed).uniform(0, 1, (N, 1)) / 0.3
    return gram.gram_chol_operand_plain("rbf", _t(Xs), 1.1, 0.3, pad_to)


def test_syrk_under_torch_func_grad_and_vmap():
    # 300 rows: two of the kernel's panels, so the split runs
    Kp = _operand(300, 320, 6)
    Dp = torch.zeros(320, 1, dtype=torch.float64)
    Dp[:300] = _t(np.random.RandomState(7).randn(300, 1))

    def f(k):
        hl, q = cholesky.cholesky_solve_logdet(k, Dp, syrk="s4")
        return hl + q

    K = Kp.clone().requires_grad_()
    want = torch.autograd.grad(f(K.clone()), K)[0]
    K2 = Kp.clone()
    got = grad(f)(K2)
    assert torch.equal(K2, Kp)  # a transform factors a copy
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-13 * float(want.abs().max()))

    Kb = torch.stack([Kp + 0.5 * i * torch.eye(320, dtype=torch.float64) for i in range(2)])
    for fn in (lambda k: cholesky.cholesky(k, syrk="s3d"), lambda k: torch.stack(
            cholesky.cholesky_solve_logdet(k, Dp, syrk="s3d"))):
        got = vmap(fn)(Kb)
        want = torch.stack([fn(Kb[i].clone()) for i in range(2)])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-13 * float(want.abs().max()))
    # and the mode reaches the factor: not "hi"'s
    assert not torch.equal(vmap(lambda k: cholesky.cholesky(k, syrk="s3"))(Kb),
                           vmap(cholesky.cholesky)(Kb))
