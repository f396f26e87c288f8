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

from gpflow_slim_tpu.ops import pallas_cholesky, pallas_gram
from gpflow_slim_tpu_torch import config
from gpflow_slim_tpu_torch.ops import _build, cholesky, gram

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
    assert {f.name for f in _build.CSRC.glob("*.cu")} == {"gram_operand.cu", "chol_solve.cu"}


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
        REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_gpr.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "flax", "gpflow_slim_tpu"), (f, mod)
