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
from gpflow_slim_tpu_torch.ops import cholesky, gram

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _xs(N, D, dev, seed=0):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.uniform(0, 1, (N, D)) / 0.2, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("kind", list(gram.KINDS))
@pytest.mark.parametrize("N,D,pad_to", [(1, 1, 64), (130, 2, 192), (333, 5, 384)])
def test_operand_kernel_matches_plain(dev, kind, N, D, pad_to):
    xs = _xs(N, D, dev)
    var = torch.tensor(1.7, device=dev)
    noise = torch.tensor(0.3, device=dev)
    got = gram.gram_chol_operand_cuda(kind, xs, var, noise, pad_to)
    want = gram.gram_chol_operand_plain(kind, xs.double(), 1.7, 0.3, pad_to)
    lower = torch.ones(pad_to, pad_to, dtype=torch.bool, device=dev).tril_()
    # f32 rounding of exp and d^2: 1e-5 x variance absolute
    assert float((got.double() - want)[lower].abs().max()) <= 1e-5 * 1.7


@pytest.mark.parametrize("N,P", [(64, 1), (130, 8), (500, 3), (130, 9), (333, 20)])
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


def test_chol_kernel_nan_on_non_positive_pivot(dev):
    Kp = gram.gram_chol_operand_cuda("rbf", _xs(100, 1, dev), 1.0, -5.0, 128)
    _, alpha, hld = cholesky.cholesky_solve_cuda(Kp, torch.ones(128, 1, device=dev))
    torch.cuda.synchronize()
    assert torch.isnan(hld)


def test_wrappers_raise_instead_of_falling_back(dev):
    x64 = _xs(10, 1, dev).double()
    with pytest.raises(ValueError, match="float32"):
        gram.gram_chol_operand_cuda("rbf", x64, 1.0, 0.1, 64)
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
