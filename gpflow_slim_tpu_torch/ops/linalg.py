"""Routed dense linear algebra: the exact-GPR objective and predictions,
the sparse and variational models' factors and solves, and the batched
solves.

Counterpart of ``gpr_chol_terms``, ``chol_logdet_quad``, ``cholesky``,
``solve_lower``, ``solve_upper``, ``cho_solve_lower``, the ``batched_*``
solves and ``robust_cholesky`` in ``gpflow_slim_tpu/ops/linalg.py``, with
the same dispatch shape, and ``solve_lower_refined``, a float32 solve
refined on float64 residuals. The route is decided here and nowhere else, by
``kernels_active``: for a CUDA float32 tensor with
``config.settings().use_kernels`` on, it is the hand-written kernels at
every N and every right-hand-side width:

- the exact-GPR objective (``gpr_chol_terms``): for a kernel with a fused
  operand (a fused map, ``ops.gram``; the paper's NKN, ``ops.nkn``), the
  one-pass operand feeding the fused factor/solve/logdet
  (``ops.cholesky``); for any other kernel (a ``Sum``, a ``Periodic``,
  ...) ``kern.K_lower(X)`` copied into a padded system (``pad_system``),
  the noise added to the copy's diagonal, and the same fused kernel;
- factors and solves: the factor-only Cholesky (``ops.cholesky``) and the
  wide TRSM (``ops.trsm``), also under ``robust_cholesky``;
- the batched solves: the batched TRSM (``ops.trsm``).

Otherwise it is the plain PyTorch composite (``torch.linalg``), with
autograd's own gradients; with ``use_kernels=False`` on CUDA this is the
explicit on/off pair, not a fallback. No routed call reaches
``torch.linalg`` on the kernel route.
"""

from __future__ import annotations

import torch

from .. import config
from . import cholesky as _chol
from . import trsm as _trsm
from ._func import transforms_active


def kernels_active(t: torch.Tensor) -> bool:
    """True when ``t`` takes the hand-written kernel route."""
    return config.settings().use_kernels and t.is_cuda and t.dtype == torch.float32


pad_system = _chol.pad_system


def chol_logdet_quad(K, D):
    """``(half_logdet, quad)`` = ``(sum log diag chol(K), ||chol(K)^-1 D||^2)``
    of the MVN objective core. Only the lower triangle of ``K`` is read. On
    the kernel route: the padded system (``pad_system``) through the fused
    factor/solve/logdet kernel, which factors the padded copy in place;
    otherwise the plain composite."""
    if D.dim() == 1:
        D = D[:, None]
    if kernels_active(K):
        return _chol.cholesky_solve_logdet(*pad_system(K, D))
    L = _chol.cholesky_plain(K)
    half_logdet = torch.sum(torch.log(torch.diagonal(L)))
    alpha = torch.linalg.solve_triangular(L, D, upper=False)
    return half_logdet, torch.sum(torch.square(alpha))


def _add_to_diagonal(K, noise, n):
    """``K`` with ``noise`` added to its first ``n`` diagonal entries: in
    place (no N x N eye, no second N x N sum), as ``GPR._K_chol`` adds it,
    except inside a ``torch.func`` transform, where K and the noise may be
    batched apart and the sum is formed out of place."""
    if transforms_active():
        d = torch.diagonal(K)
        return torch.diagonal_scatter(K, torch.cat([d[:n] + noise, d[n:]]))
    K.diagonal()[:n].add_(noise)
    return K


def gpr_chol_terms(kern, X, noise, D):
    """``(half_logdet, quad)`` for ``K = kern.K(X) + noise * I``, the
    exact-GPR marginal-likelihood core.

    On the kernel route, a kernel with a fused operand (its
    ``gram_chol_operand`` returns one: a fused map, the paper's NKN) takes
    the whole N^2 pipeline in two kernels, the operand and the fused
    factor/solve/logdet. Any other kernel forms ``kern.K_lower(X)``; on the
    kernel route its padded copy (``pad_system``) takes the noise on its
    diagonal and goes through the same fused kernel, elsewhere K takes it
    and goes through the plain composite (``chol_logdet_quad``). Where
    ``K_lower``'s output is a tensor autograd saved, the in-place add
    raises in the backward: no kernel of the package gives one.
    """
    if D.dim() == 1:
        D = D[:, None]
    N = X.shape[0]
    if kernels_active(X):
        Np = _chol.padded_size(N)
        operand = getattr(kern, "gram_chol_operand", None)
        Kp = operand(X, noise, Np) if operand is not None else None
        if Kp is not None:
            return _chol.cholesky_solve_logdet(Kp, _chol.pad_rows(D, Np, Kp.dtype))
        Kp, Dp = pad_system(kern.K_lower(X), D)
        return _chol.cholesky_solve_logdet(_add_to_diagonal(Kp, noise, N), Dp)
    return chol_logdet_quad(_add_to_diagonal(kern.K_lower(X), noise, N), D)


def cholesky(K):
    """Lower Cholesky factor of an SPD matrix; only its lower triangle is
    read (a lower-tile Gram is a valid input), a failure gives NaN."""
    if kernels_active(K):
        return _chol.cholesky(K)
    return _chol.cholesky_plain(K)


def solve_lower(L, B):
    """Solve ``L X = B`` with ``L`` lower triangular; ``B`` (N, P) or (N,)."""
    if kernels_active(L):
        return _trsm.solve_lower(L, B)
    return _trsm.solve_triangular_plain(L, B, lower=True)


def solve_lower_refined(L, B):
    """``solve_lower(L, B)`` and, for a float32 ``L``, one step of iterative
    refinement on float64 residuals ``B - L X`` (a second solve and a
    float64 product) on either route; a float64 solve is returned as it
    is. A float32 solve's error relative to L is about cond(L) x 6e-8, and
    the BayesianGPLVM's bound amplifies its solves against an
    ill-conditioned Kuu (cond(Kuu) ~1e5 on example 08's data at M=64,
    where unrefined float32 solves put its gradients ~1e-2 off float64 on
    either route: tools/lvm_grad_points.py on an H100)."""
    X = solve_lower(L, B)
    if L.dtype != torch.float32:
        return X
    R = (B.double() - torch.tril(L).double() @ X.double()).to(X.dtype)
    return X + solve_lower(L, R)


def solve_upper(U, B):
    """Solve ``U X = B`` with ``U`` upper triangular; ``B`` (N, P) or (N,)."""
    if kernels_active(U):
        return _trsm.solve_upper(U, B)
    return _trsm.solve_triangular_plain(U, B, lower=False)


def cho_solve_lower(L, B):
    """Solve ``(L L^T) X = B`` given the lower Cholesky factor."""
    return solve_upper(L.mT, solve_lower(L, B))


def batched_solve_lower(L, B):
    """Solve ``L[p] X[p] = B[p]`` over a leading batch dim, ``L`` (P, M, M)
    lower triangular (one triangle broadcast with ``expand`` is read in
    place), ``B`` (P, M, K): the variational q_sqrt / per-output solves."""
    if kernels_active(L):
        return _trsm.batched_solve_lower(L, B)
    return _trsm.solve_triangular_plain(L, B, lower=True)


def batched_solve_upper(U, B):
    """Solve ``U[p] X[p] = B[p]`` over a leading batch dim, ``U`` upper."""
    if kernels_active(U):
        return _trsm.batched_solve_upper(U, B)
    return _trsm.solve_triangular_plain(U, B, lower=False)


def batched_cho_solve_lower(L, B):
    """Solve ``(L[p] L[p]^T) X[p] = B[p]`` given batched lower factors."""
    return batched_solve_upper(L.mT, batched_solve_lower(L, B))


def robust_cholesky(K, max_tries: int = 5):
    """Cholesky with jitter escalation: ``(L, jitter_used)``.

    Factors ``K + j * scale * I``, ``scale`` the mean of ``K``'s diagonal
    and ``j`` the dtype's default jitter, then, while the factor is not
    finite, again with ``j`` ten times larger, at most ``max_tries`` more
    times; ``jitter_used`` is the last ``j * scale``. Each try is
    ``cholesky`` (the factor-only kernel on the kernel route, which gives
    NaN where it fails), and each costs one host sync to read whether the
    factor is finite: this is a safety net for ill-conditioned matrices, on
    no hot path."""
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    scale = torch.mean(torch.diagonal(K))
    jit_rel = config.default_jitter(K.dtype)
    L = cholesky(K + jit_rel * scale * eye)
    for _ in range(max_tries):
        if bool(torch.isfinite(L).all()):
            break
        jit_rel *= 10.0
        L = cholesky(K + jit_rel * scale * eye)
    return L, jit_rel * scale
