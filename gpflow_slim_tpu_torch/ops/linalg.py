"""Routed dense linear algebra: the exact-GPR objective and predictions,
and the variational models' batched solves.

Counterpart of ``gpr_chol_terms``, ``chol_logdet_quad``, ``cholesky``,
``solve_lower``, ``solve_upper``, ``cho_solve_lower`` and the
``batched_*`` solves in ``gpflow_slim_tpu/ops/linalg.py``, with the same
dispatch shape. The route
is decided here and nowhere else, by ``kernels_active``: for a CUDA
float32 tensor with ``config.settings().use_kernels`` on, it is the
hand-written kernels at every N and every right-hand-side width: the
one-pass operand (``ops.gram``) feeding the fused factor/solve/logdet
(``ops.cholesky``) for the objective, the factor-only Cholesky
(``ops.cholesky``) and the wide TRSM (``ops.trsm``) for predictions, the
batched TRSM (``ops.trsm``) for the batched solves.
Otherwise it is the plain PyTorch composite (``torch.linalg``), with
autograd's own gradients; with ``use_kernels=False`` on CUDA this is the
explicit on/off pair, not a fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import cholesky as _chol
from . import trsm as _trsm


def kernels_active(t: torch.Tensor) -> bool:
    """True when ``t`` takes the hand-written kernel route."""
    return config.settings().use_kernels and t.is_cuda and t.dtype == torch.float32


def chol_logdet_quad(K, D):
    """``(half_logdet, quad)`` = ``(sum log diag chol(K), ||chol(K)^-1 D||^2)``
    of the MVN objective core, by the plain composite. Only the lower
    triangle of ``K`` is read."""
    if D.dim() == 1:
        D = D[:, None]
    L = _chol.cholesky_plain(K)
    half_logdet = torch.sum(torch.log(torch.diagonal(L)))
    alpha = torch.linalg.solve_triangular(L, D, upper=False)
    return half_logdet, torch.sum(torch.square(alpha))


def gpr_chol_terms(kern, X, noise, D):
    """``(half_logdet, quad)`` for ``K = kern.K(X) + noise * I``, the
    exact-GPR marginal-likelihood core.

    On the kernel route, and when the kernel has a fused map
    (``_gram_kind``), the whole N^2 pipeline is two kernels: the lower-tile
    operand ``kern.gram_chol_operand`` and the fused factor/solve/logdet.
    """
    if D.dim() == 1:
        D = D[:, None]
    N = X.shape[0]
    if kernels_active(X) and getattr(kern, "_gram_kind", None) is not None:
        Np = N + (-N) % _chol.BLOCK
        Kp = kern.gram_chol_operand(X, noise, Np)
        Dp = F.pad(D.to(Kp.dtype), (0, 0, 0, Np - N))
        return _chol.cholesky_solve_logdet(Kp, Dp)
    K = kern.K(X) + noise * torch.eye(N, dtype=X.dtype, device=X.device)
    return chol_logdet_quad(K, D)


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
