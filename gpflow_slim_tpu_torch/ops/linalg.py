"""Routed dense linear algebra: the exact-GPR objective and predictions,
the sparse and variational models' factors and solves, and the batched
solves.

Counterpart of ``gpr_chol_terms``, ``chol_logdet_quad``, ``cholesky``,
``solve_lower``, ``solve_upper``, ``cho_solve_lower``, the ``batched_*``
solves and ``robust_cholesky`` in ``gpflow_slim_tpu/ops/linalg.py``, with
the same dispatch shape. The route is decided here and nowhere else, by
``kernels_active``: for a CUDA float32 tensor with
``config.settings().use_kernels`` on, it is the hand-written kernels at
every N and every right-hand-side width:

- the exact-GPR objective (``gpr_chol_terms``): for a kernel with a fused
  map, the one-pass operand (``ops.gram``) feeding the fused
  factor/solve/logdet (``ops.cholesky``); for any other kernel (a ``Sum``,
  a ``Periodic``, ...) ``kern.K_lower(X) + noise * I`` copied into a
  padded system (``pad_system``) and the same fused kernel
  (``chol_logdet_quad``);
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
import torch.nn.functional as F

from .. import config
from . import cholesky as _chol
from . import trsm as _trsm


def kernels_active(t: torch.Tensor) -> bool:
    """True when ``t`` takes the hand-written kernel route."""
    return config.settings().use_kernels and t.is_cuda and t.dtype == torch.float32


def pad_system(K, D):
    """``(Kp, Dp)``: ``K`` (N, N) copied into an (Np, Np) matrix with a
    unit-diagonal extension, Np the next multiple of ``ops.cholesky.BLOCK``,
    and ``D`` (N, P) with zero pad rows. Its factor is ``chol(K)`` in the
    leading block and the identity in the pad, so the pad rows of
    ``chol(Kp)^-1 Dp`` are exactly zero and the pad's log-diagonal terms
    exactly log 1: the padded system's half-logdet and quad are the leading
    system's."""
    N = K.shape[0]
    Np = N + (-N) % _chol.BLOCK
    Kp = F.pad(K, (0, Np - N, 0, Np - N))
    Kp.diagonal()[N:] = 1.0
    return Kp, F.pad(D.to(K.dtype), (0, 0, 0, Np - N))


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


def gpr_chol_terms(kern, X, noise, D):
    """``(half_logdet, quad)`` for ``K = kern.K(X) + noise * I``, the
    exact-GPR marginal-likelihood core.

    On the kernel route, and when the kernel has a fused map
    (``_gram_kind``), the whole N^2 pipeline is two kernels: the lower-tile
    operand ``kern.gram_chol_operand`` and the fused factor/solve/logdet.
    Any other kernel forms ``kern.K_lower(X) + noise * I`` and goes through
    ``chol_logdet_quad``, on the kernel route the same fused kernel.
    """
    if D.dim() == 1:
        D = D[:, None]
    N = X.shape[0]
    if kernels_active(X) and getattr(kern, "_gram_kind", None) is not None:
        Np = N + (-N) % _chol.BLOCK
        Kp = kern.gram_chol_operand(X, noise, Np)
        Dp = F.pad(D.to(Kp.dtype), (0, 0, 0, Np - N))
        return _chol.cholesky_solve_logdet(Kp, Dp)
    K = kern.K_lower(X) + noise * torch.eye(N, dtype=X.dtype, device=X.device)
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
