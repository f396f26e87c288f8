"""Routed dense linear algebra of the exact-GPR objective.

Counterpart of ``gpr_chol_terms`` and ``chol_logdet_quad`` in
``gpflow_slim_tpu/ops/linalg.py``, with the same dispatch shape. The route
is decided here and nowhere else, by ``kernels_active``: for a CUDA
float32 tensor with ``config.settings().use_kernels`` on, it is the
hand-written kernels at every N and every width of ``Y``: the one-pass
operand (``ops.gram``) feeding the fused factor/solve/logdet
(``ops.cholesky``). Otherwise it is the plain PyTorch composite
(``torch.linalg``), with autograd's own gradients; with
``use_kernels=False`` on CUDA this is the explicit on/off pair, not a
fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import cholesky as _chol


def kernels_active(t: torch.Tensor) -> bool:
    """True when ``t`` takes the hand-written kernel route."""
    return config.settings().use_kernels and t.is_cuda and t.dtype == torch.float32


def chol_logdet_quad(K, D):
    """``(half_logdet, quad)`` = ``(sum log diag chol(K), ||chol(K)^-1 D||^2)``
    of the MVN objective core, by the plain composite. Only the lower
    triangle of ``K`` is read."""
    if D.dim() == 1:
        D = D[:, None]
    L, info = torch.linalg.cholesky_ex(K)
    L = _chol._nan_where_failed(L, info)
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
