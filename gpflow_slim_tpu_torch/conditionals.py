"""GP conditionals (counterpart of ``gpflow_slim_tpu.conditionals``).

``base_conditional``: given Kmn, Kmm, Knn and the values or variational
statistics at the M points, the predictive mean and (co)variance at the N
points, with an optional variational ``q_sqrt`` and the whitened
representation. Shapes follow the reference:
  Kmn (M, N); Kmm (M, M); Knn (N, N) if full_cov else (N,);
  f (M, P); q_sqrt (M, P) diagonal or (P, M, M) lower triangular.
It returns fmean (N, P) and fvar (N, P), or (P, N, N) with ``full_cov``.

The factor of Kmm and the solves against it go through ``ops.linalg``: on
the kernel route the factor-only Cholesky and the wide TRSM.
``uncertain_conditional`` and the psi-statistics come later.
"""

from __future__ import annotations

import torch

from . import config
from .ops import linalg

__all__ = ["base_conditional", "base_conditional_with_lm", "conditional", "feature_conditional"]


def base_conditional(Kmn, Kmm, Knn, f, *, full_cov=False, q_sqrt=None, white=False):
    Lm = linalg.cholesky(Kmm)
    return base_conditional_with_lm(Kmn, Lm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white)


def base_conditional_with_lm(Kmn, Lm, Knn, f, *, full_cov=False, q_sqrt=None, white=False):
    """base_conditional given a precomputed Cholesky factor of Kmm."""
    num_func = f.shape[1]  # P
    A = linalg.solve_lower(Lm, Kmn)  # (M, N)

    if full_cov:
        fvar = Knn - A.T @ A  # (N, N)
        fvar = fvar[None, :, :].expand(num_func, -1, -1)  # (P, N, N)
    else:
        fvar = Knn - torch.sum(torch.square(A), dim=0)  # (N,)
        fvar = fvar[None, :].expand(num_func, -1)  # (P, N)

    if not white:
        A = linalg.solve_upper(Lm.mT, A)  # Kmm^-1 Kmn

    fmean = A.T @ f  # (N, P)

    if q_sqrt is not None:
        if q_sqrt.dim() == 2:
            LTA = A[None, :, :] * q_sqrt.T[:, :, None]  # (P, M, N)
        elif q_sqrt.dim() == 3:
            LTA = torch.matmul(torch.tril(q_sqrt).mT, A)  # (P, M, N), one batched product
        else:
            raise ValueError(f"bad q_sqrt rank: {q_sqrt.dim()}")
        if full_cov:
            fvar = fvar + LTA.mT @ LTA
        else:
            fvar = fvar + torch.sum(torch.square(LTA), dim=1)  # (P, N)

    if not full_cov:
        fvar = fvar.T  # (N, P)
    return fmean, fvar


def conditional(Xnew, X, kern, f, *, full_cov=False, q_sqrt=None, white=False):
    """Predictive q(f*) given (variational) values f at the inputs X."""
    jitter = config.default_jitter(X.dtype)
    Kmm = kern.K(X) + jitter * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    Kmn = kern.K(X, Xnew)
    Knn = kern.K(Xnew) if full_cov else kern.Kdiag(Xnew)
    return base_conditional(Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white)


def feature_conditional(Xnew, feat, kern, f, *, full_cov=False, q_sqrt=None, white=False):
    """Conditional through an inducing feature (its ``Kuu`` and ``Kuf``)."""
    from . import features

    jitter = config.default_jitter(Xnew.dtype)
    Kmm = features.Kuu(feat, kern, jitter=jitter)
    Kmn = features.Kuf(feat, kern, Xnew)
    Knn = kern.K(Xnew) if full_cov else kern.Kdiag(Xnew)
    return base_conditional(Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white)
