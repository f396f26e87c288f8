"""KL divergences for variational GPs (counterpart of
``gpflow_slim_tpu.kullback_leiblers``).

``gauss_kl(q_mu, q_sqrt, K=None)`` = KL[ N(q_mu, S) || N(0, K) ] summed over
the P independent outputs, S = q_sqrt q_sqrt^T (q_sqrt (P, M, M) lower
triangular) or diag(q_sqrt^2) (q_sqrt (M, P)). ``K=None`` is the whitened
case (prior N(0, I)):

  1/2 [ tr(K^-1 S) + q_mu^T K^-1 q_mu - M P + P logdet K - sum logdet S ].

The KL's own Cholesky and single solve are ``torch.linalg`` calls, as the
JAX package calls ``jax.scipy`` there; the (P, M, M) solve of a full
``q_sqrt`` against ``chol(K)`` goes through ``ops.linalg``, the batched
TRSM kernel on the kernel route.
"""

from __future__ import annotations

import torch

from .ops import linalg
from .ops.cholesky import cholesky_plain

__all__ = ["gauss_kl"]


def gauss_kl(q_mu, q_sqrt, K=None):
    """q_mu: (M, P); q_sqrt: (M, P) diagonal or (P, M, M) lower triangular;
    K: (M, M) positive definite (callers add the jitter) or None."""
    M, P = q_mu.shape
    diag = q_sqrt.dim() == 2

    if K is None:
        alpha = q_mu  # K^-1 = I
    else:
        Lp = cholesky_plain(K)  # torch.linalg.cholesky_ex; NaN where it fails, as XLA's
        alpha = torch.linalg.solve_triangular(Lp, q_mu, upper=False)

    mahalanobis = torch.sum(torch.square(alpha))
    constant = -M * P
    if diag:
        logdet_qcov = torch.sum(torch.log(torch.square(q_sqrt)))
    else:
        logdet_qcov = torch.sum(torch.log(torch.square(torch.diagonal(q_sqrt, dim1=-2, dim2=-1))))

    if K is None:
        trace = torch.sum(torch.square(q_sqrt if diag else torch.tril(q_sqrt)))
        prior_logdet = 0.0
    else:
        if diag:
            # tr(K^-1 diag(s^2)) = sum_m (K^-1)_mm sum_p s^2_mp, the diagonal
            # of K^-1 from the columns of Lp^-1
            eye = torch.eye(M, dtype=K.dtype, device=K.device)
            Kinv_diag = torch.sum(torch.square(torch.linalg.solve_triangular(Lp, eye, upper=False)),
                                  dim=0)
            trace = torch.sum(Kinv_diag[:, None] * torch.square(q_sqrt))
        else:
            # ||Lp^-1 Lq||_F^2 summed over p
            trace = torch.sum(torch.square(_batched_solve(Lp, q_sqrt)))
        prior_logdet = 2.0 * P * torch.sum(torch.log(torch.diagonal(Lp)))

    return 0.5 * (mahalanobis + constant - logdet_qcov + trace + prior_logdet)


def _batched_solve(Lp, Lq):
    # the (P, M, M) solves the batched TRSM kernel exists for; Lp is
    # broadcast over the outputs with a stride-0 batch, not copied
    Lq = torch.tril(Lq)
    return linalg.batched_solve_lower(Lp.expand(Lq.shape[0], -1, -1), Lq)
