"""Exact Gaussian-process regression (counterpart of ``gpflow_slim_tpu.models.gpr``).

The log marginal likelihood comes from ``ops.linalg.gpr_chol_terms``: on
CUDA float32 tensors the one-pass operand kernel feeding the fused
factor/solve/logdet kernel, elsewhere the plain ``torch.linalg`` composite.
Predictions factor ``K_lower(X) + noise I`` (``_K_chol``) and solve against
it through ``ops.linalg``: on CUDA float32 tensors the lower-tile Gram, the
factor-only Cholesky, the cross Gram and the wide TRSM kernels.
``posterior()`` factors once for many requests; ``build_predict`` factors
in every call, as the reference does.
"""

from __future__ import annotations

import math

import torch

from ..likelihoods import Gaussian
from ..ops import linalg
from ..utils.trace import named_scope
from .model import GPModel, as_tensor_like


class GPR(GPModel):
    def __init__(self, X, Y, kern, mean_function=None, name="gpr", device=None, dtype=None):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name,
                         device=device, dtype=dtype)

    def _K_chol(self):
        # K_lower: the factorization reads only the lower triangle, so the
        # kernel route skips the map on the strictly-upper tiles. The noise
        # goes onto the diagonal in place: no N x N eye and no second N x N
        # sum. Autograd follows it (the lower-tile Gram saves its inputs,
        # not its output).
        K = self.kern.K_lower(self.X)
        K.diagonal().add_(torch.squeeze(self.likelihood.variance.value))
        return linalg.cholesky(K)

    def build_likelihood(self):
        """log p(Y | theta) = MVN(Y; m(X), K + noise I), summed over columns."""
        with named_scope("gfs.gpr.likelihood"):
            N = self.X.shape[0]
            d = self.Y - self.mean_function(self.X)
            noise = torch.squeeze(self.likelihood.variance.value)
            half_logdet, quad = linalg.gpr_chol_terms(self.kern, self.X, noise, d)
            num_col = d.shape[1] if d.dim() > 1 else 1
            return (
                -0.5 * N * num_col * math.log(2.0 * math.pi)
                - num_col * half_logdet
                - 0.5 * quad
            )

    def posterior(self):
        """Precompute (L, alpha) once for O(N N*) serving predictions."""
        from .posterior import GPRPosterior

        with named_scope("gfs.gpr.posterior"):
            L = self._K_chol()
            err = self.Y - self.mean_function(self.X)
            alpha = linalg.solve_upper(L.T, linalg.solve_lower(L, err))
        return GPRPosterior(self.kern, self.likelihood, self.mean_function,
                            self.X, L, alpha, self.num_latent)

    def build_predict(self, Xnew, full_cov=False):
        Xnew = as_tensor_like(Xnew, self.X)
        Kx = self.kern.K(self.X, Xnew)  # (N, N*)
        L = self._K_chol()
        A = linalg.solve_lower(L, Kx)  # (N, N*)
        V = linalg.solve_lower(L, self.Y - self.mean_function(self.X))  # (N, P)
        fmean = A.T @ V + self.mean_function(Xnew)
        if full_cov:
            fvar = self.kern.K(Xnew) - A.T @ A
            fvar = fvar[None, :, :].expand(self.num_latent, -1, -1)  # (P, N*, N*)
        else:
            fvar = self.kern.Kdiag(Xnew) - torch.sum(torch.square(A), dim=0)
            fvar = fvar[:, None].expand(-1, self.num_latent)  # (N*, P)
        return fmean, fvar
