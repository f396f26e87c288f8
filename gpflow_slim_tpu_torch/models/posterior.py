"""Precomputed posteriors for serving (counterpart of
``gpflow_slim_tpu.models.posterior``).

``GPR.posterior()`` factors once; every ``predict_*`` after it is
O(N N*): the cross Gram, one wide triangular solve and matrix products.
On CUDA float32 tensors the Gram and the solve are the hand-written
kernels (``ops.gram``, ``ops.trsm``). The sparse posteriors come with the
sparse models.
"""

from __future__ import annotations

import torch

from ..ops import linalg
from ..params import Module
from .model import as_tensor_like


class GPRPosterior(Module):
    """Cached exact-GPR predictor: holds (X, L, alpha) from one factorization
    as buffers."""

    def __init__(self, kern, likelihood, mean_function, X, L, alpha, num_latent):
        super().__init__()
        self.kern = kern
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.register_buffer("X", X)
        self.register_buffer("L", L)          # chol(K + noise I)
        self.register_buffer("alpha", alpha)  # (K + noise I)^-1 (Y - m(X))
        self.num_latent = int(num_latent)

    def predict_f(self, Xnew, full_cov=False):
        Xnew = as_tensor_like(Xnew, self.X)
        Kx = self.kern.K(self.X, Xnew)  # (N, N*)
        fmean = Kx.T @ self.alpha + self.mean_function(Xnew)
        A = linalg.solve_lower(self.L, Kx)
        if full_cov:
            fvar = self.kern.K(Xnew) - A.T @ A
            fvar = fvar[None, :, :].expand(self.num_latent, -1, -1)
        else:
            fvar = self.kern.Kdiag(Xnew) - torch.sum(torch.square(A), dim=0)
            fvar = fvar[:, None].expand(-1, self.num_latent)
        return fmean, fvar

    def predict_y(self, Xnew):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(m, v)

    def predict_density(self, Xnew, Ynew):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_density(m, v, as_tensor_like(Ynew, self.X))
