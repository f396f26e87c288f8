"""Precomputed posteriors for serving (counterpart of
``gpflow_slim_tpu.models.posterior``).

A model's ``posterior()`` factors once; every ``predict_*`` after it is a
cross Gram, triangular solves against the cached factors and matrix
products: O(N N*) for ``GPRPosterior``, O(M N*) for ``SVGPPosterior`` and
``SGPRPosterior``. On CUDA float32 tensors the Gram and the solves are the
hand-written kernels (``ops.gram``, ``ops.trsm``). A posterior holds its
factors as buffers on its model's device.
"""

from __future__ import annotations

import torch

from .. import features as features_mod
from ..conditionals import base_conditional_with_lm
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


class SVGPPosterior(Module):
    """Cached SVGP predictor: chol(Kuu) and q as (M, P) and (P, M, M)
    tensors. ``predict_f`` is ``base_conditional_with_lm`` on them: the TRSM
    on chol(Kuu) (and its transposed view, unwhitened) and one batched
    product with q_sqrt."""

    def __init__(self, kern, likelihood, mean_function, feature, Luu, q_mu, q_sqrt, whiten, num_latent):
        super().__init__()
        self.kern = kern
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.feature = feature
        self.register_buffer("Luu", Luu)
        self.register_buffer("q_mu", q_mu)      # (M, P)
        self.register_buffer("q_sqrt", q_sqrt)  # (P, M, M) lower
        self.whiten = bool(whiten)
        self.num_latent = int(num_latent)

    def predict_f(self, Xnew, full_cov=False):
        Xnew = as_tensor_like(Xnew, self.Luu)
        Kmn = features_mod.Kuf(self.feature, self.kern, Xnew)
        Knn = self.kern.K(Xnew) if full_cov else self.kern.Kdiag(Xnew)
        mean, var = base_conditional_with_lm(Kmn, self.Luu, Knn, self.q_mu, full_cov=full_cov,
                                             q_sqrt=self.q_sqrt, white=self.whiten)
        return mean + self.mean_function(Xnew), var

    def predict_y(self, Xnew):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(m, v)


class SGPRPosterior(Module):
    """Cached SGPR predictor: the inducing side's factors L = chol(Kuu),
    LB = chol(I + A A^T) and c = LB^-1 A err / sigma, as buffers."""

    def __init__(self, kern, likelihood, mean_function, feature, L, LB, c, num_latent):
        super().__init__()
        self.kern = kern
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.feature = feature
        self.register_buffer("L", L)
        self.register_buffer("LB", LB)
        self.register_buffer("c", c)
        self.num_latent = int(num_latent)

    def predict_f(self, Xnew, full_cov=False):
        Xnew = as_tensor_like(Xnew, self.L)
        Kus = features_mod.Kuf(self.feature, self.kern, Xnew)
        tmp1 = linalg.solve_lower(self.L, Kus)
        tmp2 = linalg.solve_lower(self.LB, tmp1)
        mean = tmp2.T @ self.c + self.mean_function(Xnew)
        if full_cov:
            var = self.kern.K(Xnew) + tmp2.T @ tmp2 - tmp1.T @ tmp1
            var = var[None, :, :].expand(self.num_latent, -1, -1)
        else:
            var = self.kern.Kdiag(Xnew) + torch.sum(torch.square(tmp2), dim=0) \
                - torch.sum(torch.square(tmp1), dim=0)
            var = var[:, None].expand(-1, self.num_latent)
        return mean, var

    def predict_y(self, Xnew):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(m, v)
