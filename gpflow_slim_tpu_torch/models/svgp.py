"""Stochastic variational GP (counterpart of ``gpflow_slim_tpu.models.svgp``).

Hensman et al. 2013/2015: a trainable q(u) = N(q_mu, q_sqrt q_sqrt^T) over M
inducing outputs, whitened by default. ELBO = (N / B) sum of the
variational expectations over a batch - KL. ``build_likelihood_batch``
takes an explicit minibatch; ``training.fit_svgp_natgrad`` draws them.

On the kernel route (CUDA float32) ``Kuu`` and ``Kuf`` are the cross-Gram
kernel, the conditional factors ``Kuu`` with the factor-only Cholesky and
solves with the wide TRSM, and the unwhitened KL solves its (P, M, M)
``chol(Kuu)^-1 q_sqrt`` with the batched TRSM. ``posterior()`` factors
``Kuu`` once for serving (``SVGPPosterior``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from .. import features as features_mod
from ..conditionals import base_conditional
from ..kullback_leiblers import gauss_kl
from ..ops import linalg
from ..params import Param
from ..transforms import LowerTriangular, positive
from .model import GPModel, as_tensor_like


class SVGP(GPModel):
    def __init__(self, X, Y, kern, likelihood, feat=None, Z=None, mean_function=None,
                 num_latent=None, q_diag=False, whiten=True, name="svgp", device=None, dtype=None):
        super().__init__(X, Y, kern, likelihood, mean_function, num_latent=num_latent, name=name,
                         device=device, dtype=dtype)
        self.feature = features_mod.inducingpoint_wrapper(feat, Z)
        self.q_diag = bool(q_diag)
        self.whiten = bool(whiten)
        self.num_data = int(self.X.shape[0])

        M = len(self.feature)
        P = self.num_latent
        self.q_mu = Param(np.zeros((M, P)), name=f"{name}/q_mu")
        if q_diag:
            self.q_sqrt = Param(np.ones((M, P)), transform=positive(), name=f"{name}/q_sqrt")
        else:
            # identity init, packed through the LowerTriangular transform
            init = np.tile(np.eye(M)[None], (P, 1, 1))
            self.q_sqrt = Param(init, transform=LowerTriangular(M, num_matrices=P),
                                name=f"{name}/q_sqrt")
        self.to(device=self.X.device, dtype=self.X.dtype)

    # -- ELBO --------------------------------------------------------------
    def _jitter(self):
        return config.default_jitter(self.X.dtype)

    def prior_kl(self):
        if self.whiten:
            return gauss_kl(self.q_mu.value, self.q_sqrt.value, None)
        K = features_mod.Kuu(self.feature, self.kern, jitter=self._jitter())
        return gauss_kl(self.q_mu.value, self.q_sqrt.value, K)

    def _conditional_batch(self, X, full_cov=False):
        Kmm = features_mod.Kuu(self.feature, self.kern, jitter=self._jitter())
        Kmn = features_mod.Kuf(self.feature, self.kern, X)
        Knn = self.kern.K(X) if full_cov else self.kern.Kdiag(X)
        fmean, fvar = base_conditional(Kmn, Kmm, Knn, self.q_mu.value, full_cov=full_cov,
                                       q_sqrt=self.q_sqrt.value, white=self.whiten)
        return fmean + self.mean_function(X), fvar

    def build_likelihood_batch(self, Xb, Yb):
        """Minibatch ELBO with the N / B scale (a stochastic training step)."""
        Xb, Yb = as_tensor_like(Xb, self.X), as_tensor_like(Yb, self.X)
        kl = self.prior_kl()
        fmean, fvar = self._conditional_batch(Xb)
        var_exp = self.likelihood.variational_expectations(fmean, fvar, Yb)
        return torch.sum(var_exp) * (self.num_data / Xb.shape[0]) - kl

    def build_likelihood(self):
        """Full-data ELBO."""
        return self.build_likelihood_batch(self.X, self.Y)

    def build_predict(self, Xnew, full_cov=False):
        return self._conditional_batch(as_tensor_like(Xnew, self.X), full_cov=full_cov)

    def q_sqrt_array(self):
        """(P, M, M) lower-triangular covariance factor, whatever q_diag."""
        q = self.q_sqrt.value
        if q.dim() == 2:  # diagonal (M, P)
            return torch.diag_embed(q.T)
        return torch.tril(q)

    def posterior(self):
        """Factor Kuu once (and materialize q) for O(M N*) serving
        predictions."""
        from .posterior import SVGPPosterior

        Luu = linalg.cholesky(features_mod.Kuu(self.feature, self.kern, jitter=self._jitter()))
        return SVGPPosterior(self.kern, self.likelihood, self.mean_function, self.feature, Luu,
                             self.q_mu.value, self.q_sqrt_array(), self.whiten, self.num_latent)
