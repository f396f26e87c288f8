"""Sparse GP regression: SGPR and GPRFITC (counterpart of
``gpflow_slim_tpu.models.sgpr``).

SGPR is Titsias's (2009) collapsed variational bound in the
``A = L^-1 Kuf / sigma``, ``B = I + A A^T`` factorization, with the
Titsias upper bound (``compute_upper_bound``); GPRFITC is the
Snelson-Ghahramani FITC approximation with the diagonal correction
``nu = diag(Kff - Qff) + sigma^2``. Both are O(N M^2).

Every factor and triangular solve goes through ``ops.linalg``: on CUDA
float32 tensors the factor-only Cholesky (chol(Kuu) and chol(B), M x M
padded to a multiple of 64) and the wide TRSM (``L^-1 Kuf`` at P = N on the
wide schedule, the P = 1 solves on the thin one, FITC's upper solve on the
factor's transposed view). ``Kuu``, ``Kuf`` and ``Kus`` are ``kern.K``, on
which a fused-map kernel (or such a child of a ``Sum``) runs the cross-Gram
kernel. The products are ``torch.matmul``, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import math

import torch

from .. import config
from .. import features as features_mod
from ..likelihoods import Gaussian
from ..ops import linalg
from ..utils.trace import named_scope
from .model import GPModel, as_tensor_like


class SGPRUpperMixin:
    """Titsias's upper bound on the log marginal likelihood, for
    sandwiching it: ELBO <= log Z <= upper bound."""

    def compute_upper_bound(self):
        num_data = self.X.shape[0]
        M = len(self.feature)
        jitter = config.default_jitter(self.X.dtype)
        sigma_sq = torch.squeeze(self.likelihood.variance.value)

        Kdiag = self.kern.Kdiag(self.X)
        Kuu = features_mod.Kuu(self.feature, self.kern, jitter=jitter)
        Kuf = features_mod.Kuf(self.feature, self.kern, self.X)

        I = torch.eye(M, dtype=self.X.dtype, device=self.X.device)  # noqa: E741
        L = linalg.cholesky(Kuu)
        A = linalg.solve_lower(L, Kuf)
        AAT = A @ A.T
        LB = linalg.cholesky(I + AAT / sigma_sq)

        # the trace bound on the residual's eigenvalues
        c = torch.sum(Kdiag) - torch.diagonal(AAT).sum()
        corrected_noise = sigma_sq + c

        const = -0.5 * num_data * torch.log(2.0 * math.pi * sigma_sq)
        logdet = -torch.sum(torch.log(torch.diagonal(LB)))

        LC = linalg.cholesky(I + AAT / corrected_noise)
        err = self.Y - self.mean_function(self.X)
        v = linalg.solve_lower(LC, (A @ err) / corrected_noise)
        quad = -0.5 * torch.sum(torch.square(err)) / corrected_noise + 0.5 * torch.sum(torch.square(v))
        return const + logdet + quad


class SGPR(GPModel, SGPRUpperMixin):
    """Titsias's collapsed variational sparse GP regression."""

    def __init__(self, X, Y, kern, feat=None, Z=None, mean_function=None, name="sgpr", device=None,
                 dtype=None):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name, device=device, dtype=dtype)
        self.feature = features_mod.inducingpoint_wrapper(feat, Z)
        self.to(device=self.X.device, dtype=self.X.dtype)

    def _common_factors(self):
        jitter = config.default_jitter(self.X.dtype)
        num_data = self.X.shape[0]
        sigma = torch.sqrt(torch.squeeze(self.likelihood.variance.value))

        err = self.Y - self.mean_function(self.X)  # (N, P)
        Kuf = features_mod.Kuf(self.feature, self.kern, self.X)  # (M, N)
        Kuu = features_mod.Kuu(self.feature, self.kern, jitter=jitter)
        L = linalg.cholesky(Kuu)

        A = linalg.solve_lower(L, Kuf) / sigma  # (M, N)
        AAT = A @ A.T
        B = AAT + torch.eye(AAT.shape[0], dtype=AAT.dtype, device=AAT.device)
        LB = linalg.cholesky(B)
        c = linalg.solve_lower(LB, A @ err) / sigma  # (M, P)
        return err, L, A, AAT, LB, c, sigma, num_data

    def build_likelihood(self):
        """The collapsed bound (SURVEY App. A's formula)."""
        with named_scope("gfs.sgpr.likelihood"):
            err, L, A, AAT, LB, c, sigma, num_data = self._common_factors()
            output_dim = self.num_latent
            sigma_sq = torch.square(sigma)

            bound = -0.5 * num_data * output_dim * math.log(2.0 * math.pi)
            bound = bound - output_dim * torch.sum(torch.log(torch.diagonal(LB)))
            bound = bound - 0.5 * num_data * output_dim * torch.log(sigma_sq)
            bound = bound - 0.5 * torch.sum(torch.square(err)) / sigma_sq
            bound = bound + 0.5 * torch.sum(torch.square(c))
            # diagonal().sum(), not torch.trace: trace's backward fills its
            # gradient in with index_fill_, which reads the value to the host
            # and so waits for the card once a step
            bound = bound - 0.5 * output_dim * (torch.sum(self.kern.Kdiag(self.X)) / sigma_sq
                                                - torch.diagonal(AAT).sum())
            return bound

    def posterior(self):
        """Factor once (L, LB, c) for O(M N*) serving predictions."""
        from .posterior import SGPRPosterior

        _, L, _, _, LB, c, _, _ = self._common_factors()
        return SGPRPosterior(self.kern, self.likelihood, self.mean_function, self.feature, L, LB, c,
                             self.num_latent)

    def build_predict(self, Xnew, full_cov=False):
        """The same arithmetic as the JAX package's: the factors, then the
        posterior's prediction from them."""
        return self.posterior().predict_f(Xnew, full_cov=full_cov)


class GPRFITC(GPModel):
    """FITC sparse regression (Snelson and Ghahramani 2006)."""

    def __init__(self, X, Y, kern, feat=None, Z=None, mean_function=None, name="gprfitc", device=None,
                 dtype=None):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name, device=device, dtype=dtype)
        self.feature = features_mod.inducingpoint_wrapper(feat, Z)
        self.to(device=self.X.device, dtype=self.X.dtype)

    def _common_terms(self):
        jitter = config.default_jitter(self.X.dtype)
        sigma_sq = torch.squeeze(self.likelihood.variance.value)
        M = len(self.feature)

        err = self.Y - self.mean_function(self.X)
        Kdiag = self.kern.Kdiag(self.X)
        Kuf = features_mod.Kuf(self.feature, self.kern, self.X)
        Kuu = features_mod.Kuu(self.feature, self.kern, jitter=jitter)

        Luu = linalg.cholesky(Kuu)
        V = linalg.solve_lower(Luu, Kuf)  # (M, N)

        g = Kdiag - torch.sum(torch.square(V), dim=0)  # diag(Kff - Qff)
        nu = g + sigma_sq  # (N,)

        beta = err / nu[:, None]  # (N, P)
        alpha = V @ beta  # (M, P)
        B = torch.eye(M, dtype=V.dtype, device=V.device) + (V / nu[None, :]) @ V.T
        L = linalg.cholesky(B)
        gamma = linalg.solve_lower(L, alpha)  # (M, P)
        return err, nu, Luu, L, alpha, beta, gamma

    def build_likelihood(self):
        with named_scope("gfs.gprfitc.likelihood"):
            err, nu, _, L, _, _, gamma = self._common_terms()
            num_data = self.X.shape[0]
            mahalanobis = -0.5 * torch.sum(torch.square(err) / nu[:, None]) + 0.5 * torch.sum(torch.square(gamma))
            constant = -0.5 * num_data * math.log(2.0 * math.pi)
            logdet = -0.5 * torch.sum(torch.log(nu)) - torch.sum(torch.log(torch.diagonal(L)))
            return mahalanobis + self.num_latent * (constant + logdet)

    def build_predict(self, Xnew, full_cov=False):
        Xnew = as_tensor_like(Xnew, self.X)
        _, _, Luu, L, _, _, gamma = self._common_terms()
        Kus = features_mod.Kuf(self.feature, self.kern, Xnew)
        w = linalg.solve_lower(Luu, Kus)  # (M, N*)
        tmp = linalg.solve_upper(L.T, gamma)  # the factor's transposed view, read in place
        mean = w.T @ tmp + self.mean_function(Xnew)
        intermediateA = linalg.solve_lower(L, w)
        if full_cov:
            var = self.kern.K(Xnew) - w.T @ w + intermediateA.T @ intermediateA
            return mean, var[None, :, :].expand(self.num_latent, -1, -1)  # (P, N*, N*)
        var = self.kern.Kdiag(Xnew) - torch.sum(torch.square(w), dim=0) \
            + torch.sum(torch.square(intermediateA), dim=0)
        return mean, var[:, None].expand(-1, self.num_latent)  # (N*, P)
