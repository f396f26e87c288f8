"""Full-data variational GPs for non-conjugate likelihoods (counterpart of
``gpflow_slim_tpu.models.vgp``).

``VGP``: the whitened q(v) = N(q_mu, q_sqrt q_sqrt^T), f = L v + m(X) with
L = chol(K(X) + jitter I). ELBO = sum of the variational expectations -
KL[q(v) || N(0, I)]. On the kernel route (CUDA float32) K is the lower-tile
Gram kernel and L the factor-only Cholesky, whose backward solves on the
wide TRSM; predictions go through ``conditionals.conditional`` (cross Gram,
factor, TRSM).

``VGPOpperArchambeau``: Opper & Archambeau (2009), q(f) = N(K alpha,
(K^-1 + diag(lambda^2))^-1), 2 N P variational parameters. K is the cross
Gram kernel and A_p = I + lambda_p lambda_p^T o K is factored once per
output by the factor-only Cholesky. Its solves against the identity and
against lambda o K(X, X*) are ``torch.linalg.solve_triangular`` calls, as
the JAX package makes them with ``jax.scipy`` outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..conditionals import conditional
from ..kullback_leiblers import gauss_kl
from ..ops import linalg
from ..params import Param
from ..transforms import LowerTriangular, positive
from .model import GPModel, as_tensor_like


class VGP(GPModel):
    def __init__(self, X, Y, kern, likelihood, mean_function=None, num_latent=None, name="vgp", device=None,
                 dtype=None):
        super().__init__(X, Y, kern, likelihood, mean_function, num_latent=num_latent, name=name, device=device,
                         dtype=dtype)
        N = self.num_data = int(self.X.shape[0])
        P = self.num_latent
        self.q_mu = Param(np.zeros((N, P)), name=f"{name}/q_mu")
        init = np.tile(np.eye(N)[None], (P, 1, 1))
        self.q_sqrt = Param(init, transform=LowerTriangular(N, num_matrices=P), name=f"{name}/q_sqrt")
        self.to(device=self.X.device, dtype=self.X.dtype)

    def build_likelihood(self):
        kl = gauss_kl(self.q_mu.value, self.q_sqrt.value, None)

        # K_lower: the factorization reads only the lower triangle
        N = self.num_data
        jitter = config.default_jitter(self.X.dtype)
        K = self.kern.K_lower(self.X) + jitter * torch.eye(N, dtype=self.X.dtype, device=self.X.device)
        L = linalg.cholesky(K)  # lower, its strictly-upper part zero
        fmean = L @ self.q_mu.value + self.mean_function(self.X)  # (N, P)

        LSq = L @ torch.tril(self.q_sqrt.value)  # (P, N, N), one batched product
        fvar = torch.sum(torch.square(LSq), dim=2).T  # (N, P)

        var_exp = self.likelihood.variational_expectations(fmean, fvar, self.Y)
        return torch.sum(var_exp) - kl

    def build_predict(self, Xnew, full_cov=False):
        Xnew = as_tensor_like(Xnew, self.X)
        mu, var = conditional(Xnew, self.X, self.kern, self.q_mu.value, full_cov=full_cov,
                              q_sqrt=self.q_sqrt.value, white=True)
        return mu + self.mean_function(Xnew), var


class VGPOpperArchambeau(GPModel):
    """The Opper-Archambeau parameterization of the full variational GP (the
    reference lineage's ``VGP_opper_archambeau``): q(f) = N(K alpha,
    [K^-1 + diag(lambda^2)]^-1), whose form the optimal posterior has."""

    def __init__(self, X, Y, kern, likelihood, mean_function=None, num_latent=None, name="vgp_oa",
                 device=None, dtype=None):
        super().__init__(X, Y, kern, likelihood, mean_function, num_latent=num_latent, name=name, device=device,
                         dtype=dtype)
        N = self.num_data = int(self.X.shape[0])
        P = self.num_latent
        self.q_alpha = Param(np.zeros((N, P)), name=f"{name}/q_alpha")
        self.q_lambda = Param(np.ones((N, P)), transform=positive(), name=f"{name}/q_lambda")
        self.to(device=self.X.device, dtype=self.X.dtype)

    def _A_chol(self):
        """K, lambda (P, N) and the factors of A_p = I + lambda_p lambda_p^T o K
        (P, N, N), one factor-only Cholesky per output (``torch.func.vmap``
        of ``ops.linalg.cholesky``: its vmap rule launches the kernel once
        per output, as ``jax.vmap`` maps it in the JAX package)."""
        N = self.num_data
        K = self.kern.K(self.X)
        lam = self.q_lambda.value.T  # (P, N)
        A = torch.eye(N, dtype=K.dtype, device=K.device) + lam[:, None, :] * lam[:, :, None] * K
        L = torch.func.vmap(linalg.cholesky)(A)
        return K, lam, L

    def build_likelihood(self):
        N, P = self.num_data, self.num_latent
        K, lam, L = self._A_chol()
        K_alpha = K @ self.q_alpha.value  # (N, P)
        f_mean = K_alpha + self.mean_function(self.X)

        # A_p^-1's factor against the identity: torch.linalg, as the JAX
        # package's jax.scipy solve_triangular
        eye = torch.eye(N, dtype=K.dtype, device=K.device)
        Li = torch.linalg.solve_triangular(L, eye.expand(P, N, N), upper=False)  # (P, N, N)
        tmp = Li / lam[:, None, :]  # the columns divided by lambda
        f_var = (1.0 / torch.square(lam) - torch.sum(torch.square(tmp), dim=1)).T  # (N, P)

        A_logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))
        trAi = torch.sum(torch.square(Li))
        KL = 0.5 * (A_logdet + trAi - N * P + torch.sum(K_alpha * self.q_alpha.value))
        v_exp = self.likelihood.variational_expectations(f_mean, f_var, self.Y)
        return torch.sum(v_exp) - KL

    def build_predict(self, Xnew, full_cov=False):
        Xnew = as_tensor_like(Xnew, self.X)
        _, lam, L = self._A_chol()
        Kx = self.kern.K(self.X, Xnew)  # (N, N*)
        f_mean = Kx.T @ self.q_alpha.value + self.mean_function(Xnew)
        # var = K** - Kx^T (K + diag(lambda^-2))^-1 Kx per output, from A's
        # factor: tmp = L^-1 (lambda o Kx), by torch.linalg as JAX's jax.scipy
        lamKx = lam[:, :, None] * Kx[None, :, :]  # (P, N, N*)
        tmp = torch.linalg.solve_triangular(L, lamKx, upper=False)  # (P, N, N*)
        if full_cov:
            return f_mean, self.kern.K(Xnew)[None] - tmp.mT @ tmp  # (P, N*, N*)
        var = self.kern.Kdiag(Xnew)[None, :] - torch.sum(torch.square(tmp), dim=1)  # (P, N*)
        return f_mean, var.T
