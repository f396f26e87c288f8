"""GP latent-variable models: GPLVM and BayesianGPLVM (counterpart of
``gpflow_slim_tpu.models.gplvm``).

``GPLVM`` is exact GPR with the inputs X a trainable ``Param`` (MAP latent
positions, PCA-initialized): ``K_lower(X) + noise I`` factored through
``ops.linalg.cholesky`` (on the kernel route the lower-tile Gram and the
factor-only Cholesky) and ``densities.multivariate_normal``, whose solve is
``torch.linalg``'s as the JAX package's is ``jax.scipy``'s.
``BayesianGPLVM`` is the Titsias-Lawrence variational model: q(X) =
prod_n N(x_n; mu_n, diag s_n) and the collapsed bound from the kernel
expectations psi0/psi1/psi2 (``conditionals.psi_statistics``), the SGPR
factorization with (psi1, sum psi2) in place of (Kuf, Kuf Kuf^T): Kuu by
``kern.K`` (the cross Gram), its factor and B's by ``ops.linalg.cholesky``,
the solves by the TRSM (``ops.linalg``), a float32 model's solves against
Kuu's factor refined on float64 residuals on either route.

Both models hold Y as a buffer and are placed, with their parameters, on
CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config, densities
from .. import features as features_mod
from ..conditionals import psi_statistics
from ..likelihoods import Gaussian
from ..mean_functions import Zero
from ..ops import linalg
from ..params import Param
from ..transforms import positive
from .model import GPModel, Model, _data_dtype, as_tensor_like

__all__ = ["GPLVM", "BayesianGPLVM", "pca_reduce"]


def pca_reduce(Y, latent_dim: int):
    """PCA projection of Y (N, P) onto its top ``latent_dim`` principal
    components: the standard GPLVM latent initialization (numpy float64)."""
    Y = np.asarray(Y, dtype=np.float64)
    if latent_dim > Y.shape[1]:
        raise ValueError("latent_dim must be <= output dimension")
    evals, evecs = np.linalg.eigh(np.cov(Y.T).reshape(Y.shape[1], Y.shape[1]))
    idx = np.argsort(evals)[::-1][:latent_dim]
    return (Y - Y.mean(0)) @ evecs[:, idx]


def _place(model, Y, device, dtype):
    """Y as a rank-2 buffer of ``model`` on ``device`` (CUDA unless given)
    in ``dtype`` (Y's float dtype unless given); returns (device, dtype)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to build the model on the CPU')
        device = "cuda"
    dtype = dtype if dtype is not None else _data_dtype(Y)
    Y = torch.as_tensor(Y, dtype=dtype, device=device)
    if Y.dim() != 2:
        raise ValueError(f"Y must be rank-2 (N, P); got {tuple(Y.shape)}")
    model.register_buffer("Y", Y)
    return Y.device, dtype


class GPLVM(GPModel):
    """MAP GP-LVM: the exact GPR marginal likelihood with trainable latents
    ``X`` (a ``Param``); everything else is the GPR math at X = X.value."""

    def __init__(self, Y, latent_dim, X_mean=None, kern=None, mean_function=None, name="gplvm",
                 device=None, dtype=None):
        from ..kernels import RBF

        Model.__init__(self, name=name)
        device, dtype = _place(self, Y, device, dtype)
        if X_mean is None:
            X_mean = pca_reduce(self.Y.cpu().numpy(), latent_dim)
        X_mean = np.asarray(X_mean, dtype=np.float64)
        if X_mean.shape != (self.Y.shape[0], latent_dim):
            raise ValueError(f"X_mean must be (N, latent_dim) = {(self.Y.shape[0], latent_dim)}; "
                             f"got {X_mean.shape}")
        self.kern = kern if kern is not None else RBF(latent_dim, ARD=True, name=f"{name}/kern")
        self.likelihood = Gaussian(name=f"{name}/likelihood")
        self.mean_function = mean_function if mean_function is not None else Zero()
        self.num_latent = int(self.Y.shape[1])
        self.latent_dim = int(latent_dim)
        self.X = Param(X_mean, name=f"{name}/X")
        self.to(device=device, dtype=dtype)

    def _K_chol(self):
        # K_lower: the factorization reads only the lower triangle; the noise
        # goes onto the diagonal in place, as in GPR
        K = self.kern.K_lower(self.X.value)
        K.diagonal().add_(torch.squeeze(self.likelihood.variance.value))
        return linalg.cholesky(K)

    def build_likelihood(self):
        L = self._K_chol()
        return densities.multivariate_normal(self.Y, self.mean_function(self.X.value), L)

    def build_predict(self, Xnew, full_cov=False):
        X = self.X.value
        Xnew = as_tensor_like(Xnew, X)
        Kx = self.kern.K(X, Xnew)
        L = self._K_chol()
        A = linalg.solve_lower(L, Kx)
        V = linalg.solve_lower(L, self.Y - self.mean_function(X))
        fmean = A.T @ V + self.mean_function(Xnew)
        if full_cov:
            fvar = self.kern.K(Xnew) - A.T @ A
            return fmean, fvar[None, :, :].expand(self.num_latent, -1, -1)
        fvar = self.kern.Kdiag(Xnew) - torch.sum(torch.square(A), dim=0)
        return fmean, fvar[:, None].expand(-1, self.num_latent)


class BayesianGPLVM(GPModel):
    """Variational Bayesian GP-LVM (Titsias & Lawrence 2010).

    q(X) = prod_n N(x_n; X_mean_n, diag X_var_n), M inducing points, and the
    collapsed bound from the psi-statistics:

        ELBO = -ND/2 log 2 pi - D/2 logdet B - ND/2 log s2 - ||Y||^2 / 2 s2
               + ||c||^2 / 2 - D/2 (psi0 / s2 - tr(A A^T)) - KL[q(X) || p(X)]

    with A = L^-1 psi1^T / s, A A^T = L^-1 (sum_n psi2_n) L^-T / s2,
    B = A A^T + I, LB = chol B, c = LB^-1 A Y / s.
    """

    def __init__(self, X_mean, X_var, Y, kern, M=None, Z=None, X_prior_mean=None, X_prior_var=None,
                 name="bgplvm", device=None, dtype=None):
        X_mean = np.asarray(X_mean, dtype=np.float64)
        X_var = np.asarray(X_var, dtype=np.float64)
        if X_mean.shape != X_var.shape:
            raise ValueError("X_mean and X_var must have the same (N, Q) shape")
        if X_mean.shape[0] != np.shape(Y)[0]:
            raise ValueError("X_mean and Y must agree on N")
        N, Q = X_mean.shape
        if Z is None:
            if M is None:
                raise ValueError("provide either Z (M, Q) or M (int)")
            Z = X_mean[np.random.RandomState(0).permutation(N)[:M]].copy()
        Z = np.asarray(Z, dtype=np.float64)

        Model.__init__(self, name=name)
        device, dtype = _place(self, Y, device, dtype)
        self.kern = kern
        self.likelihood = Gaussian(name=f"{name}/likelihood")
        self.mean_function = Zero()
        self.num_latent = int(self.Y.shape[1])
        self.latent_dim = Q
        self.X_mean = Param(X_mean, name=f"{name}/X_mean")
        self.X_var = Param(X_var, transform=positive(), name=f"{name}/X_var")
        self.feature = features_mod.InducingPoints(Z, name=f"{name}/Z")
        self.register_buffer("X_prior_mean", torch.as_tensor(
            np.zeros((N, Q)) if X_prior_mean is None else X_prior_mean, dtype=torch.float64))
        self.register_buffer("X_prior_var", torch.as_tensor(
            np.ones((N, Q)) if X_prior_var is None else X_prior_var, dtype=torch.float64))
        self.to(device=device, dtype=dtype)

    def _common_factors(self):
        sigma_sq = torch.squeeze(self.likelihood.variance.value)
        sigma = torch.sqrt(sigma_sq)
        Z = self.feature.Z.value
        M = Z.shape[0]
        psi0, psi1, psi2 = psi_statistics(self.kern, Z, self.X_mean.value, self.X_var.value)
        Psi2 = torch.sum(psi2, dim=0)  # (M, M)
        Kuu = features_mod.Kuu(self.feature, self.kern, jitter=config.default_jitter(Z.dtype))
        L = linalg.cholesky(Kuu)
        # Kuu's float32 solves refined (ops.linalg says why)
        A = linalg.solve_lower_refined(L, psi1.T) / sigma  # (M, N)
        tmp = linalg.solve_lower_refined(L, Psi2)
        AAT = linalg.solve_lower_refined(L, tmp.T) / sigma_sq  # L^-1 Psi2 L^-T / s2
        B = AAT + torch.eye(M, dtype=AAT.dtype, device=AAT.device)
        LB = linalg.cholesky(B)
        c = linalg.solve_lower(LB, A @ self.Y) / sigma  # (M, P)
        return torch.sum(psi0), AAT, L, LB, c, sigma, sigma_sq

    def kl_latents(self):
        """KL[q(X) || p(X)] of the factorized Gaussians."""
        Xmu, Xvar = self.X_mean.value, self.X_var.value
        return (-0.5 * Xmu.numel()
                + 0.5 * torch.sum(torch.log(self.X_prior_var))
                - 0.5 * torch.sum(torch.log(Xvar))
                + 0.5 * torch.sum((torch.square(Xmu - self.X_prior_mean) + Xvar) / self.X_prior_var))

    def build_likelihood(self):
        psi0_sum, AAT, L, LB, c, sigma, sigma_sq = self._common_factors()
        N = self.Y.shape[0]
        D = self.num_latent
        ND = N * D
        bound = (-0.5 * ND * math.log(2.0 * math.pi)
                 - D * torch.sum(torch.log(torch.diagonal(LB)))
                 - 0.5 * ND * torch.log(sigma_sq)
                 - 0.5 * torch.sum(torch.square(self.Y)) / sigma_sq
                 + 0.5 * torch.sum(torch.square(c))
                 - 0.5 * D * (psi0_sum / sigma_sq - torch.trace(AAT)))
        return bound - self.kl_latents()

    def build_predict(self, Xnew, full_cov=False):
        _, _, L, LB, c, _, _ = self._common_factors()
        Xnew = as_tensor_like(Xnew, self.Y)
        Kus = features_mod.Kuf(self.feature, self.kern, Xnew)  # (M, N*)
        tmp1 = linalg.solve_lower_refined(L, Kus)
        tmp2 = linalg.solve_lower(LB, tmp1)
        fmean = tmp2.T @ c  # (N*, P)
        if full_cov:
            fvar = self.kern.K(Xnew) + tmp2.T @ tmp2 - tmp1.T @ tmp1
            return fmean, fvar[None, :, :].expand(self.num_latent, -1, -1)
        fvar = (self.kern.Kdiag(Xnew) + torch.sum(torch.square(tmp2), dim=0)
                - torch.sum(torch.square(tmp1), dim=0))
        return fmean, fvar[:, None].expand(-1, self.num_latent)
