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

``psi_statistics`` gives the kernel expectations psi0/psi1/psi2 under
q(x) = N(mu, Sigma) (closed form for a plain RBF, in float64 for float32
inputs; tensor-product Gauss-Hermite quadrature otherwise, whose Grams are
``kern.K``), shared by ``uncertain_conditional`` and
``models.BayesianGPLVM``. Where the JAX package calls ``jax.scipy``
directly (the full-Sigma branch's D x D factors and solves,
``uncertain_conditional``'s factor of Kuu and its solves), the port calls
``torch.linalg``; the Grams are ``kern.K``, the cross-Gram kernel on the
kernel route.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .ops import linalg

__all__ = ["base_conditional", "base_conditional_with_lm", "conditional", "feature_conditional",
           "psi_statistics", "uncertain_conditional"]


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


def _chol_solve(L, B):
    # (L L^T)^-1 B with torch.linalg's triangular solves
    return torch.linalg.solve_triangular(L.mT, torch.linalg.solve_triangular(L, B, upper=False), upper=True)


def _rbf_psi_stats(kern, Z, Xmu, Xvar):
    """Closed-form RBF kernel expectations under q(x) = N(Xmu, Sigma), Xvar
    (N, D) diagonal or (N, D, D) full: (psi0 (N,), psi1 (N, M), psi2
    (N, M, M)) with
      psi1_nm = var |Sigma L^-1 + I|^-1/2 exp(-1/2 d^T (Sigma + L)^-1 d),
      psi2_nmm' = var^2 |2 Sigma L^-1 + I|^-1/2
                  exp(-1/4 dz^T L^-1 dz - 1/2 d^T (Sigma + L/2)^-1 d),
    L = diag(lengthscales^2), dz = z_m - z_m', d = mu - z (resp. mu - zbar)."""
    D = Z.shape[1]
    var = torch.squeeze(kern.variance.value).to(Z.dtype)
    ls2 = torch.square(kern.lengthscales.value.to(Z.dtype)).expand(D)
    psi0 = var.expand(Xmu.shape[0])
    Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])  # (M, M, D)
    quad_dZ = -0.25 * torch.sum(torch.square(Z[:, None, :] - Z[None, :, :]) / ls2, dim=-1)  # (M, M)

    if Xvar.dim() == 2:  # diagonal Sigma: elementwise closed forms
        denom1 = Xvar + ls2  # (N, D)
        d1 = torch.square(Xmu[:, None, :] - Z[None, :, :]) / denom1[:, None, :]
        log_det1 = 0.5 * torch.sum(torch.log(Xvar / ls2 + 1.0), dim=-1)
        psi1 = var * torch.exp(-0.5 * torch.sum(d1, dim=-1) - log_det1[:, None])
        denom2 = Xvar[:, None, None, :] + 0.5 * ls2
        dmu = torch.square(Xmu[:, None, None, :] - Zbar[None]) / denom2
        log_det2 = 0.5 * torch.sum(torch.log(2.0 * Xvar / ls2 + 1.0), dim=-1)  # (N,)
        psi2 = torch.square(var) * torch.exp(quad_dZ[None] - 0.5 * torch.sum(dmu, dim=-1)
                                             - log_det2[:, None, None])
        return psi0, psi1, psi2

    # full Sigma (N, D, D): per-n D x D factors and solves, batched over n
    M = Z.shape[0]
    Lam = torch.diag(ls2)
    C1 = torch.linalg.cholesky(Xvar + Lam)  # (N, D, D)
    d = Xmu[:, None, :] - Z[None]  # (N, M, D)
    a = torch.linalg.solve_triangular(C1, d.mT, upper=False)  # (N, D, M)
    quad1 = -0.5 * torch.sum(torch.square(a), dim=1)  # (N, M)
    logdet1 = 2.0 * torch.sum(torch.log(torch.diagonal(C1, dim1=-2, dim2=-1)), dim=-1) - torch.sum(torch.log(ls2))
    psi1 = var * torch.exp(quad1 - 0.5 * logdet1[:, None])
    C2 = torch.linalg.cholesky(Xvar + 0.5 * Lam)
    dmu = (Xmu[:, None, None, :] - Zbar[None]).reshape(Xmu.shape[0], M * M, D)
    b = torch.linalg.solve_triangular(C2, dmu.mT, upper=False)  # (N, D, M^2)
    quad2 = -0.5 * torch.sum(torch.square(b), dim=1).reshape(-1, M, M)
    logdet2 = (2.0 * torch.sum(torch.log(torch.diagonal(C2, dim1=-2, dim2=-1)), dim=-1)
               - torch.sum(torch.log(0.5 * ls2)))
    psi2 = torch.square(var) * torch.exp(quad_dZ[None] + quad2 - 0.5 * logdet2[:, None, None])
    return psi0, psi1, psi2


def _default_psi_gh_points(D: int) -> int:
    """Gauss-Hermite points per dimension of the tensor-product grid, capped
    so that H^D stays <= ~4000 nodes; raises where even H = 2 exceeds it."""
    H = min(20, int(4000.0 ** (1.0 / D)))
    if H < 2:
        raise NotImplementedError(
            f"tensor-product Gauss-Hermite quadrature is intractable for input dimension {D}; pass "
            f"num_gauss_hermite_points explicitly (total cost H**D) or use an RBF kernel (closed-form "
            f"psi-statistics)")
    return H


def _quadrature_psi_stats(kern, Z, Xmu, Xvar, H: int):
    """psi0/psi1/psi2 under q(x) = N(Xmu, Sigma) for any kernel, by
    tensor-product Gauss-Hermite quadrature over the H^D nodes; Xvar (N, D)
    diagonal or (N, D, D) full. All N x H^D nodes go through one
    ``kern.K(nodes, Z)``."""
    from . import quadrature

    N, D = Xmu.shape
    xi, w = quadrature.mvhermgauss(H, D)
    xi = torch.as_tensor(xi, dtype=Xmu.dtype, device=Xmu.device)  # (S, D)
    w = torch.as_tensor(w / np.pi ** (D / 2.0), dtype=Xmu.dtype, device=Xmu.device)  # normalized
    if Xvar.dim() == 2:  # x = mu + sqrt(2 var) xi
        nodes = Xmu[:, None, :] + torch.sqrt(2.0 * Xvar)[:, None, :] * xi[None]
    else:  # x = mu + sqrt(2) L xi
        Ln = torch.linalg.cholesky(Xvar)
        nodes = Xmu[:, None, :] + np.sqrt(2.0) * xi[None] @ Ln.mT
    S = xi.shape[0]
    flat = nodes.reshape(N * S, D)
    psi0 = kern.Kdiag(flat).reshape(N, S) @ w
    Kxz = kern.K(flat, Z).reshape(N, S, -1)  # (N, S, M)
    psi1 = torch.einsum("s,nsm->nm", w, Kxz)
    psi2 = (Kxz * w[None, :, None]).mT @ Kxz  # (N, M, M)
    return psi0, psi1, psi2


def psi_statistics(kern, Z, Xmu, Xvar, *, num_gauss_hermite_points=None):
    """Kernel expectations (psi0 (N,), psi1 (N, M), psi2 (N, M, M)) under
    q(x_n) = N(Xmu_n, Sigma_n): closed form for a plain RBF, Gauss-Hermite
    quadrature for any other kernel."""
    from . import kernels

    if isinstance(kern, kernels.RBF) and kern.active_dims is None:
        if Z.dtype != torch.float32:
            return _rbf_psi_stats(kern, Z, Xmu, Xvar)
        # float32 inputs: the closed forms in float64, the results rounded
        # once. Their exponents in float32 put a BayesianGPLVM's gradients
        # 1e-2 off float64 at cond(Kuu) ~1e5 (example 08's data, N=2048,
        # M=64), on every route: Kuu^-1 amplifies psi2's relative error
        # (chip_smoke.py phase 4h)
        return tuple(t.float() for t in _rbf_psi_stats(kern, Z.double(), Xmu.double(), Xvar.double()))
    H = num_gauss_hermite_points or _default_psi_gh_points(Z.shape[1])
    return _quadrature_psi_stats(kern, Z, Xmu, Xvar, H)


def uncertain_conditional(Xnew_mu, Xnew_var, feat, kern, q_mu, q_sqrt, *, mean_function=None, white=False,
                          num_gauss_hermite_points=None):
    """Predictive moments of f* when the input is uncertain: x* ~ N(Xnew_mu,
    Sigma), Sigma diagonal (Xnew_var (N, D)) or full (N, D, D), by moment
    matching with the psi-statistics (closed forms for an RBF kernel,
    Gauss-Hermite quadrature otherwise). q_sqrt (M, P) diagonal or (P, M, M)
    lower. Returns (mean (N, P), var (N, P))."""
    from . import features

    if not isinstance(feat, features.InducingPoints):
        raise NotImplementedError("uncertain_conditional requires InducingPoints")
    if mean_function is not None:
        raise NotImplementedError("uncertain_conditional supports Zero mean only")
    Z = feat.Z.value
    M = Z.shape[0]
    jitter = config.default_jitter(Z.dtype)
    Luu = torch.linalg.cholesky(kern.K(Z) + jitter * torch.eye(M, dtype=Z.dtype, device=Z.device))

    # q(u) in unwhitened u-space
    Sq = torch.diag_embed(q_sqrt.T) if q_sqrt.dim() == 2 else torch.tril(q_sqrt)  # (P, M, M)
    if white:
        mu_u = Luu @ q_mu
        Lq_u = Luu @ Sq
    else:
        mu_u, Lq_u = q_mu, Sq
    cov_u = Lq_u @ Lq_u.mT  # (P, M, M)

    psi0, psi1, psi2 = psi_statistics(kern, Z, Xnew_mu, Xnew_var,
                                      num_gauss_hermite_points=num_gauss_hermite_points)
    mean = psi1 @ _chol_solve(Luu, mu_u)  # (N, P)
    # tr(Kuu^-1 psi2[n])
    kinv_psi2_tr = torch.diagonal(_chol_solve(Luu, psi2), dim1=-2, dim2=-1).sum(-1)  # (N,)
    # B_p = Kuu^-1 (mu_p mu_p^T + cov_p) Kuu^-1; tr(B_p psi2[n])
    Mmat = mu_u.T[:, :, None] * mu_u.T[:, None, :] + cov_u
    B = _chol_solve(Luu, _chol_solve(Luu, Mmat).mT).mT
    tr_B_psi2 = torch.einsum("pij,nij->np", B, psi2)
    var = psi0[:, None] - kinv_psi2_tr[:, None] + tr_B_psi2 - torch.square(mean)
    return mean, var
