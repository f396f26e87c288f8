"""Scalar log-densities (counterpart of ``gpflow_slim_tpu.densities``).

Elementwise log-pdfs that broadcast; the prior hyperparameters may be plain
floats, which are lifted to tensors of the argument's dtype and device.
``multivariate_normal`` is the total log-pdf given a Cholesky factor; its
solve is ``torch.linalg``'s, as the JAX package's is ``jax.scipy``'s.
"""

from __future__ import annotations

import math

import torch

__all__ = ["gaussian", "bernoulli", "lognormal", "poisson", "exponential", "gamma", "student_t", "beta",
           "laplace", "multivariate_normal"]


def _like(v, x):
    if isinstance(v, torch.Tensor):
        return v.to(dtype=x.dtype, device=x.device)
    # a fill on the device, not a copy from the host: a copy to the card
    # from pageable memory syncs the host, in every prior's logp
    return torch.full((), v, dtype=x.dtype, device=x.device)


def gaussian(x, mu, var):
    var = _like(var, x)
    return -0.5 * torch.log(2.0 * math.pi * var) - 0.5 * torch.square(x - mu) / var


def bernoulli(p, y):
    return torch.log(torch.where(y == 1, p, 1.0 - p))


def lognormal(x, mu, var):
    lnx = torch.log(x)
    return gaussian(lnx, mu, var) - lnx


def poisson(lamb, y):
    return y * torch.log(lamb) - lamb - torch.special.gammaln(y + 1.0)


def exponential(lamb, y):
    """The exponential of mean ``lamb`` (rate ``1 / lamb``), as the reference
    parameterizes it."""
    return -y / lamb - torch.log(lamb)


def gamma(shape, scale, x):
    shape, scale = _like(shape, x), _like(scale, x)
    return (
        -shape * torch.log(scale)
        - torch.lgamma(shape)
        + (shape - 1.0) * torch.log(x)
        - x / scale
    )


def student_t(x, mean, scale, df):
    df = _like(df, x)
    const = (
        torch.lgamma((df + 1.0) * 0.5)
        - torch.lgamma(df * 0.5)
        - 0.5 * (torch.log(torch.square(scale)) + torch.log(df) + math.log(math.pi))
    )
    return const - 0.5 * (df + 1.0) * torch.log1p((1.0 / df) * torch.square((x - mean) / scale))


def beta(alpha, bet, y):
    alpha, bet = _like(alpha, y), _like(bet, y)
    betaln = torch.lgamma(alpha) + torch.lgamma(bet) - torch.lgamma(alpha + bet)
    return (alpha - 1.0) * torch.log(y) + (bet - 1.0) * torch.log1p(-y) - betaln


def laplace(mu, sigma, y):
    sigma = _like(sigma, y)
    return -torch.abs(mu - y) / sigma - torch.log(2.0 * sigma)


def multivariate_normal(x, mu, L):
    """Total MVN log-pdf of the column(s) of ``x`` given the mean ``mu`` and
    the lower Cholesky factor ``L`` of the covariance: x, mu (N,) or (N, P),
    L (N, N). The sum over the P columns of
    ``-N/2 log 2 pi - sum log diag L - 1/2 ||L^-1 (x - mu)||^2``."""
    d = x - mu
    if d.dim() == 1:
        d = d[:, None]
    alpha = torch.linalg.solve_triangular(L, d, upper=False)
    num_dims, num_col = d.shape
    return (-0.5 * num_dims * num_col * math.log(2.0 * math.pi)
            - num_col * torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * torch.sum(torch.square(alpha)))
