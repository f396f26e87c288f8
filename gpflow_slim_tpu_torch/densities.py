"""Scalar log-densities (counterpart of ``gpflow_slim_tpu.densities``).

Elementwise log-pdfs that broadcast; the prior hyperparameters may be plain
floats, which are lifted to tensors of the argument's dtype and device.
The remaining densities and ``multivariate_normal`` come with the models
that use them.
"""

from __future__ import annotations

import math

import torch

__all__ = ["gaussian", "bernoulli", "lognormal", "gamma", "beta", "laplace"]


def _like(v, x):
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def gaussian(x, mu, var):
    var = _like(var, x)
    return -0.5 * torch.log(2.0 * math.pi * var) - 0.5 * torch.square(x - mu) / var


def bernoulli(p, y):
    return torch.log(torch.where(y == 1, p, 1.0 - p))


def lognormal(x, mu, var):
    lnx = torch.log(x)
    return gaussian(lnx, mu, var) - lnx


def gamma(shape, scale, x):
    shape, scale = _like(shape, x), _like(scale, x)
    return (
        -shape * torch.log(scale)
        - torch.lgamma(shape)
        + (shape - 1.0) * torch.log(x)
        - x / scale
    )


def beta(alpha, bet, y):
    alpha, bet = _like(alpha, y), _like(bet, y)
    betaln = torch.lgamma(alpha) + torch.lgamma(bet) - torch.lgamma(alpha + bet)
    return (alpha - 1.0) * torch.log(y) + (bet - 1.0) * torch.log1p(-y) - betaln


def laplace(mu, sigma, y):
    sigma = _like(sigma, y)
    return -torch.abs(mu - y) / sigma - torch.log(2.0 * sigma)
