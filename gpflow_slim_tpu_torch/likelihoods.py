"""Likelihoods (counterpart of ``gpflow_slim_tpu.likelihoods``).

This slice ports the base class and the analytic ``Gaussian``; the
quadrature likelihoods come with the models that need them.
"""

from __future__ import annotations

import math

import torch

from . import config, densities
from .params import Module, Param
from .transforms import positive

__all__ = ["Likelihood", "Gaussian"]


class Likelihood(Module):
    def __init__(self, name="likelihood"):
        super().__init__()
        self.name = name
        self.num_gauss_hermite_points = config.settings().num_gauss_hermite_points

    def logp(self, F, Y):
        raise NotImplementedError

    def conditional_mean(self, F):
        raise NotImplementedError

    def conditional_variance(self, F):
        raise NotImplementedError


class Gaussian(Likelihood):
    def __init__(self, variance=1.0, name="gaussian_likelihood"):
        super().__init__(name=name)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")

    def logp(self, F, Y):
        return densities.gaussian(Y, F, self.variance.value)

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        return torch.squeeze(self.variance.value).expand(F.shape).to(F.dtype)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance.value

    def predict_density(self, Fmu, Fvar, Y):
        return densities.gaussian(Y, Fmu, Fvar + self.variance.value)

    def variational_expectations(self, Fmu, Fvar, Y):
        v = self.variance.value
        return (
            -0.5 * math.log(2.0 * math.pi)
            - 0.5 * torch.log(v)
            - 0.5 * (torch.square(Y - Fmu) + Fvar) / v
        )
