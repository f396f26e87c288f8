"""Likelihoods (counterpart of ``gpflow_slim_tpu.likelihoods``).

The base class computes ``predict_mean_and_var``, ``predict_density`` and
``variational_expectations`` by Gauss-Hermite quadrature (20 points by
default), with closed forms where the reference has them. Ported so far:
``Gaussian`` and ``Bernoulli`` (with the reference's probit link and its
``(1 - 2e-3) + 1e-3`` clamp); the other likelihoods come with the models
that need them.
"""

from __future__ import annotations

import math

import torch

from . import config, densities
from .quadrature import ndiagquad
from .params import Module, Param
from .transforms import positive

__all__ = ["Likelihood", "Gaussian", "Bernoulli", "probit"]


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

    # -- quadrature defaults ------------------------------------------------
    def predict_mean_and_var(self, Fmu, Fvar):
        def integrand2(f):
            return self.conditional_variance(f) + torch.square(self.conditional_mean(f))

        E_y, E_y2 = ndiagquad([self.conditional_mean, integrand2], self.num_gauss_hermite_points,
                              Fmu, Fvar)
        return E_y, E_y2 - torch.square(E_y)

    def predict_density(self, Fmu, Fvar, Y):
        return ndiagquad(self.logp, self.num_gauss_hermite_points, Fmu, Fvar, logspace=True, Y=Y)

    def variational_expectations(self, Fmu, Fvar, Y):
        return ndiagquad(self.logp, self.num_gauss_hermite_points, Fmu, Fvar, Y=Y)


def probit(x):
    """The reference's probit link, with its 1e-3 clamp."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))) * (1 - 2e-3) + 1e-3


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


class Bernoulli(Likelihood):
    def __init__(self, invlink=probit, name="bernoulli_likelihood"):
        super().__init__(name=name)
        self.invlink = invlink

    def logp(self, F, Y):
        return densities.bernoulli(self.invlink(F), Y)

    def conditional_mean(self, F):
        return self.invlink(F)

    def conditional_variance(self, F):
        p = self.invlink(F)
        return p - torch.square(p)

    def predict_mean_and_var(self, Fmu, Fvar):
        if self.invlink is probit:
            p = probit(Fmu / torch.sqrt(1.0 + Fvar))
            return p, p - torch.square(p)
        return super().predict_mean_and_var(Fmu, Fvar)

    def predict_density(self, Fmu, Fvar, Y):
        p = self.predict_mean_and_var(Fmu, Fvar)[0]
        return densities.bernoulli(p, Y)
