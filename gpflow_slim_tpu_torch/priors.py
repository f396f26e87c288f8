"""Parameter priors (counterpart of ``gpflow_slim_tpu.priors``).

Frozen dataclasses with ``logp(x)`` evaluated on the constrained value;
hyperparameters are plain floats.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import densities

__all__ = ["Prior", "Gaussian", "LogNormal", "Gamma", "Laplace", "Beta", "Uniform"]


@dataclasses.dataclass(frozen=True)
class Prior:
    def logp(self, x):
        raise NotImplementedError

    def sample(self, generator: torch.Generator, shape=()):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Gaussian(Prior):
    mu: float = 0.0
    var: float = 1.0

    def logp(self, x):
        return densities.gaussian(x, self.mu, self.var)

    def sample(self, generator: torch.Generator, shape=()):
        z = torch.randn(shape, generator=generator, dtype=torch.float64)
        return self.mu + math.sqrt(self.var) * z


@dataclasses.dataclass(frozen=True)
class LogNormal(Prior):
    mu: float = 0.0
    var: float = 1.0

    def logp(self, x):
        return densities.lognormal(x, self.mu, self.var)


@dataclasses.dataclass(frozen=True)
class Gamma(Prior):
    shape: float = 1.0
    scale: float = 1.0

    def logp(self, x):
        return densities.gamma(self.shape, self.scale, x)


@dataclasses.dataclass(frozen=True)
class Laplace(Prior):
    mu: float = 0.0
    sigma: float = 1.0

    def logp(self, x):
        return densities.laplace(self.mu, self.sigma, x)


@dataclasses.dataclass(frozen=True)
class Beta(Prior):
    a: float = 1.0
    b: float = 1.0

    def logp(self, x):
        return densities.beta(self.a, self.b, x)


@dataclasses.dataclass(frozen=True)
class Uniform(Prior):
    lower: float = 0.0
    upper: float = 1.0

    def logp(self, x):
        return torch.full_like(x, -math.log(self.upper - self.lower))
