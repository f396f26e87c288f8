"""Bijective constraint transforms (counterpart of ``gpflow_slim_tpu.transforms``).

Each transform maps an unconstrained ``x`` to the constrained value
``y = forward(x)`` and back, plus ``log|dy/dx|`` summed over elements.

Parity constants: ``Log1pe`` (the default ``positive``) is
``softplus(x) + 1e-6`` with ``log_jacobian = sum(-softplus(-x))``; ``Exp`` is
``exp(x) + lower``; ``Logistic(a, b)`` is an affine sigmoid into (a, b).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Transform", "Identity", "Exp", "Log1pe", "Logistic", "Chain", "positive"]


def _softplus(x):
    # log(1 + e^x) without torch's linear cut-over at x > 20, so values
    # agree with jax.nn.softplus to the last bit that matters
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class Transform:
    def forward(self, x):
        raise NotImplementedError

    def backward(self, y):
        raise NotImplementedError

    def log_jacobian(self, x):
        """log|d forward / dx| at unconstrained x, summed over elements."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    def forward(self, x):
        return x

    def backward(self, y):
        return y

    def log_jacobian(self, x):
        return torch.zeros((), dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Exp(Transform):
    lower: float = 1e-6

    def forward(self, x):
        return torch.exp(x) + self.lower

    def backward(self, y):
        return torch.log(y - self.lower)

    def log_jacobian(self, x):
        return torch.sum(x)


@dataclasses.dataclass(frozen=True)
class Log1pe(Transform):
    """Softplus with a lower shift, the default positive transform."""

    lower: float = 1e-6

    def forward(self, x):
        return _softplus(x) + self.lower

    def backward(self, y):
        # stable inverse softplus: log(e^z - 1) = z + log(-expm1(-z))
        z = y - self.lower
        return z + torch.log(-torch.expm1(-z))

    def log_jacobian(self, x):
        return -torch.sum(_softplus(-x))


@dataclasses.dataclass(frozen=True)
class Logistic(Transform):
    a: float = 0.0
    b: float = 1.0

    def forward(self, x):
        return self.a + (self.b - self.a) * torch.sigmoid(x)

    def backward(self, y):
        p = (y - self.a) / (self.b - self.a)
        return torch.log(p) - torch.log1p(-p)

    def log_jacobian(self, x):
        return torch.sum(-_softplus(-x) - _softplus(x)) + x.numel() * math.log(
            self.b - self.a
        )


@dataclasses.dataclass(frozen=True)
class Chain(Transform):
    """``forward = outer.forward(inner.forward(x))``."""

    outer: Transform
    inner: Transform

    def forward(self, x):
        return self.outer.forward(self.inner.forward(x))

    def backward(self, y):
        return self.inner.backward(self.outer.backward(y))

    def log_jacobian(self, x):
        mid = self.inner.forward(x)
        return self.inner.log_jacobian(x) + self.outer.log_jacobian(mid)


def positive(lower: float | None = None) -> Transform:
    """The default positivity transform."""
    from . import config

    if lower is None:
        lower = config.settings().positive_minimum
    return Log1pe(lower=lower)
