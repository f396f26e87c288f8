"""Bijective constraint transforms (counterpart of ``gpflow_slim_tpu.transforms``).

Each transform maps an unconstrained ``x`` to the constrained value
``y = forward(x)`` and back, plus ``log|dy/dx|`` summed over elements.

Parity constants: ``Log1pe`` (the default ``positive``) is
``softplus(x) + 1e-6`` with ``log_jacobian = sum(-softplus(-x))``; ``Exp`` is
``exp(x) + lower``; ``Logistic(a, b)`` is an affine sigmoid into (a, b);
``LowerTriangular`` packs lower triangles row-wise into a flat vector.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Transform", "Identity", "Exp", "Log1pe", "Logistic", "Chain", "LowerTriangular",
           "positive"]


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


@dataclasses.dataclass(frozen=True)
class LowerTriangular(Transform):
    """Pack flat vector(s) into lower-triangular matrices.

    ``forward`` maps a vector of length ``num_matrices * n(n+1)/2`` to a
    tensor (num_matrices, n, n) (or (n, n) when ``squeeze``) whose lower
    triangles are filled row-wise, in ``np.tril_indices`` order (the same
    order as ``torch.tril_indices``), so the JAX package's packed vector
    loads as it is. A linear embedding: its log-Jacobian is 0.
    """

    n: int
    num_matrices: int = 1
    squeeze: bool = False

    def forward(self, x):
        rows, cols = torch.tril_indices(self.n, self.n, device=x.device)
        xs = x.reshape(self.num_matrices, rows.numel())
        out = x.new_zeros((self.num_matrices, self.n, self.n))
        out[:, rows, cols] = xs
        if self.squeeze and self.num_matrices == 1:
            out = out[0]
        return out

    def backward(self, y):
        if y.dim() == 2:
            y = y[None]
        rows, cols = torch.tril_indices(self.n, self.n, device=y.device)
        return y[:, rows, cols].reshape(-1)

    def log_jacobian(self, x):
        return torch.zeros((), dtype=x.dtype, device=x.device)


def positive(lower: float | None = None) -> Transform:
    """The default positivity transform."""
    from . import config

    if lower is None:
        lower = config.settings().positive_minimum
    return Log1pe(lower=lower)
