"""Mean functions (counterpart of ``gpflow_slim_tpu.mean_functions``).

``Zero``, ``Constant`` and ``Linear``; the combinations come later.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import Module, Param

__all__ = ["MeanFunction", "Zero", "Constant", "Linear"]


class MeanFunction(Module):
    def forward(self, X):
        raise NotImplementedError


class Zero(MeanFunction):
    def __init__(self, output_dim=1):
        super().__init__()
        self.output_dim = int(output_dim)

    def forward(self, X):
        return torch.zeros((X.shape[0], self.output_dim), dtype=X.dtype, device=X.device)


class Constant(MeanFunction):
    def __init__(self, c=None, name="constant_mean"):
        super().__init__()
        c = np.zeros(1) if c is None else np.atleast_1d(np.asarray(c, dtype=np.float64))
        self.c = Param(c, name=f"{name}/c")

    def forward(self, X):
        c = torch.reshape(self.c.value, (1, -1))
        return c.expand(X.shape[0], -1).to(X.dtype)


class Linear(MeanFunction):
    """``m(x) = A x + b``; A: (D, P), b: (P,)."""

    def __init__(self, A=None, b=None, name="linear_mean"):
        super().__init__()
        A = np.ones((1, 1)) if A is None else np.atleast_2d(np.asarray(A, dtype=np.float64))
        b = np.zeros(1) if b is None else np.atleast_1d(np.asarray(b, dtype=np.float64))
        self.A = Param(A, name=f"{name}/A")
        self.b = Param(b, name=f"{name}/b")

    def forward(self, X):
        return X @ self.A.value + self.b.value
