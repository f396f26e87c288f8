"""Mean functions (counterpart of ``gpflow_slim_tpu.mean_functions``).

A mean function is a ``Module`` called on X (N, D), giving (N, P). ``+``
and ``*`` build ``Additive`` and ``Product``, the reference's operator
algebra; ``SwitchedMeanFunction`` picks a child per row by X's last column.
"""

from __future__ import annotations

import numpy as np
import torch

from .likelihoods import one_hot
from .params import Module, Param

__all__ = ["MeanFunction", "Zero", "Constant", "Identity", "Linear", "Additive", "Product",
           "SwitchedMeanFunction"]


class MeanFunction(Module):
    def forward(self, X):
        raise NotImplementedError

    def __add__(self, other):
        return Additive(self, other)

    def __mul__(self, other):
        return Product(self, other)


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


class Identity(MeanFunction):
    def forward(self, X):
        return X


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


class Additive(MeanFunction):
    def __init__(self, first, second):
        super().__init__()
        self.add_1 = first
        self.add_2 = second

    def forward(self, X):
        return self.add_1(X) + self.add_2(X)


class Product(MeanFunction):
    def __init__(self, first, second):
        super().__init__()
        self.prod_1 = first
        self.prod_2 = second

    def forward(self, X):
        return self.prod_1(X) * self.prod_2(X)


class SwitchedMeanFunction(MeanFunction):
    """Per-group mean functions selected by X's last column (the group
    index), the companion of ``likelihoods.SwitchedLikelihood``: row n gets
    ``meanfunctions[int(X[n, -1])](X[n, :-1])``. Every child is evaluated on
    all rows and the results are combined by a one-hot mask, as the JAX
    package does (the reference partitions and stitches)."""

    def __init__(self, meanfunction_list):
        super().__init__()
        for m in meanfunction_list:
            if not isinstance(m, MeanFunction):
                raise TypeError("expected MeanFunction instances")
        self.meanfunctions = torch.nn.ModuleList(meanfunction_list)

    def forward(self, X):
        idx = X[:, -1:].to(torch.long)  # (N, 1)
        Xd = X[:, :-1]
        stacked = torch.stack([m(Xd) for m in self.meanfunctions])  # (G, N, P)
        onehot = one_hot(idx, len(self.meanfunctions), X.dtype)  # (N, G)
        return torch.einsum("gnp,ng->np", stacked, onehot)
