"""Covariance kernels (counterpart of ``gpflow_slim_tpu.kernels``).

Each kernel is a ``Module`` whose hyperparameters are ``Param``s. The
stationary kernels with a fused map (RBF, the Matérns, Exponential,
Cosine) are ported: where ``ops.linalg.kernels_active`` routes their
inputs to the hand-written kernels, ``K`` is the cross-Gram kernel,
``K_lower`` the lower-tile Gram kernel and ``gram_chol_operand`` the
one-pass operand of the exact-GPR objective; elsewhere ``K`` is the plain
composite of ``ops.gram``. The other kernels and the combination algebra
come later.

Parity conventions: RBF is ``var * exp(-d^2 / 2)`` with lengthscale-scaled
distances (ARD supported); Exponential keeps the GPflow-1.x
``var * exp(-r / 2)``; ``euclid_dist = sqrt(d^2 + 1e-12)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import gram as _gram
from .ops import linalg as _linalg
from .params import Module, Param
from .transforms import positive

__all__ = [
    "Kernel",
    "Stationary",
    "RBF",
    "SquaredExponential",
    "Exponential",
    "Matern12",
    "Matern32",
    "Matern52",
    "Cosine",
]


class Kernel(Module):
    """Base kernel: ``active_dims`` slicing."""

    def __init__(self, input_dim, active_dims=None, name="kernel"):
        super().__init__()
        self.input_dim = int(input_dim)
        if isinstance(active_dims, (list, tuple, np.ndarray)):
            active_dims = tuple(int(a) for a in active_dims)
        self.active_dims = active_dims  # None | slice | tuple[int]
        self.name = name

    def _slice(self, X, X2):
        ad = self.active_dims
        if ad is None:
            X = X[..., : self.input_dim]
            X2 = X2 if X2 is None else X2[..., : self.input_dim]
        elif isinstance(ad, slice):
            X = X[..., ad]
            X2 = X2 if X2 is None else X2[..., ad]
        else:
            idx = torch.as_tensor(ad, device=X.device)
            X = torch.index_select(X, -1, idx)
            X2 = X2 if X2 is None else torch.index_select(X2, -1, idx)
        return X, X2

    def K(self, X, X2=None, presliced=False):
        raise NotImplementedError

    def K_lower(self, X, presliced=False):
        """K(X, X) for consumers that read only its lower triangle (the
        Cholesky): entries with row >= col equal ``K(X)``, the others are
        unspecified. The default is the full Gram."""
        return self.K(X, presliced=presliced)

    def Kdiag(self, X, presliced=False):
        raise NotImplementedError


class Stationary(Kernel):
    """Stationary base: ARD lengthscales + signal variance.

    ``ARD`` is inferred from the shape of ``lengthscales`` or forced by the
    flag (a scalar value is then broadcast to ``input_dim``).
    """

    # kernels with a fused map in ops.gram set this to its kind
    _gram_kind: str | None = None

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, active_dims=None,
                 ARD=False, name="stationary"):
        super().__init__(input_dim, active_dims, name=name)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")
        ls = np.asarray(lengthscales, dtype=np.float64)
        if ARD and ls.ndim == 0:
            ls = np.full((input_dim,), float(ls))
        self.lengthscales = Param(ls, transform=positive(), name=f"{name}/lengthscales")

    def _scaled(self, X):
        return X / self.lengthscales.value

    def square_dist(self, X, X2):
        """Lengthscale-scaled pairwise squared distance via the expansion,
        clamped at 0 (``ops.gram.square_dist``)."""
        Xs = self._scaled(X)
        return _gram.square_dist(Xs, Xs if X2 is None else self._scaled(X2))

    def euclid_dist(self, X, X2):
        return torch.sqrt(self.square_dist(X, X2) + _gram.EUCLID_EPS)

    def Kdiag(self, X, presliced=False):
        return torch.squeeze(self.variance.value).expand(X.shape[0]).to(X.dtype)

    def K(self, X, X2=None, presliced=False):
        if self._gram_kind is None:
            raise NotImplementedError
        if not presliced:
            X, X2 = self._slice(X, X2)
        var = torch.squeeze(self.variance.value)
        Xs = self._scaled(X)
        X2s = Xs if X2 is None else self._scaled(X2)
        if _linalg.kernels_active(Xs):
            return _gram.stationary_gram(self._gram_kind, Xs, X2s, var)
        return _gram.gram_reference(self._gram_kind, Xs, X2s, var)

    def K_lower(self, X, presliced=False):
        """Lower-tile K(X, X): on the kernel route the lower-tile Gram kernel,
        which skips the map on the strictly-upper tiles and writes them as
        zero; elsewhere the full ``K``."""
        if self._gram_kind is None or not _linalg.kernels_active(X):
            return self.K(X, presliced=presliced)
        if not presliced:
            X, _ = self._slice(X, None)
        var = torch.squeeze(self.variance.value)
        return _gram.stationary_gram_lower(self._gram_kind, self._scaled(X), var)

    def gram_chol_operand(self, X, noise, pad_to, presliced=False):
        """One-pass (pad_to, pad_to) Cholesky operand ``K(X, X) + noise * I``
        with a unit-diagonal pad extension; only its lower triangle is
        specified (see ``ops.gram.gram_chol_operand_cuda``). Returns None
        when this kernel has no fused map."""
        if self._gram_kind is None:
            return None
        if not presliced:
            X, _ = self._slice(X, None)
        var = torch.squeeze(self.variance.value)
        return _gram.gram_chol_operand(self._gram_kind, self._scaled(X), var, noise, pad_to)


class RBF(Stationary):
    _gram_kind = "rbf"

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, active_dims=None,
                 ARD=False, name="rbf"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)


SquaredExponential = RBF


class Exponential(Stationary):
    """GPflow-1.x quirk preserved: ``var * exp(-r / 2)`` (not ``exp(-r)``)."""

    _gram_kind = "exponential"

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, active_dims=None,
                 ARD=False, name="exponential"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)


class Matern12(Stationary):
    _gram_kind = "matern12"

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, active_dims=None,
                 ARD=False, name="matern12"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)


class Matern32(Stationary):
    _gram_kind = "matern32"

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, active_dims=None,
                 ARD=False, name="matern32"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)


class Matern52(Stationary):
    _gram_kind = "matern52"

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, active_dims=None,
                 ARD=False, name="matern52"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)


class Cosine(Stationary):
    _gram_kind = "cosine"

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, active_dims=None,
                 ARD=False, name="cosine"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
