"""Covariance kernels (counterpart of ``gpflow_slim_tpu.kernels``).

Each kernel is a ``Module`` whose hyperparameters are ``Param``s. The
stationary kernels with a fused map (RBF, the Matérns, Exponential,
Cosine) have hand-written kernels: where ``ops.linalg.kernels_active``
routes their inputs to them, ``K`` is the cross-Gram kernel, ``K_lower``
the lower-tile Gram kernel and ``gram_chol_operand`` the one-pass operand
of the exact-GPR objective; elsewhere ``K`` is the plain composite of
``ops.gram``. The other kernels (White, Constant/Bias, RationalQuadratic,
Linear, Polynomial, ArcCosine, Periodic, Coregion) are plain PyTorch on
every route, as the JAX package has no Pallas kernel for them. ``Sum`` and
``Product`` (``k1 + k2``, ``k1 * k2``) combine their children's ``K``, so a
fused-map child of a combination still runs the cross-Gram kernel.

Parity conventions: RBF is ``var * exp(-d^2 / 2)`` with lengthscale-scaled
distances (ARD supported); Exponential keeps the GPflow-1.x
``var * exp(-r / 2)``; Periodic is the GPflow-1.x
``var * exp(-0.5 sum_d sin^2(pi d_d / p) / l_d^2)`` (0.5, not 2);
``euclid_dist = sqrt(d^2 + 1e-12)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .ops import gram as _gram
from .ops import linalg as _linalg
from .params import Module, Param
from .transforms import positive

__all__ = [
    "Kernel",
    "Static",
    "White",
    "Constant",
    "Bias",
    "Stationary",
    "RBF",
    "SquaredExponential",
    "Exponential",
    "Matern12",
    "Matern32",
    "Matern52",
    "Cosine",
    "RationalQuadratic",
    "Linear",
    "Polynomial",
    "ArcCosine",
    "Periodic",
    "Coregion",
    "Combination",
    "Sum",
    "Product",
]


def _full(X, value):
    """(N,) of a scalar Param's value, in X's dtype."""
    return torch.squeeze(value).expand(X.shape[0]).to(X.dtype)


class Kernel(Module):
    """Base kernel: ``active_dims`` slicing and the combination operators."""

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

    def __add__(self, other):
        return Sum([self, other])

    def __mul__(self, other):
        return Product([self, other])


class Static(Kernel):
    def __init__(self, input_dim, variance=1.0, active_dims=None, name="static"):
        super().__init__(input_dim, active_dims, name=name)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")

    def Kdiag(self, X, presliced=False):
        return _full(X, self.variance.value)


class White(Static):
    """``var * I`` on identical inputs; zero cross-covariance."""

    def K(self, X, X2=None, presliced=False):
        if X2 is None:
            v = torch.squeeze(self.variance.value)
            return v * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        return X.new_zeros((X.shape[0], X2.shape[0]))


class Constant(Static):
    def K(self, X, X2=None, presliced=False):
        m = X.shape[0] if X2 is None else X2.shape[0]
        return torch.squeeze(self.variance.value) * X.new_ones((X.shape[0], m))


class Bias(Constant):
    pass


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
        return _full(X, self.variance.value)

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


class RationalQuadratic(Stationary):
    """``var * (1 + d^2 / (2 alpha))^(-alpha)`` with lengthscale-scaled
    distances; plain PyTorch on every route."""

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, alpha=1.0, active_dims=None,
                 ARD=False, name="rq"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
        self.alpha = Param(alpha, transform=positive(), name=f"{name}/alpha")

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        a = torch.squeeze(self.alpha.value)
        r2 = self.square_dist(X, X2)
        return torch.squeeze(self.variance.value) * torch.pow(1.0 + r2 / (2.0 * a), -a)


class Linear(Kernel):
    """``K = X diag(var) X2^T`` (ARD: a variance per input dimension)."""

    def __init__(self, input_dim, variance=1.0, active_dims=None, ARD=False, name="linear"):
        super().__init__(input_dim, active_dims, name=name)
        v = np.asarray(variance, dtype=np.float64)
        if ARD and v.ndim == 0:
            v = np.full((input_dim,), float(v))
        self.variance = Param(v, transform=positive(), name=f"{name}/variance")

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        return (X * self.variance.value) @ (X if X2 is None else X2).T

    def Kdiag(self, X, presliced=False):
        if not presliced:
            X, _ = self._slice(X, None)
        return torch.sum(torch.square(X) * self.variance.value, dim=-1)


class Polynomial(Linear):
    """``(var <x, x'> + offset)^degree``; ``degree`` is fixed."""

    def __init__(self, input_dim, degree=3.0, variance=1.0, offset=1.0, active_dims=None, ARD=False,
                 name="polynomial"):
        super().__init__(input_dim, variance, active_dims, ARD, name=name)
        self.degree = float(degree)
        self.offset = Param(offset, transform=positive(), name=f"{name}/offset")

    def K(self, X, X2=None, presliced=False):
        return torch.pow(super().K(X, X2, presliced=presliced) + self.offset.value, self.degree)

    def Kdiag(self, X, presliced=False):
        return torch.pow(super().Kdiag(X, presliced=presliced) + self.offset.value, self.degree)


class ArcCosine(Kernel):
    """Cho & Saul (2009) arc-cosine kernel of order 0, 1 or 2, with weight
    and bias variances: ``s(x, x') = bias + sum_d w_d x_d x'_d``,
    ``theta = arccos(s(x, x') / sqrt(s(x, x) s(x', x')))``,
    ``K = var / pi * J_order(theta) * (s(x, x) s(x', x'))^(order / 2)``."""

    implemented_orders = (0, 1, 2)

    def __init__(self, input_dim, order=0, variance=1.0, weight_variances=1.0, bias_variance=1.0,
                 active_dims=None, ARD=False, name="arccosine"):
        super().__init__(input_dim, active_dims, name=name)
        if order not in self.implemented_orders:
            raise ValueError("requested order is not implemented")
        self.order = int(order)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")
        wv = np.asarray(weight_variances, dtype=np.float64)
        if ARD and wv.ndim == 0:
            wv = np.full((input_dim,), float(wv))
        self.weight_variances = Param(wv, transform=positive(), name=f"{name}/weight_variances")
        self.bias_variance = Param(bias_variance, transform=positive(), name=f"{name}/bias_variance")

    def _weighted_product(self, X, X2=None):
        wv = self.weight_variances.value
        bv = torch.squeeze(self.bias_variance.value)
        if X2 is None:
            return bv + torch.sum(wv * torch.square(X), dim=-1)
        return bv + (X * wv) @ X2.T

    def _J(self, theta):
        if self.order == 0:
            return math.pi - theta
        if self.order == 1:
            return torch.sin(theta) + (math.pi - theta) * torch.cos(theta)
        return 3.0 * torch.sin(theta) * torch.cos(theta) + (math.pi - theta) * (
            1.0 + 2.0 * torch.square(torch.cos(theta)))

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        X_denom = torch.sqrt(self._weighted_product(X))
        if X2 is None:
            X2, X2_denom = X, X_denom
        else:
            X2_denom = torch.sqrt(self._weighted_product(X2))
        cos_theta = self._weighted_product(X, X2) / X_denom[:, None] / X2_denom[None, :]
        theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
        return (torch.squeeze(self.variance.value) / math.pi * self._J(theta)
                * torch.pow(X_denom[:, None], self.order) * torch.pow(X2_denom[None, :], self.order))

    def Kdiag(self, X, presliced=False):
        if not presliced:
            X, _ = self._slice(X, None)
        Xp = self._weighted_product(X)
        return (torch.squeeze(self.variance.value) / math.pi * self._J(torch.zeros_like(Xp))
                * torch.pow(Xp, self.order))


class Periodic(Kernel):
    """MacKay periodic kernel, ``var * exp(-0.5 sum_d sin^2(pi d_d / p) /
    l_d^2)``: the GPflow-1.x 0.5, not the textbook 2. ``K`` forms the
    (N, M, D) differences, as the JAX package does."""

    def __init__(self, input_dim, period=1.0, variance=1.0, lengthscales=1.0, active_dims=None,
                 name="periodic"):
        super().__init__(input_dim, active_dims, name=name)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")
        self.lengthscales = Param(lengthscales, transform=positive(), name=f"{name}/lengthscales")
        self.period = Param(period, transform=positive(), name=f"{name}/period")

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        if X2 is None:
            X2 = X
        r = math.pi * (X[:, None, :] - X2[None, :, :]) / self.period.value
        scaled = torch.sin(r) / self.lengthscales.value
        return torch.squeeze(self.variance.value) * torch.exp(-0.5 * torch.sum(torch.square(scaled), dim=-1))

    def Kdiag(self, X, presliced=False):
        return _full(X, self.variance.value)


class Coregion(Kernel):
    """Coregionalization: ``B = W W^T + diag(kappa)`` looked up by the
    integer output index in ``X[:, 0]``: ``K(X, X2) = B[ix, ix2]``."""

    def __init__(self, input_dim, output_dim, rank, active_dims=None, name="coregion", W=None,
                 kappa=None):
        super().__init__(input_dim, active_dims, name=name)
        if input_dim != 1:
            raise ValueError("Coregion kernel requires input_dim=1")
        self.output_dim = int(output_dim)
        self.rank = int(rank)
        W0 = np.zeros((output_dim, rank)) if W is None else np.asarray(W)
        k0 = np.ones(output_dim) if kappa is None else np.asarray(kappa)
        self.W = Param(W0, name=f"{name}/W")
        self.kappa = Param(k0, transform=positive(), name=f"{name}/kappa")

    def _B(self):
        W = self.W.value
        return W @ W.T + torch.diag(self.kappa.value)

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        B = self._B()
        ix = X[:, 0].to(torch.int64)
        ix2 = ix if X2 is None else X2[:, 0].to(torch.int64)
        return B[ix][:, ix2]

    def Kdiag(self, X, presliced=False):
        if not presliced:
            X, _ = self._slice(X, None)
        Bdiag = torch.sum(torch.square(self.W.value), dim=1) + self.kappa.value
        return Bdiag[X[:, 0].to(torch.int64)]


def _required_dim(k):
    # the input columns a child reads: its input_dim, or past its last active dim
    ad = k.active_dims
    if ad is None:
        return k.input_dim
    if isinstance(ad, slice):
        return ad.stop if ad.stop is not None else k.input_dim
    return max(ad) + 1


class Combination(Kernel):
    """Children in an ``nn.ModuleList`` (their Params register under
    ``kernels.<i>``). A child that is a ``Sum`` (``Product``) is flattened
    into a ``Sum`` (``Product``), as in the JAX package; the children slice
    their own inputs."""

    def __init__(self, kernels, name="combination"):
        flat = []
        for k in kernels:
            if not isinstance(k, Kernel):
                raise TypeError("can only combine Kernel instances")
            if isinstance(k, type(self)) and type(k) in (Sum, Product):
                flat.extend(k.kernels)
            else:
                flat.append(k)
        super().__init__(max(_required_dim(k) for k in flat), active_dims=slice(None), name=name)
        self.kernels = nn.ModuleList(flat)

    def _slice(self, X, X2):
        return X, X2


class Sum(Combination):
    """``sum_i K_i``; ``K_lower`` is the full ``K``, as in the JAX package."""

    def __init__(self, kernels, name="sum"):
        super().__init__(kernels, name=name)

    def K(self, X, X2=None, presliced=False):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out + k.K(X, X2)
        return out

    def Kdiag(self, X, presliced=False):
        out = self.kernels[0].Kdiag(X)
        for k in self.kernels[1:]:
            out = out + k.Kdiag(X)
        return out


class Product(Combination):
    """``prod_i K_i``, elementwise."""

    def __init__(self, kernels, name="product"):
        super().__init__(kernels, name=name)

    def K(self, X, X2=None, presliced=False):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out * k.K(X, X2)
        return out

    def Kdiag(self, X, presliced=False):
        out = self.kernels[0].Kdiag(X)
        for k in self.kernels[1:]:
            out = out * k.Kdiag(X)
        return out
