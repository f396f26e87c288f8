"""Inducing features (counterpart of ``gpflow_slim_tpu.features``).

``InducingPoints(Z)`` holds a trainable (M, D) ``Param``; ``Kuu`` and
``Kuf`` dispatch on the feature type. Both are ``kern.K``, which on the
kernel route is the cross-Gram kernel. ``Multiscale`` is the
Titsias-2009 multiscale RBF feature, whose closed-form ``Kuu`` and ``Kuf``
are plain PyTorch on every route, as the JAX package's are plain jnp.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .params import Module, Param
from .transforms import positive

__all__ = ["InducingFeature", "InducingPoints", "Multiscale", "Kuu", "Kuf", "inducingpoint_wrapper"]


class InducingFeature(Module):
    def __len__(self):
        raise NotImplementedError


class InducingPoints(InducingFeature):
    def __init__(self, Z, name="inducing_points"):
        super().__init__()
        Z = np.asarray(Z)
        if Z.ndim != 2:
            raise ValueError(f"Z must be rank-2 (M, D); got shape {Z.shape}")
        self.Z = Param(Z, name=f"{name}/Z")
        self._num = int(Z.shape[0])

    def __len__(self):
        return self._num

    def Kuu(self, kern, jitter=0.0):
        Zv = self.Z.value
        return kern.K(Zv) + jitter * torch.eye(len(self), dtype=Zv.dtype, device=Zv.device)

    def Kuf(self, kern, Xnew):
        return kern.K(self.Z.value, Xnew)


class Multiscale(InducingPoints):
    """Multiscale inducing features for RBF kernels: each inducing input
    Z_m carries its own scale vector. Closed-form Kuu/Kuf exist for the RBF
    kernel only."""

    def __init__(self, Z, scales=None, name="multiscale"):
        super().__init__(Z, name=name)
        Z = np.asarray(Z)
        scales = np.ones_like(Z) if scales is None else np.asarray(scales)
        self.scales = Param(scales, transform=positive(), name=f"{name}/scales")

    @staticmethod
    def _cust_square_dist(A, B, sc):
        # sum_d ((A[:, None, d] - B[None, :, d]) / sc)^2; sc broadcasts over axis 0
        return torch.sum(torch.square((A[:, None, :] - B[None, :, :]) / sc), dim=-1)

    def Kuf(self, kern, Xnew):
        if not isinstance(kern, kernels.RBF):
            raise NotImplementedError("Multiscale features require an RBF kernel")
        Xnew, _ = kern._slice(Xnew, None)
        Zmu = self.Z.value
        idls = kern.lengthscales.value + self.scales.value  # (M, D)
        d = self._cust_square_dist(Xnew, Zmu, idls)  # (N, M)
        scale = torch.prod(kern.lengthscales.value / idls, dim=-1)  # (M,)
        return (torch.squeeze(kern.variance.value) * torch.exp(-0.5 * d) * scale[None, :]).T  # (M, N)

    def Kuu(self, kern, jitter=0.0):
        if not isinstance(kern, kernels.RBF):
            raise NotImplementedError("Multiscale features require an RBF kernel")
        Zmu = self.Z.value
        ls = kern.lengthscales.value
        idls2 = torch.square(ls + self.scales.value)  # (M, D)
        sc = torch.sqrt(idls2[None, :, :] + idls2[:, None, :] - torch.square(ls))  # (M, M, D)
        d = torch.sum(torch.square((Zmu[:, None, :] - Zmu[None, :, :]) / sc), dim=-1)
        K = torch.squeeze(kern.variance.value) * torch.exp(-0.5 * d) * torch.prod(ls / sc, dim=-1)
        return K + jitter * torch.eye(len(self), dtype=K.dtype, device=K.device)


def Kuu(feat: InducingFeature, kern, jitter=0.0):
    return feat.Kuu(kern, jitter=jitter)


def Kuf(feat: InducingFeature, kern, Xnew):
    return feat.Kuf(kern, Xnew)


def inducingpoint_wrapper(feat, Z):
    """Accept either an InducingFeature or a raw Z array (reference helper)."""
    if feat is not None and Z is not None:
        raise ValueError("Cannot pass both an InducingFeature and Z")
    if feat is None and Z is None:
        raise ValueError("You must pass either an InducingFeature or Z")
    if Z is not None:
        feat = InducingPoints(Z)
    return feat
