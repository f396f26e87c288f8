"""Inducing features (counterpart of ``gpflow_slim_tpu.features``).

``InducingPoints(Z)`` holds a trainable (M, D) ``Param``; ``Kuu`` and
``Kuf`` dispatch on the feature type. Both are ``kern.K``, which on the
kernel route is the cross-Gram kernel. ``Multiscale`` comes later.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import Module, Param

__all__ = ["InducingFeature", "InducingPoints", "Kuu", "Kuf", "inducingpoint_wrapper"]


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
