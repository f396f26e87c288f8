"""Neural Kernel Networks (counterpart of ``gpflow_slim_tpu.kernels_nkn``;
Sun et al., ICML 2018).

The units of an NKN are kernel values: positive-weighted sums
(``NKNLinear``) and products (``NKNProduct``) of primitive kernels are
again PSD kernels, so a stack of them is a trainable kernel. The
primitives' Grams are stacked on a leading axis, (m, N, M); each primitive
is a kernel of its own, so a stationary primitive with a fused map runs the
cross-Gram kernel on the kernel route. ``NKN`` has no ``K_lower`` of its
own, so a GPR on it takes the padded fused Cholesky route.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .kernels import Kernel
from .params import Module, Param
from .transforms import positive

__all__ = ["NKNLinear", "NKNProduct", "NKN"]


class NKNLinear(Module):
    """``k_out[o] = sum_i W[o, i] k_in[i] (+ b[o])``; W, b >= 0 keeps PSD."""

    def __init__(self, input_dim, output_dim, weights=None, use_bias=False, name="nkn_linear"):
        super().__init__()
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        if weights is None:
            rngw = np.random.RandomState(0)
            weights = rngw.uniform(0.2, 1.0, (output_dim, input_dim)) / input_dim
        self.weights = Param(np.asarray(weights), transform=positive(), name=f"{name}/weights")
        self.use_bias = bool(use_bias)
        if use_bias:
            self.bias = Param(np.full((output_dim,), 0.01), transform=positive(), name=f"{name}/bias")

    def forward(self, Ks):
        # Ks: (in, ...) -> (out, ...)
        out = torch.tensordot(self.weights.value, Ks, dims=([1], [0]))
        if self.use_bias:
            out = out + self.bias.value.reshape((-1,) + (1,) * (out.dim() - 1))
        return out


class NKNProduct(Module):
    """Elementwise product of consecutive groups of ``step`` kernels."""

    def __init__(self, input_dim, step=2, name="nkn_product"):
        super().__init__()
        if input_dim % step != 0:
            raise ValueError("input_dim must be divisible by step")
        self.input_dim = int(input_dim)
        self.step = int(step)
        self.name = name

    def forward(self, Ks):
        # the group's slices multiplied one by one: torch.prod's backward
        # syncs the host, and exp(sum log) cannot take the negative values
        # a Linear or Cosine primitive gives
        groups = Ks.reshape((self.input_dim // self.step, self.step) + tuple(Ks.shape[1:]))
        out = groups[:, 0]
        for s in range(1, self.step):
            out = out * groups[:, s]
        return out


class NKN(Kernel):
    """Neural kernel network over primitive kernels.

    ``primitives``: kernels (each slices its own active_dims); ``layers``:
    NKNLinear/NKNProduct modules, ending with output size 1.
    """

    def __init__(self, input_dim, primitives, layers, name="nkn"):
        super().__init__(input_dim, active_dims=slice(None), name=name)
        self.primitives = nn.ModuleList(primitives)
        self.layers = nn.ModuleList(layers)

    def _slice(self, X, X2):  # primitives do their own slicing
        return X, X2

    def _combine(self, Ks):
        for layer in self.layers:
            Ks = layer(Ks)
        if Ks.shape[0] != 1:
            raise ValueError("NKN must end with a single output kernel")
        return Ks[0]

    def K(self, X, X2=None, presliced=False):
        return self._combine(torch.stack([k.K(X, X2) for k in self.primitives]))  # (m, N, M)

    def Kdiag(self, X, presliced=False):
        return self._combine(torch.stack([k.Kdiag(X) for k in self.primitives]))  # (m, N)
