"""Neural Kernel Networks (counterpart of ``gpflow_slim_tpu.kernels_nkn``;
Sun et al., ICML 2018).

The units of an NKN are kernel values: positive-weighted sums
(``NKNLinear``) and products (``NKNProduct``) of primitive kernels are
again PSD kernels, so a stack of them is a trainable kernel. The
primitives' Grams are stacked on a leading axis, (m, N, M); each primitive
is a kernel of its own, so a stationary primitive with a fused map runs the
cross-Gram kernel on the kernel route. ``NKN`` has no ``K_lower`` of its
own. A GPR on the paper's time-series network (``ops.nkn.NET``: 8 Linear,
Periodic, RationalQuadratic or stationary primitives over D = 1 or 2
inputs) takes the one-pass operand of ``ops.nkn`` (``gram_chol_operand``);
on any other network it takes the padded fused Cholesky route.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .kernels import Kernel, Linear, Periodic, RationalQuadratic, Stationary
from .ops import gram as _gram
from .ops import nkn as _nkn
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

    def _operand_kinds(self, X):
        """The primitives' kinds (``ops.nkn``) where the one-pass operand
        covers this network on X, else None: ``ops.nkn.NET``'s layers
        without biases, primitives of a covered kind that read all of X's
        D columns (D in ``ops.nkn.DIMS``) with parameters of 1 or D numbers,
        and an X that takes no gradient."""
        if X.dim() != 2 or X.shape[1] not in _nkn.DIMS or X.requires_grad or len(self.primitives) != _nkn.PRIMS:
            return None
        if len(self.layers) != len(_nkn.NET):
            return None
        for layer, (kind, i, o) in zip(self.layers, _nkn.NET):
            if kind == "linear":
                if type(layer) is not NKNLinear or layer.use_bias or (layer.input_dim, layer.output_dim) != (i, o):
                    return None
            elif type(layer) is not NKNProduct or (layer.input_dim, layer.step) != (i, o):
                return None
        D = X.shape[1]
        kinds = []
        for k in self.primitives:
            kind = _primitive_kind(k)
            ad = k.active_dims
            whole = (ad is None and k.input_dim >= D) or ad == slice(None) or ad == tuple(range(D))
            if kind is None or not whole or not _param_sizes_fit(k, D):
                return None
            kinds.append(kind)
        return tuple(kinds)

    def _theta(self, D, like):
        """The network's parameters as ``ops.nkn``'s ``theta`` vector, in
        ``like``'s dtype (differentiable)."""
        def dims(v):
            return v.reshape(-1).expand(D)

        zeros = like.new_zeros(D)
        pieces = []
        for k in self.primitives:
            if type(k) is Linear:
                pieces += [like.new_zeros(1), dims(k.variance.value), zeros]
                continue
            pieces += [k.variance.value.reshape(1), dims(1.0 / k.lengthscales.value)]
            if type(k) is Periodic:
                pieces.append(dims(math.pi / k.period.value))
            elif type(k) is RationalQuadratic:
                pieces += [k.alpha.value.reshape(1), like.new_zeros(D - 1)]
            else:
                pieces.append(zeros)
        pieces += [layer.weights.value.reshape(-1) for layer in self.layers if type(layer) is NKNLinear]
        return torch.cat([p.to(like.dtype) for p in pieces])

    def gram_chol_operand(self, X, noise, pad_to, presliced=False):
        """One-pass (pad_to, pad_to) Cholesky operand ``K(X, X) + noise * I``
        with a unit-diagonal pad extension, only its lower triangle
        specified (``ops.nkn.nkn_chol_operand``); None where this network
        is not covered (``_operand_kinds``)."""
        kinds = self._operand_kinds(X)
        if kinds is None:
            return None
        return _nkn.nkn_chol_operand(X.contiguous(), self._theta(X.shape[1], X), noise, kinds, pad_to)


def _primitive_kind(k):
    if type(k) is Linear:
        return _nkn.LINEAR
    if type(k) is Periodic:
        return _nkn.PERIODIC
    if type(k) is RationalQuadratic:
        return _nkn.RQ
    if isinstance(k, Stationary) and k._gram_kind in _gram.KINDS and type(k).K is Stationary.K:
        return _gram.KINDS[k._gram_kind]
    return None


def _param_sizes_fit(k, D):
    # scalars where the operand takes one number, 1 or D where it takes D
    for name, p in k.named_children():
        if isinstance(p, Param):
            scalar = name == "alpha" or (name == "variance" and type(k) is not Linear)
            if p.unconstrained.numel() not in ((1,) if scalar else (1, D)):
                return False
    return True
