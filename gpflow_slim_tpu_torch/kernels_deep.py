"""Deep kernels: inputs warped by a neural network (counterpart of
``gpflow_slim_tpu.kernels_deep``).

``DeepKernel(input_dim, base_kernel, warp)`` is ``base_kernel.K(warp(X),
warp(X2))`` for any ``nn.Module`` ``warp``; the warp's parameters are the
kernel's, so one ``objective().backward()`` trains the GP hyperparameters
and the network together (BASELINE config #5's deep kernel). ``K`` is the
base kernel's on the warped inputs: the cross-Gram kernel on the kernel
route for a base with a fused map. ``K_lower`` is the full ``K`` (the
``Kernel`` default), so a GPR on a ``DeepKernel`` takes the padded fused
Cholesky route (``ops.linalg.chol_logdet_quad``).

``mlp_warp(sizes)`` is the JAX package's hand-rolled MLP as a module of
``nn.Linear`` layers, tanh between them and a linear last layer. An
``nn.Linear`` holds ``W^T``: its ``weight`` is (d_out, d_in), where the
JAX package's ``W`` is (d_in, d_out) (``interop.load_unconstrained``
transposes it).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .kernels import Kernel

__all__ = ["DeepKernel", "MLPWarp", "mlp_warp"]


class DeepKernel(Kernel):
    """``K(x, x') = base_kernel.K(warp(x), warp(x'))``."""

    def __init__(self, input_dim, base_kernel: Kernel, warp: nn.Module, active_dims=None,
                 name="deep_kernel"):
        super().__init__(input_dim, active_dims, name=name)
        self.base_kernel = base_kernel
        self.warp = warp

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        H = self.warp(X)
        H2 = None if X2 is None else self.warp(X2)
        return self.base_kernel.K(H, H2, presliced=True)

    def Kdiag(self, X, presliced=False):
        if not presliced:
            X, _ = self._slice(X, None)
        return self.base_kernel.Kdiag(self.warp(X), presliced=True)


class MLPWarp(nn.Module):
    """``nn.Linear`` layers with ``activation`` between them; the last layer
    is linear."""

    def __init__(self, sizes, activation=torch.tanh):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(din, dout, dtype=torch.float64)
                                    for din, dout in zip(sizes[:-1], sizes[1:]))
        self.activation = activation

    def forward(self, X):
        H = X
        for i, layer in enumerate(self.layers):
            H = layer(H)
            if i < len(self.layers) - 1:
                H = self.activation(H)
        return H


def mlp_warp(sizes, generator=None, activation=torch.tanh):
    """An ``MLPWarp`` over ``sizes = [d_in, h1, ..., d_out]``, initialized as
    the JAX package's ``mlp_warp``: W ~ N(0, 1) / sqrt(d_in), b = 0, drawn
    from ``generator`` (a CPU ``torch.Generator``; the global one if None)
    where the JAX package takes a key."""
    warp = MLPWarp(sizes, activation)
    with torch.no_grad():
        for layer in warp.layers:
            dout, din = layer.weight.shape
            w = torch.randn((din, dout), generator=generator, dtype=torch.float64) / math.sqrt(din)
            layer.weight.copy_(w.T)
            layer.bias.zero_()
    return warp
