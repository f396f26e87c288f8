"""The port's entry point: one objective+gradient evaluation on the
flagship exact GPR (N=2048 points of a noisy wiggle on [0, 1], RBF with
lengthscale 0.1, float32), the model and data of ``__graft_entry__.py``'s
``entry()``, built with numpy and placed on the card unless the caller asks
for another device. On the card it runs the Gram operand and the fused
factor/solve/logdet kernels, and their backwards::

    fn, args = entry()
    loss, grads = fn(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, models
from .params import parameters


def flagship_model(N: int = 2048, device=None, dtype=np.float32):
    """The flagship GPR: X ~ U[0, 1] from RandomState(0), Y = sin(12 X) +
    0.66 cos(25 X) + 0.1 noise, RBF with lengthscale 0.1."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(dtype)
    Y = (np.sin(12 * X) + 0.66 * np.cos(25 * X) + rng.randn(N, 1) * 0.1).astype(dtype)
    return models.GPR(X, Y, kern=kernels.RBF(1, lengthscales=0.1), device=device)


def entry(device=None):
    """``(fn, args)``: ``fn(model)`` is one objective+gradient evaluation,
    ``(loss, {name: gradient of the unconstrained value})`` for the
    trainable Params, the counterpart of ``jax.value_and_grad`` of the
    objective; ``args`` is ``(flagship_model(device=device),)``."""

    def step(model):
        named = [(n, p.unconstrained) for n, p in parameters(model) if p.trainable]
        loss = model.objective()
        grads = torch.autograd.grad(loss, [t for _, t in named])
        return loss.detach(), {n: g for (n, _), g in zip(named, grads)}

    return step, (flagship_model(device=device),)
