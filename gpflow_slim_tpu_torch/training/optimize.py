"""Training loops (counterpart of ``gpflow_slim_tpu.training.optimize``).

``fit`` runs ``torch.optim.Adam`` over the trainable unconstrained
parameters. optax's Adam and torch's share beta = (0.9, 0.999) and
eps = 1e-8 outside the square root, so the two trajectories match.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..params import parameters


def fit(model, num_steps: int = 1000, learning_rate: float = 0.01,
        loss_fn: Callable | None = None):
    """Minimize ``loss_fn(model)`` (default ``model.objective()``) in place.

    Returns ``(model, losses)``, ``losses`` of shape (num_steps,): the loss
    before each update, as the JAX ``fit`` returns it.
    """
    if loss_fn is None:
        loss_fn = lambda m: m.objective()  # noqa: E731
    trainable = [p.unconstrained for _, p in parameters(model) if p.trainable]
    opt = torch.optim.Adam(trainable, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return model, torch.stack(losses)
