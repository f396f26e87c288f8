"""Training loops (counterpart of ``gpflow_slim_tpu.training.optimize``).

``fit`` runs ``torch.optim.Adam`` over the trainable unconstrained
parameters. optax's Adam and torch's share beta = (0.9, 0.999) and
eps = 1e-8 outside the square root, so the two trajectories match.
``make_step_fn`` gives one step of any ``torch.optim`` optimizer for a loop
of the caller's; ``fit_lbfgs`` runs L-BFGS, the reference's
ScipyOptimizer role.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..params import trainable_leaves
from ..utils.trace import named_scope


LINE_SEARCH_EVALS = 25  # evaluations a line search of fit_lbfgs may take (torch's max_ls)


def _objective(m):
    return m.objective()


def _trainable(model):
    return [t for _, t in trainable_leaves(model)]


def fit(model, num_steps: int = 1000, learning_rate: float = 0.01,
        loss_fn: Callable | None = None):
    """Minimize ``loss_fn(model)`` (default ``model.objective()``) in place.

    Returns ``(model, losses)``, ``losses`` of shape (num_steps,): the loss
    before each update, as the JAX ``fit`` returns it.
    """
    step, _ = make_step_fn(model, lambda ps: torch.optim.Adam(ps, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8),
                           loss_fn)
    return model, torch.stack([step() for _ in range(num_steps)])


def make_step_fn(model, optimizer_factory: Callable, loss_fn: Callable | None = None):
    """``(step_fn, optimizer)`` for a loop of the caller's.

    ``optimizer_factory(params)`` builds a ``torch.optim`` optimizer over
    the trainable unconstrained tensors, e.g. ``lambda ps:
    torch.optim.Adam(ps, lr=0.01)``. Each ``step_fn()`` evaluates
    ``loss_fn(model)`` (default ``model.objective()``), its gradient and one
    update of the model in place, and returns the loss before the update
    (detached), as the JAX ``make_step_fn``'s step returns it.
    """
    loss_fn = loss_fn or _objective
    opt = optimizer_factory(_trainable(model))

    def step_fn():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model)
        loss.backward()
        with named_scope("gfs.step.update"):
            opt.step()
        return loss.detach()

    return step_fn, opt


def fit_lbfgs(model, num_steps: int = 100, loss_fn: Callable | None = None):
    """L-BFGS over the trainable unconstrained parameters, in place.

    ``torch.optim.LBFGS`` with a history of 10 and a strong-Wolfe line
    search, one iteration per step; it keeps the trainable leaves as one
    flat vector in ``params.pack_trainable``'s layout. Returns ``(model,
    losses)``, ``losses`` of shape (num_steps,): the loss at the start of
    each step.

    optax's ``lbfgs`` (the JAX package's, with its zoom line search) and
    torch's take different paths to the optimum: the two agree at the
    optimum, not step for step. The line search reads the loss on the host,
    so each step syncs with the device, in both packages a host-side
    optimizer.
    """
    loss_fn = loss_fn or _objective
    # max_eval: the step's first evaluation and up to LINE_SEARCH_EVALS of
    # the line search (torch's default, max_iter * 5 // 4, leaves the line
    # search none at one iteration a step: it then returns a zero step)
    opt = torch.optim.LBFGS(_trainable(model), lr=1.0, max_iter=1, max_eval=1 + LINE_SEARCH_EVALS,
                            history_size=10, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model)
        loss.backward()
        # a trial point where the model does not factor gives NaN, which
        # torch's strong-Wolfe search can step onto (every comparison with
        # NaN is false); +inf fails its decrease test, so it bisects back
        # (the NaN gradient makes its interpolation a bisection), as optax's
        # zoom search shortens the step
        return torch.where(torch.isnan(loss), torch.inf, loss)

    losses = [opt.step(closure).detach() for _ in range(num_steps)]
    return model, torch.stack(losses)
