"""Data-parallel SVGP training (counterpart of ``gpflow_slim_tpu.parallel.dp``).

The minibatch is split over the ``data`` axis of a rank mesh and the model
is replicated. Each rank computes the variational-expectation sum of its
shard; ``-(N / B) sum ve_local + (KL - log_prior) / n_ranks`` is its share
of the loss, so one ``all_reduce`` (sum) of the loss and the gradients
gives the global minibatch's, the KL and the prior counted once. The JAX
package gets the same collectives from ``shard_map``'s ``psum`` or from the
SPMD partitioner; here they are written out: one ``all_reduce`` of one
flat buffer a step, on the axis's process group (``mesh.Mesh``).

``make_svgp_step`` draws each step's global minibatch without replacement
from a ``torch.Generator`` seeded alike on every rank
(``torch.randperm(N, generator=g, device=...)[:B]``, on the data's device:
no host sync), and each rank takes its contiguous slice of the indices, the
``P("data")`` layout. The global batch, and so the trajectory, does not
depend on the number of ranks; it may also be given (``batch=``), as from
``io.BinaryDataset.minibatches``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..models.model import as_tensor_like
from ..params import trainable_leaves
from .mesh import Mesh, replicated, shard_rows

__all__ = ["dp_value_and_grad", "fit_svgp", "make_svgp_step"]


def _elbo_parts(model, Xb, Yb):
    """(local variational-expectation sum, KL). ELBO = scale * sum ve - KL."""
    fmean, fvar = model._conditional_batch(Xb)
    ve = model.likelihood.variational_expectations(fmean, fvar, Yb)
    return torch.sum(ve), model.prior_kl()


def _ranks(mesh, axis):
    return 1 if mesh is None else mesh.shape[axis]


def _local(model, leaves, xb, yb, B, mesh, axis):
    """This rank's share of the loss on its shard of a global batch of B
    rows, its gradients in ``leaves`` (``trainable_leaves(model)``), and
    the two all-reduced over the axis: ``(loss, {name: grad})``."""
    n = _ranks(mesh, axis)
    ve, kl = _elbo_parts(model, xb, yb)
    loss = -(model.num_data / B) * ve + (kl - model.log_prior()) / n
    grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(leaves, grads)]
    group = None if mesh is None else mesh.group(axis)
    if group is not None:
        # the data-parallel collective: loss and gradients in one buffer
        flat = torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        loss = flat[0]
        grads = list(torch.split(flat[1:], [g.numel() for g in grads]))
        grads = [g.reshape(t.shape) for g, (_, t) in zip(grads, leaves)]
    return loss.detach(), dict(zip((name for name, _ in leaves), grads))


def dp_value_and_grad(model, Xb, Yb, mesh: Mesh, axis: str = "data"):
    """``(loss, grads)``: -(ELBO + log prior) on the global minibatch
    ``(Xb, Yb)`` (B rows, every rank holding it; B divisible by the axis
    size) and its gradient ``{name: tensor}`` in the trainable leaves
    (``params.trainable_leaves``), each rank computing on its contiguous
    shard, the results all-reduced: equal on every rank."""
    Xb, Yb = as_tensor_like(Xb, model.X), as_tensor_like(Yb, model.X)
    B, n = Xb.shape[0], mesh.shape[axis]
    if B % n != 0:
        raise ValueError(f"batch {B} not divisible by mesh axis {n}")
    shard = shard_rows(mesh, axis)
    return _local(model, trainable_leaves(model), shard(Xb), shard(Yb), B, mesh, axis)


def make_svgp_step(model, optimizer: Callable, mesh: Mesh | None = None, axis: str = "data",
                   batch_size: int | None = None):
    """``(step_fn, opt)``: one stochastic data-parallel step of ``model`` in
    place. ``optimizer(params)`` builds a ``torch.optim`` optimizer over the
    trainable leaves only (``optax.masked``'s role: no optimizer state for
    the data). ``step_fn(generator)`` draws the global minibatch of
    ``batch_size`` rows (default all N) from ``model.X``/``model.Y`` without
    replacement (a generator on the data's device, seeded alike on every
    rank); ``step_fn(batch=(Xb, Yb))`` takes a given global minibatch. Each
    rank evaluates its contiguous slice; the loss and gradients are
    all-reduced over ``axis`` and the optimizer steps. Returns the global
    loss before the update. The trainable leaves are broadcast from the
    mesh's first rank once, so the replicas start equal."""
    named = trainable_leaves(model)
    leaves = [t for _, t in named]
    if mesh is not None:
        for t in leaves:
            replicated(mesh)(t)
    opt = optimizer(leaves)
    N = model.num_data
    B = batch_size or N
    n = _ranks(mesh, axis)
    if B % n != 0:
        raise ValueError(f"batch {B} not divisible by mesh axis {n}")
    i = 0 if mesh is None else mesh.coordinate(axis)

    def step_fn(generator: torch.Generator | None = None, batch=None):
        if (generator is None) == (batch is None):
            raise ValueError("give a generator or a batch")
        if batch is None:
            idx = torch.randperm(N, generator=generator, device=model.X.device)[:B]
            b = B // n
            local = idx[i * b:(i + 1) * b]
            xb, yb, rows = model.X[local], model.Y[local], B
        else:
            Xb, Yb = (as_tensor_like(a, model.X) for a in batch)
            rows = Xb.shape[0]
            if rows % n != 0:
                raise ValueError(f"batch {rows} not divisible by mesh axis {n}")
            b = rows // n
            xb, yb = Xb[i * b:(i + 1) * b], Yb[i * b:(i + 1) * b]
        loss, grads = _local(model, named, xb, yb, rows, mesh, axis)
        for t, g in zip(leaves, grads.values()):
            t.grad = g
        opt.step()
        return loss

    return step_fn, opt


def fit_svgp(model, num_steps: int, generator: torch.Generator, learning_rate: float = 0.01,
             batch_size: int | None = None, mesh: Mesh | None = None, axis: str = "data",
             optimizer: Callable | None = None):
    """Stochastic SVGP training, in place: ``num_steps`` steps of
    ``make_svgp_step`` (Adam at ``learning_rate`` unless ``optimizer``, a
    factory over the parameters, is given), each drawing its minibatch
    from ``generator``. With a mesh, the minibatch is split over ``axis``.
    Returns ``(model, losses)``, ``losses`` (num_steps,): the loss before
    each update."""
    if optimizer is None:
        optimizer = lambda ps: torch.optim.Adam(ps, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)  # noqa: E731
    step_fn, _ = make_svgp_step(model, optimizer, mesh=mesh, axis=axis, batch_size=batch_size)
    return model, torch.stack([step_fn(generator) for _ in range(num_steps)])
