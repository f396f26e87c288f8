"""How a loss computed in shares over ranks becomes one loss with one gradient.

The JAX package writes a distributed loss as one function of global arrays
and ``jax.grad`` gives its gradient; the partitioner inserts the
collectives of both passes. Here each rank computes its share of the loss
from the rows or tiles it holds, and the model's parameters are the same
on every rank. Two operations make the shares one differentiable loss, as
a tensor-parallel layer's "copy" and "reduce" operations do:

- ``sum_value``: the forward sums a share over the ranks (``all_reduce``),
  the backward passes the gradient through unchanged, so each rank
  differentiates only its own share;
- ``with_summed_grads``: the model's trainable leaves enter the loss through
  one Function whose forward is the identity and whose backward sums their
  gradient over the ranks, once, in one ``all_reduce`` of one flat buffer
  (as ``dp.py`` sums its gradients).

A term that every rank computes whole (a replicated residual, the log
prior) enters with ``share``: its value whole, its gradient divided by the
number of ranks, so the sum counts it once. ``loss.backward()`` then leaves
the global gradient in every rank's parameters. Collectives take plain
tensors: a loss over more than one rank does not compose with
``torch.func`` transforms; on one rank nothing here is applied.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..params import _leaves


def groups_of(mesh, axes) -> list:
    """The process groups of this rank's lines along ``axes`` that hold more
    than one rank (summing over each in turn sums over the sub-mesh)."""
    if mesh is None:
        return []
    return [mesh.group(a) for a in axes if mesh.shape[a] > 1 and mesh.group(a) is not None]


def sum_over(t, groups):
    """``t`` summed over the ranks of ``groups``, in place; returned."""
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


class _SumValue(torch.autograd.Function):
    @staticmethod
    def forward(x, groups):
        return sum_over(x.clone(), groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(x, groups):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.groups = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.clone(), ctx.groups), None


def sum_value(x, groups):
    """``x`` summed over the ranks of ``groups``; its gradient is this
    rank's own (see the module's docstring)."""
    return _SumValue.apply(x, groups) if groups else x


def share(x, n: int):
    """``x`` whole, with its gradient divided by ``n``: a term every one of
    ``n`` ranks computes whole, counted once by ``with_summed_grads``."""
    if n == 1:
        return x
    return x / n + (x - x / n).detach()


class _Call(nn.Module):
    def __init__(self, model, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self):
        return self.fn(self.model)


def with_summed_grads(model, groups, fn):
    """``fn(model)`` with the model's trainable leaves entering through one
    all-reduce of their gradient over ``groups`` (the model unchanged: the
    leaves are put in by ``torch.func.functional_call``)."""
    if not groups:
        return fn(model)
    leaves = _leaves(model)
    flat = _SumGrads.apply(torch.cat([t.reshape(-1) for _, _, t, _ in leaves]), groups)
    state, off = {}, 0
    for _, name, t, _ in leaves:
        state[f"model.{name}"] = flat[off:off + t.numel()].reshape(t.shape)
        off += t.numel()
    return functional_call(_Call(model, fn), state, ())
