"""Distributed matrix-free exact-GP marginal likelihood: CG and SLQ over a
row-sharded mesh axis (counterpart of ``gpflow_slim_tpu.parallel.dist_cg``).

The ring Gram matvec (``ring_gram.ring_gram_matvec``: K is never formed,
each rank streams its block row against the shards passed around the ring)
under the BBMM CG/SLQ estimator of ``models.cg_gpr``. Each rank iterates on
its rows; every inner product of the CG and of Lanczos sums its local
column sums over the axis (an ``all_reduce``, the ``reduce`` argument of
``ops.iterative``), where the JAX package's partitioner inserts a ``psum``.
The small tridiagonal eigendecomposition is computed alike on every rank.

The probes come from ``ops.iterative.cg_probes`` as GPRCG's do: every rank
draws the global (N, P) matrices from the hyperparameters' bits and keeps
its rows, so they do not depend on the number of ranks. The alpha solve and
the trace probes' solves share one CG (their columns are independent; one
ring pass a step). The gradient is BBMM's, through the surrogate of
``models.cg_gpr`` with alpha, the probes and their solves held constant:
each rank differentiates its rows' quadratic forms, and the shares are
summed once (``parallel._shares``). Per-rank memory is O(N D / n + N P / n
+ PANEL N / n).
"""

from __future__ import annotations

import math

import torch

from ..ops import iterative
from . import _shares
from .mesh import Mesh, shard_rows
from .ring_gram import ring_gram_matvec

__all__ = ["make_distributed_cg_loss"]


def make_distributed_cg_loss(model, mesh: Mesh, axis: str = "rows", num_probes: int = 16, cg_iters: int = 100,
                             slq_steps: int = 25):
    """``loss_fn(m) -> -(mll + log_prior)`` of an exact-GP regression model,
    matrix-free over ``mesh[axis]``: the same value on every rank, and
    ``loss.backward()`` leaves BBMM's gradient in every rank's parameters.
    ``model.X``/``model.Y`` are captured here (sharded by rows); the model
    passed to ``loss_fn`` contributes its hyperparameters only, and one
    holding data of another shape raises. N must divide by the axis size."""
    shard = shard_rows(mesh, axis)
    X, Y = model.X, model.Y
    Xl, Yl = shard(X), shard(Y)
    N = X.shape[0]
    n = mesh.shape[axis]
    groups = _shares.groups_of(mesh, [axis])

    def reduce(t):
        return _shares.sum_over(t, groups)

    def local(m):
        kern = m.kern
        noise = torch.squeeze(m.likelihood.variance.value)
        err = Yl - m.mean_function(Xl)
        num_out = err.shape[1]
        with torch.no_grad():
            mv = lambda v: ring_gram_matvec(kern, Xl, v, mesh, axis=axis, noise=noise.detach())  # noqa: E731
            Z_ld, Z = (shard(z) for z in iterative.cg_probes([*kern.parameters(), noise], N, num_probes, err.dtype))
            sol, _ = iterative.batched_cg(mv, torch.cat([err.detach(), Z], dim=1), max_iters=cg_iters, reduce=reduce)
            alpha, U = sol[:, :num_out], sol[:, num_out:]
            logdet = iterative.slq_logdet(mv, Z_ld, num_steps=slq_steps, reduce=reduce)
            mll = (-0.5 * reduce(torch.sum(err.detach() * alpha)) - 0.5 * num_out * logdet
                   - 0.5 * N * num_out * math.log(2.0 * math.pi))
        if torch.is_grad_enabled():
            def Amv(v):
                return ring_gram_matvec(kern, Xl, v, mesh, axis=axis, noise=noise)

            s = (0.5 * torch.sum(alpha * Amv(alpha)) - 0.5 * num_out / num_probes * torch.sum(U * Amv(Z))
                 - torch.sum(err * alpha))
            mll = mll + (s - s.detach())
        return -(mll + _shares.share(m.log_prior(), n))

    def loss_fn(m):
        if m.X.shape != X.shape or m.Y.shape != Y.shape:
            raise ValueError(
                f"loss_fn was built against data of shape X{tuple(X.shape)}/Y{tuple(Y.shape)} but was called with "
                f"a model holding X{tuple(m.X.shape)}/Y{tuple(m.Y.shape)}; make_distributed_cg_loss captures the "
                "data at construction: rebuild the loss for new data")
        return _shares.with_summed_grads(m, groups, local)

    return loss_fn
