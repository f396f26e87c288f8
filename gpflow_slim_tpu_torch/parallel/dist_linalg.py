"""Distributed dense linear algebra and the multi-rank exact-GPR loss
(counterpart of ``gpflow_slim_tpu.parallel.dist_linalg``).

BASELINE config #5: exact GPR at N beyond one card's memory. The JAX
package runs the blocked slab algorithms of ``ops.blocked`` under a row
sharding and lets the SPMD partitioner insert the collectives. Here the
same algorithms run over ``RowShards``, this rank's block of rows of a mesh
axis, with the collectives written out on the axis's process group:

- the factor: at step k the owner of rows ``[k bs, (k + 1) bs)`` factors
  the diagonal block and **broadcasts** it; each rank solves its rows of the
  panel; the trailing update needs the panel's full height, so each step
  **all-gathers** it (``ops.blocked.factor_``);
- the lower solve: the owner solves its block and broadcasts it, each rank
  updates its rows; the solve with L^T (the backwards) sums each block
  row's update over the ranks in one ``all_reduce``;
- the Murray backward's ``L^T L-bar`` and its transposes pass row blocks
  between ranks (``ring_shift``): O(N^2 / n) memory a rank.

``distributed_gpr_mll``: the ring Gram (``ring_gram``, never unsharded) ->
the blocked factor in place on it -> the solve -> the log marginal
likelihood, equal on every rank, whose gradient (``backward()``) is the
single-device GPR's. Sharded arguments and results are this rank's rows;
``make_distributed_gpr_loss`` takes a model holding the global data.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops import blocked
from ..ops._func import transforms_active
from ..ops.gram import full_precision
from . import _shares
from .mesh import Mesh, shard_rows
from .ring_gram import ring_gram, ring_shift

__all__ = ["distributed_cholesky", "distributed_solve_lower", "distributed_gpr_mll", "make_distributed_gpr_loss"]


class RowShards(blocked.Rows):
    """Rows ``[lo, hi)`` of an N-row matrix: this rank's block of the
    ``shard_rows`` layout over ``mesh[axis]`` (of more than one rank), and
    the collectives of the blocked algorithms on the axis's process group."""

    def __init__(self, N: int, mesh: Mesh, axis: str):
        n = mesh.shape[axis]
        if N % n != 0:
            raise ValueError(f"N={N} not divisible by mesh axis {axis!r} of {n}")
        if mesh.group(axis) is None:
            raise ValueError(f"mesh axis {axis!r} has {n} ranks but no process group")
        self.n, self.me = n, mesh.coordinate(axis)
        self.lo = self.me * (N // n)
        self.hi = self.lo + N // n
        self.mesh, self.axis = mesh, axis
        self.group, self.line = mesh.group(axis), mesh.line(axis)

    def bcast(self, t, owner):
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf, src=self.line[owner], group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def sum(self, t):
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t, start):
        n_loc = self.hi - self.lo
        full = t.new_zeros((n_loc, t.shape[1]))
        full[n_loc - t.shape[0]:] = t
        parts = [torch.empty_like(full) for _ in range(self.n)]
        dist.all_gather(parts, full, group=self.group)
        return torch.cat(parts)[start:]

    def _blocks(self, fn):
        """This rank's rows of the sum over ranks r of ``fn(j)``, computed on
        rank r for each rank j: its own part, then at step s the part for
        rank me - s sent s to the left (``ring_shift``) and rank me + s's
        part for this rank received."""
        out = fn(self.me)
        for s in range(1, self.n):
            out = out + ring_shift(fn((self.me - s) % self.n), self.mesh, self.axis, step=s)
        return out

    def gram_t(self, A, B):
        n_loc = self.hi - self.lo

        def part(j):
            with full_precision():
                return A[:, j * n_loc:(j + 1) * n_loc].mT @ B

        return self._blocks(part)

    def transpose(self, A):
        n_loc = self.hi - self.lo
        out = torch.empty_like(A)
        for s in range(self.n):
            # the transpose of my block of rank me - s's columns goes to it;
            # rank me + s's block of my columns arrives
            send = A[:, (self.me - s) % self.n * n_loc:][:, :n_loc].mT
            j = (self.me + s) % self.n
            out[:, j * n_loc:(j + 1) * n_loc] = send if s == 0 else ring_shift(send, self.mesh, self.axis, step=s)
        return out

    def symmetrize_(self, A, scale=1.0):
        return A.add_(self.transpose(A)).mul_(scale)


def _layout(N, mesh, axis):
    return blocked.Rows(N) if mesh is None or mesh.shape[axis] == 1 else RowShards(N, mesh, axis)


def distributed_cholesky(K, mesh: Mesh, axis: str = "rows", block_size: int = 256):
    """This rank's rows of the lower factor of the SPD matrix whose rows
    ``K`` (n_loc, N) this rank holds. Differentiable (Murray's adjoint,
    distributed)."""
    return blocked.factor(K, block_size, _layout(K.shape[1], mesh, axis))


def distributed_solve_lower(L, B, mesh: Mesh, axis: str = "rows", block_size: int = 256):
    """This rank's rows of ``L^-1 B``, from its rows of the lower ``L``
    (n_loc, N) and of ``B`` (n_loc, P) or (n_loc,). Differentiable."""
    X = blocked.solve_lower(L, B if B.dim() == 2 else B[:, None], block_size, _layout(L.shape[1], mesh, axis))
    return X if B.dim() == 2 else X[:, 0]


def distributed_gpr_mll(kern, noise_variance, X, Y, mesh: Mesh, axis: str = "rows", block_size: int = 256,
                        mean=None):
    """Exact GPR log marginal likelihood over ``mesh[axis]``, equal on
    every rank: ``X`` (n_loc, D) and ``Y`` (n_loc, P) this rank's rows (N
    divisible by the axis and ``block_size``), ``mean`` its rows of the
    mean function's values. The MVN logpdf of ``models.GPR.build_likelihood``,
    from the ring Gram, the blocked factor in place on it, and the blocked
    solve. Its gradient is this rank's share; ``make_distributed_gpr_loss``
    sums the shares."""
    n = 1 if mesh is None else mesh.shape[axis]
    N, num_out = X.shape[0] * n, Y.shape[1]
    rows = _layout(N, mesh, axis)
    K = ring_gram(kern, X, mesh, axis=axis)  # (n_loc, N)
    K[:, rows.lo:rows.hi].diagonal().add_(noise_variance)
    L = blocked.factor(K, block_size, rows, in_place=not transforms_active())
    err = Y if mean is None else Y - mean
    alpha = blocked.solve_lower(L, err, block_size, rows)
    share = -num_out * torch.sum(torch.log(torch.diagonal(L[:, rows.lo:rows.hi]))) \
        - 0.5 * torch.sum(torch.square(alpha))
    groups = _shares.groups_of(mesh, [axis])
    return -0.5 * N * num_out * math.log(2.0 * math.pi) + _shares.sum_value(share, groups)


def make_distributed_gpr_loss(model, mesh: Mesh, axis: str = "rows", block_size: int = 256):
    """``loss_fn(m) -> -(mll + log_prior)`` of a GPR model over ``mesh[axis]``
    (the model holding the global data on every rank): the same value on
    every rank, and ``loss.backward()`` leaves the single-device gradient in
    every rank's parameters (``parallel._shares``)."""
    n = mesh.shape[axis]
    groups = _shares.groups_of(mesh, [axis])

    def local(m):
        shard = shard_rows(mesh, axis)
        Xl = shard(m.X)
        noise = torch.squeeze(m.likelihood.variance.value)
        mll = distributed_gpr_mll(m.kern, noise, Xl, shard(m.Y), mesh, axis=axis, block_size=block_size,
                                  mean=m.mean_function(Xl))
        return -(mll + _shares.share(m.log_prior(), n))

    def loss_fn(m):
        return _shares.with_summed_grads(m, groups, local)

    return loss_fn
