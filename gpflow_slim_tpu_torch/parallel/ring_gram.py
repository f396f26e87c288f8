"""Ring Gram construction (counterpart of ``gpflow_slim_tpu.parallel.ring_gram``).

Each rank holds a row shard of X. To build its block row of K it passes
the shard it holds to its left neighbour, ``dist.batch_isend_irecv`` on the
axis's process group, as the JAX package's ``ppermute`` sends shard i to
device (i - 1) mod n: after s steps a rank holds shard (me + s) mod n, the
ring-attention rotation of the key/value shards. The JAX package's loop
sends once more after the last block, which only brings each shard home;
here the ring stops after n - 1 sends. Each block is ``kern.K(Xl, Xrot)``:
on the kernel route the **cross-Gram kernel**, in panels of ``PANEL`` rows
so that its backward holds one panel's temporaries at a time. The Gram is
only ever held by rows (n_loc of the N rows a rank); ``ring_gram_matvec``
never forms it: it accumulates ``block @ vrot`` panel by panel.

Sharded arguments and results are this rank's rows (the ``P(axis)``
layout of the JAX package's global arrays: ``parallel.shard_rows`` takes
them from the global array); the kernel is the same on every rank. The
hyperparameter gradient of a block row is this rank's share of the
gradient (``parallel._shares`` sums the shares once).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ring_gram", "ring_gram_matvec"]

PANEL = 4096  # rows of a Gram panel


def ring_shift(t, mesh, axis, step: int = 1):
    """This rank's ``t`` sent to its neighbour ``step`` to the left along
    ``axis``; returns the tensor received from the neighbour ``step`` to the
    right (the JAX package's ``ppermute`` by ``(i, (i - step) mod n)``)."""
    n, i = mesh.shape[axis], mesh.coordinate(axis)
    line, group = mesh.line(axis), mesh.group(axis)
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    ops = [dist.P2POp(dist.isend, t.contiguous(), line[(i - step) % n], group),
           dist.P2POp(dist.irecv, out, line[(i + step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _panels(kern, Xl, Xrot):
    """``kern.K(Xl, Xrot)`` in panels of ``PANEL`` rows."""
    if Xl.shape[0] <= PANEL:
        return kern.K(Xl, Xrot)
    return torch.cat([kern.K(x, Xrot) for x in Xl.split(PANEL)])


def _check(mesh, axis):
    if mesh.shape[axis] > 1 and mesh.group(axis) is None:
        raise ValueError(f"mesh axis {axis!r} has {mesh.shape[axis]} ranks but no process group")


def ring_gram(kern, Xl, mesh, axis: str = "rows"):
    """This rank's block row of ``K(X, X)`` (n_loc, N), from its row shard
    ``Xl`` (n_loc, D) of X, the shards passed around the ring of ``axis``.
    Diagonal jitter/noise is the caller's business."""
    _check(mesh, axis)
    n, me = mesh.shape[axis], mesh.coordinate(axis)
    blocks, Xrot = [None] * n, Xl
    for s in range(n):
        blocks[(me + s) % n] = _panels(kern, Xl, Xrot)
        if s < n - 1:
            Xrot = ring_shift(Xrot, mesh, axis)
    return blocks[0] if n == 1 else torch.cat(blocks, dim=1)


def ring_gram_matvec(kern, Xl, vl, mesh, axis: str = "rows", noise=0.0):
    """This rank's rows of ``(K(X, X) + noise I) v`` without forming K:
    ``Xl`` (n_loc, D) and ``vl`` (n_loc,) or (n_loc, P) its rows of X and v.
    O(N^2 / n) work and O(N D / n + PANEL N / n) memory a rank."""
    _check(mesh, axis)
    n = mesh.shape[axis]
    v2 = vl if vl.dim() == 2 else vl[:, None]
    acc, Xrot, vrot = None, Xl, v2
    for s in range(n):
        part = torch.cat([kern.K(x, Xrot) @ vrot for x in Xl.split(PANEL)])
        acc = part if acc is None else acc + part
        if s < n - 1:
            Xrot, vrot = ring_shift(Xrot, mesh, axis), ring_shift(vrot, mesh, axis)
    out = acc + noise * v2
    return out if vl.dim() == 2 else out[:, 0]
