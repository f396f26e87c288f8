"""Column-block-cyclic distributed Cholesky with explicit collectives
(counterpart of ``gpflow_slim_tpu.parallel.cyclic_cholesky``).

The ScaLAPACK-style 1-D block-cyclic right-looking algorithm: block column
j lives on rank j mod p of the axis. At step k the owner factors its panel
(the diagonal block's factor and its inverse, then the full-height
``panel Z^T``), the panel is **broadcast** from the owner over the axis's
process group (the JAX package's masked ``psum``), and every rank applies
the trailing update to the block columns it owns: the O(N^3) update flops
spread evenly, one N x bs panel moved a step (O(N^2) communication in all).

``lookahead=True`` runs the panel-lookahead order of the JAX package: step
k updates only the next panel's column with panel k, factors and
broadcasts panel k + 1, then applies panel k's bulk update; the same
arithmetic, reordered, so that the broadcast of step k + 1 is issued
before the bulk products of step k.

The diagonal helpers of the JAX package (``_vmem_cholesky_small`` and
``_vmem_tri_inverse_small`` of ``ops/pallas_cholesky.py``, jnp code) are,
on the kernel route, the **factor-only Cholesky kernel** and the **wide
TRSM** against the identity; their plain versions otherwise.

The matrix enters and leaves as an ordinary (N, N) tensor on every rank,
the lower factor replicated (each rank all-gathers the block columns). Its
backward is Murray's adjoint (``ops.blocked.chol_vjp``) on the replicated
factor, computed alike on every rank, where the JAX package differentiates
through the loop: the same gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import blocked
from ..ops.gram import full_precision
from .mesh import Mesh

__all__ = ["cyclic_cholesky"]


def _factor_panel(panel, k, bs):
    """Panel k (N, bs) of the partly updated matrix -> its factored panel:
    rows above k bs zero, the diagonal block's lower factor, ``panel Z^T``
    below it with ``Z`` the diagonal factor's inverse."""
    N = panel.shape[0]
    Ld = blocked.factor_block(panel[k * bs:(k + 1) * bs])
    Zd = blocked.tri_solve(Ld, torch.eye(bs, dtype=panel.dtype, device=panel.device), True)
    out = torch.zeros_like(panel)
    out[k * bs:(k + 1) * bs] = Ld
    if (k + 1) * bs < N:
        with full_precision():
            out[(k + 1) * bs:] = panel[(k + 1) * bs:] @ Zd.mT
    return out


def _cyclic(K, mesh, axis, bs, lookahead):
    N = K.shape[0]
    p = 1 if mesh is None else mesh.shape[axis]
    if N % bs != 0:
        raise ValueError(f"N={N} not divisible by block_size={bs}")
    nb = N // bs
    if nb % p != 0:
        raise ValueError(f"nb={nb} not divisible by mesh axis {p}")
    me = 0 if mesh is None else mesh.coordinate(axis)
    group = None if p == 1 else mesh.group(axis)
    if p > 1 and group is None:
        raise ValueError(f"mesh axis {axis!r} has {p} ranks but no process group")
    mine = list(range(me, nb, p))  # the global block columns this rank owns
    Bl = torch.stack([K[:, j * bs:(j + 1) * bs] for j in mine]).contiguous()  # (nb_loc, N, bs)

    def factor_and_bcast(k):
        """The owner factors panel k and stores it; broadcast to every rank."""
        owner = k % p
        if me == owner:
            Bl[k // p] = _factor_panel(Bl[k // p], k, bs)
            pbc = Bl[k // p]
        else:
            pbc = Bl.new_empty((N, bs))
        if p > 1:
            dist.broadcast(pbc, src=mesh.line(axis)[owner], group=group)
        return pbc

    def update(pbc, k, cols):
        """Panel k's trailing update of the local columns ``cols``."""
        if not cols:
            return
        Wb = pbc[(k + 1) * bs:]
        P = torch.stack([Wb[(mine[m] - k - 1) * bs:(mine[m] - k) * bs] for m in cols])  # (c, bs, bs)
        with full_precision():
            Bl[cols, (k + 1) * bs:] -= Wb @ P.mT

    if not lookahead:
        for k in range(nb):
            pbc = factor_and_bcast(k)
            update(pbc, k, [m for m, j in enumerate(mine) if j > k])
    else:
        pbc = factor_and_bcast(0)
        for k in range(nb - 1):
            # (a) the next panel's column first, (b) factor and broadcast it,
            # (c) panel k's bulk update of the other columns
            update(pbc, k, [m for m, j in enumerate(mine) if j == k + 1])
            pbc_next = factor_and_bcast(k + 1)
            update(pbc, k, [m for m, j in enumerate(mine) if j > k + 1])
            pbc = pbc_next
    if p == 1:
        L = Bl.transpose(0, 1).reshape(N, N)
    else:
        parts = [torch.empty_like(Bl) for _ in range(p)]
        dist.all_gather(parts, Bl, group=group)
        L = torch.empty_like(K)
        for d, part in enumerate(parts):
            for m, j in enumerate(range(d, nb, p)):
                L[:, j * bs:(j + 1) * bs] = part[m]
    return L.tril_()


class _CyclicCholesky(torch.autograd.Function):
    @staticmethod
    def forward(K, mesh, axis, bs, lookahead):
        return _cyclic(K, mesh, axis, bs, lookahead)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.bs = inputs[3]
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (L,) = ctx.saved_tensors
        return blocked.chol_vjp(L, g, ctx.bs, blocked.Rows(L.shape[0])), None, None, None, None


def cyclic_cholesky(K, mesh: Mesh, axis: str, block_size: int = 128, lookahead: bool = True):
    """Lower Cholesky factor of the SPD ``K`` (N, N) over the 1-D mesh axis
    ``axis``, block columns cyclic over its ranks, explicit collectives. N
    divisible by ``block_size``, N / block_size by the axis size. Returns
    the full (N, N) factor on every rank. Differentiable (Murray's
    adjoint)."""
    return _CyclicCholesky.apply(K, mesh, axis, block_size, lookahead)
