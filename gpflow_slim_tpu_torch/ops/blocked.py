"""Blocked right-looking Cholesky and triangular solves (counterpart of
``gpflow_slim_tpu.ops.blocked``).

The JAX package's blocked algorithms are the slab schedule that its SPMD
partitioner distributes (``parallel.dist_linalg``). Here they are written
once over a row layout (``Rows``): this rank's rows ``[lo, hi)`` of an
N-row matrix and the collectives a step needs. ``Rows(N)`` is the single
device, where every collective is the identity; ``parallel.dist_linalg``
gives the row shards of a mesh axis. Each step of the factor:

- the bs x bs diagonal block is factored by its owner, on the **factor-only
  Cholesky kernel** (``ops.cholesky``) on the kernel route, and broadcast;
- each rank solves its rows of the panel below it, ``col Lkk^-T``, on the
  **wide TRSM kernel** (``ops.trsm``), and the panel is all-gathered;
- the trailing update ``A - W W^T`` is a matrix product (the JAX package
  computes it outside any kernel too), with TF32 off (``full_precision``),
  on the trailing rows and columns only (the JAX package updates the whole
  slab, whose other rows are zero).

The solves follow the same pattern, their diagonal blocks on the wide TRSM.
On the kernel route (``ops.linalg.kernels_active``: a CUDA float32 tensor,
kernels on) the kernels launch or raise; otherwise every step is plain
PyTorch. The factor works in place on its input's buffer where the caller
owns it (``parallel.dist_linalg``); the public functions factor a copy.

Each public function is an autograd Function with the JAX package's
backward: the Murray (2016) adjoint for the factor and the TRSM adjoints
for the solves, computed through the same blocked solves (not autograd
over the loop), in place where the buffers allow: the factor's backward
holds L, its cotangent and two N x N buffers. ``vmap``: the Function on
each entry of the batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cholesky as _chol
from . import linalg as _linalg
from . import trsm as _trsm
from ._func import loop_vmap
from .gram import full_precision

__all__ = ["blocked_cholesky", "blocked_solve_lower", "blocked_solve_upper", "pad_to_block", "Rows"]

STRIP = 1024  # rows of the strips by which a square is symmetrized in place


def pad_to_block(K, block_size):
    """``(Kp, N)``: ``K`` padded to a multiple of ``block_size`` with an
    identity extension."""
    N = K.shape[0]
    rem = (-N) % block_size
    if rem == 0:
        return K, N
    Kp = F.pad(K, (0, rem, 0, rem))
    Kp.diagonal()[N:] = 1.0
    return Kp, N


class Rows:
    """The rows ``[lo, hi)`` of an N-row matrix that this rank holds, and the
    collectives of the blocked algorithms over the ranks that hold the
    others. This class is the single device: every collective is the
    identity. ``me`` is this rank's index, ``owner(row)`` the index of the
    rank holding a row."""

    def __init__(self, N: int):
        self.me, self.lo, self.hi = 0, 0, N

    def owner(self, row: int) -> int:
        return row // (self.hi - self.lo)

    def bcast(self, t, owner: int):
        """``t`` from rank ``owner``, in place; returned."""
        return t

    def sum(self, t):
        """``t`` summed over the ranks, in place; returned."""
        return t

    def gather(self, t, start: int):
        """Rows ``[start, N)`` of a matrix whose rows ``[max(start, lo), hi)``
        this rank holds as ``t``."""
        return t

    def gram_t(self, A, B):
        """This rank's rows of ``A^T B``, for ``A`` and ``B`` held by rows."""
        with full_precision():
            return A.mT @ B

    def transpose(self, A):
        """This rank's rows of ``A^T``, for a square ``A`` held by rows."""
        return A.mT

    def symmetrize_(self, A, scale: float = 1.0):
        """``scale (A + A^T)`` in place, by strips of ``STRIP`` rows; returned."""
        n = A.shape[0]
        for j0 in range(0, n, STRIP):
            j1 = min(j0 + STRIP, n)
            D = A[j0:j1, j0:j1]
            D.copy_(scale * (D + D.mT))
            if j1 < n:
                up, low = A[j0:j1, j1:], A[j1:, j0:j1]
                t = scale * (up + low.mT)
                up.copy_(t)
                low.copy_(t.mT)
        return A


def _check(N, bs, rows):
    if N % bs != 0:
        raise ValueError(f"N={N} not divisible by block_size={bs}")
    if (rows.hi - rows.lo) % bs != 0:
        raise ValueError(f"{rows.hi - rows.lo} rows a rank not divisible by block_size={bs}")


def factor_block(D):
    """The lower factor of a diagonal block: the factor-only kernel on the
    kernel route, ``cholesky_ex`` otherwise (NaN where it fails)."""
    if _linalg.kernels_active(D):
        return _chol.cholesky(D)
    return _chol.cholesky_plain(D)


def tri_solve(T, B, lower):
    """``T^-1 B``: the wide TRSM (through its Function) on the kernel route,
    ``solve_triangular`` otherwise."""
    if _linalg.kernels_active(T):
        return (_trsm.solve_lower if lower else _trsm.solve_upper)(T, B.contiguous())
    return _trsm.solve_triangular_plain(T, B, lower)


def factor_(A, bs, rows):
    """Right-looking blocked Cholesky of this rank's rows ``A`` (n_loc, N)
    of an SPD matrix, in place: ``A`` becomes its rows of the lower factor
    (its upper triangle zero). Returns ``A``."""
    N, lo = A.shape[1], rows.lo
    _check(N, bs, rows)
    for off in range(0, N, bs):
        e = off + bs
        own = rows.owner(off)
        if rows.me == own:
            Lkk = factor_block(A[off - lo:e - lo, off:e])
            A[off - lo:e - lo, off:e] = Lkk
        else:
            Lkk = A.new_empty((bs, bs))
        rows.bcast(Lkk, own)
        if e == N:
            break
        r0 = max(e, lo) - lo  # this rank's rows below the block
        W = A[r0:, off:e]
        if W.shape[0]:
            W.copy_(tri_solve(Lkk, W.mT, True).mT)
        Wall = rows.gather(W, e)
        if W.shape[0]:
            with full_precision():
                A[r0:, e:].addmm_(W, Wall.mT, alpha=-1.0)
    return A.tril_(lo)


def solve_lower_(L, B, bs, rows):
    """``L^-1 B`` in place on ``B`` (n_loc, P): this rank's rows of the
    lower ``L`` and of ``B``. Returns ``B``."""
    N, lo = L.shape[1], rows.lo
    _check(N, bs, rows)
    for off in range(0, N, bs):
        e = off + bs
        own = rows.owner(off)
        if rows.me == own:
            Xk = tri_solve(L[off - lo:e - lo, off:e], B[off - lo:e - lo], True)
            B[off - lo:e - lo] = Xk
        else:
            Xk = B.new_empty((bs, B.shape[1]))
        rows.bcast(Xk, own)
        r0 = max(e, lo) - lo
        if r0 < B.shape[0]:
            with full_precision():
                B[r0:].addmm_(L[r0:, off:e], Xk, alpha=-1.0)
    return B


def solve_upper_t_(L, B, bs, rows):
    """``L^-T B`` in place on ``B`` (n_loc, P): this rank's rows of the lower
    ``L`` and of ``B`` (which may be a transposed view). Block rows from the
    last: ``X_k = L_kk^-T (B_k - sum_{j > k} L_jk^T X_j)``, the sum over
    every rank's rows j in one reduction. Returns ``B``."""
    N, lo = L.shape[1], rows.lo
    _check(N, bs, rows)
    for off in range(N - bs, -1, -bs):
        e = off + bs
        r0 = max(e, lo) - lo
        if r0 < B.shape[0]:
            with full_precision():
                S = L[r0:, off:e].mT @ B[r0:]
        else:
            S = B.new_zeros((bs, B.shape[1]))
        S = rows.sum(S)
        if rows.me == rows.owner(off):
            Bk = B[off - lo:e - lo]
            Bk.copy_(tri_solve(L[off - lo:e - lo, off:e].mT, Bk - S, False))
    return B


def chol_vjp(L, g, bs, rows):
    """Murray (2016), as ``_chol_bwd`` of the JAX package: ``K-bar =
    1/2 sym(L^-T (P + P^T) L^-1)``, ``P = Phi(L^T L-bar)``, on this rank's
    rows, the two solves through ``solve_upper_t_`` in place."""
    lo = rows.lo
    P = rows.gram_t(L, torch.tril(g, lo))
    P.tril_(lo)
    P[:, lo:lo + P.shape[0]].diagonal().mul_(0.5)
    S = solve_upper_t_(L, rows.symmetrize_(P), bs, rows)  # L^-T (P + P^T)
    S = rows.transpose(solve_upper_t_(L, rows.transpose(S), bs, rows))  # ... L^-1
    return rows.symmetrize_(S, 0.25)


def solve_lower_vjp(L, X, g, bs, rows):
    """The TRSM adjoint of ``X = L^-1 B``: ``(L-bar, B-bar) = (-tril(B-bar
    X^T), L^-T g)``, on this rank's rows."""
    gB = solve_upper_t_(L, g.clone(), bs, rows)
    with full_precision():
        gL = gB @ rows.gather(X, 0).mT
    return gL.tril_(rows.lo).neg_(), gB


@loop_vmap(pin={3: False})
class _Factor(torch.autograd.Function):
    @staticmethod
    def forward(K, bs, rows, in_place):
        A = K if in_place else K.clone(memory_format=torch.contiguous_format)
        return factor_(A, bs, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.bs, ctx.rows = inputs[1:3]
        if inputs[3]:
            ctx.mark_dirty(inputs[0])
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (L,) = ctx.saved_tensors
        return chol_vjp(L, g, ctx.bs, ctx.rows), None, None, None


@loop_vmap
class _SolveLower(torch.autograd.Function):
    @staticmethod
    def forward(L, B, bs, rows):
        return solve_lower_(L, B.clone(memory_format=torch.contiguous_format), bs, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.bs, ctx.rows = inputs[2:]
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        L, X = ctx.saved_tensors
        gL, gB = solve_lower_vjp(L, X, g, ctx.bs, ctx.rows)
        return gL, gB, None, None


@loop_vmap
class _SolveUpper(torch.autograd.Function):
    """``U^-1 B`` for an upper ``U`` on one device: ``solve_upper_t_`` on
    ``U^T``. Backward: ``B-bar = U^-T g`` (the lower solve), ``U-bar =
    -triu(B-bar X^T)``."""

    @staticmethod
    def forward(U, B, bs):
        return solve_upper_t_(U.mT, B.clone(memory_format=torch.contiguous_format), bs, Rows(U.shape[0]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.bs = inputs[2]
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        U, X = ctx.saved_tensors
        gB = solve_lower_(U.mT, g.clone(memory_format=torch.contiguous_format), ctx.bs, Rows(U.shape[0]))
        with full_precision():
            gU = gB @ X.mT
        return gU.triu_().neg_(), gB, None


def factor(K, bs, rows, in_place=False):
    """Differentiable rows of the blocked factor over ``rows`` (in place on
    ``K`` where ``in_place``: the caller owns it and nothing else reads
    it)."""
    return _Factor.apply(K, bs, rows, in_place)


def solve_lower(L, B, bs, rows):
    """Differentiable rows of ``L^-1 B`` over ``rows``; ``B`` (n_loc, P)."""
    return _SolveLower.apply(L, B, bs, rows)


def _as_2d(B):
    return B if B.dim() == 2 else B[:, None]


def blocked_cholesky(K, block_size: int = 256):
    """Lower Cholesky factor of ``K`` (N, N), N divisible by ``block_size``
    (``pad_to_block``), by right-looking blocked elimination. Only the
    lower triangle of ``K`` is read. Differentiable (Murray's adjoint)."""
    return factor(K, block_size, Rows(K.shape[0]))


def blocked_solve_lower(L, B, block_size: int = 256):
    """``L^-1 B`` by blocked forward substitution, ``L`` lower, ``B`` (N, P)
    or (N,). Differentiable (the TRSM adjoint)."""
    X = solve_lower(L, _as_2d(B), block_size, Rows(L.shape[0]))
    return X if B.dim() == 2 else X[:, 0]


def blocked_solve_upper(U, B, block_size: int = 256):
    """``U^-1 B`` by blocked backward substitution, ``U`` upper, ``B`` (N, P)
    or (N,). Differentiable (the TRSM adjoint)."""
    X = _SolveUpper.apply(U, _as_2d(B), block_size)
    return X if B.dim() == 2 else X[:, 0]
