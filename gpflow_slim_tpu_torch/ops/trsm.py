"""Blocked triangular solves: one wide right-hand side, and a batch.

Counterpart of ``gpflow_slim_tpu/ops/pallas_trsm.py``. Its two Pallas
kernels become hand-written CUDA kernels, each with its plain PyTorch
version beside it:

- ``_make_trsm_kernel`` (``_trsm_pallas``, ``solve_lower``,
  ``solve_upper``): ``trsm_cuda`` in ``csrc/trsm.cu``; plain
  ``solve_triangular_plain``;
- ``_make_batched_trsm_kernel`` (``_batched_trsm_pallas``,
  ``batched_solve_lower``, ``batched_solve_upper``): ``batched_trsm_cuda``
  in ``csrc/batched_trsm.cu``; plain ``solve_triangular_plain`` on the
  batch.

The two wrappers share their checks (``_check``), and one
autograd Function (``_Trsm``) serves a triangle or a batch; under
``torch.func.vmap`` a batch of single-triangle solves becomes one call of
the batched kernel.

The kernels read the triangle through a row stride and a transpose flag
(and the batched one through a batch stride, which may be 0), so
``solve_upper(L.T, B)`` with ``L`` row-major, ``L`` a view into a padded
buffer (``ops.cholesky.cholesky``), or one triangle broadcast over a batch
with ``expand`` is solved without a copy of ``L``. They mask the ragged
edge themselves: nothing is padded.

The wide TRSM has two schedules, picked by a static rule on the width P of
the right-hand side (``trsm_schedule``; ``csrc/trsm.cu`` states the same
rule): P <= 64 is "thin", one launch whose blocks take their block rows
from an atomic ticket and wait on each other's ready flags, in scratch
from the wrapper that the C entry zeroes on the stream (``trsm_scratch``);
P > 64 is "wide", grouped launches ordered by the stream. The batched TRSM
is one launch of the thin schedule's body over work items (p, 32-column
strip, block row), with a ticket and one ready flag per item
(``batched_trsm_scratch``); it writes a new tensor and leaves ``B`` as it
was.
"""

from __future__ import annotations

import torch

from ..utils.trace import named_scope
from . import _build
from ._func import vmap_loop

BLOCK = 64        # the kernels' block rows
THIN_MAX_P = 64   # the widest right-hand side of the thin schedule
STRIP = 32        # the batched kernel's columns per work item


def trsm_schedule(P):
    """The wide TRSM's schedule for a right-hand side of P columns:
    ``"thin"`` (P <= 64, one launch) or ``"wide"`` (grouped launches)."""
    if P < 1:
        raise ValueError(f"a right-hand side needs at least one column; got P = {P}")
    return "thin" if P <= THIN_MAX_P else "wide"


def trsm_scratch(N, P):
    """Number of int32 words of scratch the wide TRSM needs for T
    (N, N) and B (N, P): for the thin schedule the ticket and one ready
    flag per 64-row block row; none for the wide schedule."""
    if trsm_schedule(P) == "wide":
        return 0
    return -(-N // BLOCK) + 1


def batched_trsm_items(P, M, K):
    """Work items (blocks) of the batched TRSM for T (P, M, M) and B
    (P, M, K): one per batch entry, 32-column strip and 64-row block row."""
    if min(P, M, K) < 1:
        raise ValueError(f"the batched TRSM needs P, M, K >= 1; got {(P, M, K)}")
    return P * -(-K // STRIP) * -(-M // BLOCK)


def batched_trsm_scratch(P, M, K):
    """Number of int32 words of scratch the batched TRSM needs: the ticket
    and one ready flag per work item."""
    return batched_trsm_items(P, M, K) + 1


def solve_triangular_plain(T, B, lower):
    """Plain ``T^-1 B`` by ``torch.linalg.solve_triangular``, over any
    leading batch dimension of ``T`` and ``B``; a ``B`` of one dimension
    less than ``T`` (one vector per triangle) gives a result of its shape."""
    vector = B.dim() < T.dim()
    X = torch.linalg.solve_triangular(T, B[..., None] if vector else B, upper=not lower)
    return X[..., 0] if vector else X


def _layout(T):
    """``(batch_stride, ld, trans)`` of a triangle (M, M), or a batch of
    them (P, M, M), that the kernels can read in place: each a row-major
    matrix with row stride ``ld`` or the transpose of one, ``batch_stride``
    apart (0 for one triangle, or one broadcast over the batch by
    ``expand``)."""
    M = T.shape[-1]
    s0, s1 = T.stride()[-2:]
    batch_stride = T.stride(0) if T.dim() == 3 and T.shape[0] > 1 else 0
    if s1 == 1 and s0 >= M:
        return batch_stride, s0, 0
    if s0 == 1 and s1 >= M:
        return batch_stride, s1, 1
    return None


def _check(fn, T, B, rank):
    """The checks the two kernels share, for T (N, N) and B (N, P) (rank
    2), or T (P, M, M) and B (P, M, K) (rank 3): returns ``_layout(T)``."""
    _build.check_tensor(fn, "T", T, rank, layout=None)
    _build.check_tensor(fn, "B", B, rank, on=T)
    M = B.shape[-2]
    if T.shape != (*B.shape[:-1], M) or min(B.shape) < 1:
        raise ValueError(f"bad shapes: T {tuple(T.shape)}, B {tuple(B.shape)} (T square over B's "
                         f"rows, each dimension at least 1)")
    layout = _layout(T)
    if layout is None:
        raise ValueError(f"{fn} reads each triangle row major or transposed; got strides {T.stride()}")
    return layout


def trsm_cuda(T, B, lower):
    """Launch ``csrc/trsm.cu`` on CUDA float32 tensors: returns ``X`` with
    ``T X = B``, ``T`` (N, N) lower (``lower``) or upper triangular, ``B``
    (N, P), P >= 1, contiguous. ``T`` is row major (any row stride of at
    least N) or the transposed view of such a matrix; only its triangle is
    read. Counted in ``_build.launches`` as ``"gfs_trsm"`` and
    ``("gfs_trsm", trsm_schedule(P))``."""
    _, ld, trans = _check("trsm_cuda", T, B, 2)
    N, P = B.shape
    X = B.clone()  # solved in place
    sync = torch.empty(trsm_scratch(N, P), dtype=torch.int32, device=T.device)
    _build.launch("gfs_trsm", T.data_ptr(), N, ld, trans, int(lower), X.data_ptr(), P, sync.data_ptr(), on=T,
                  detail=trsm_schedule(P))
    return X


def batched_trsm_cuda(T, B, lower):
    """Launch ``csrc/batched_trsm.cu`` on CUDA float32 tensors: returns
    ``X`` with ``T[p] X[p] = B[p]``, ``T`` (P, M, M) lower (``lower``) or
    upper triangular, ``B`` (P, M, K), K >= 1, contiguous. Each ``T[p]`` is
    read as ``trsm_cuda`` reads its ``T``, and the batch may have stride 0;
    only the triangles are read."""
    batch_stride, ld, trans = _check("batched_trsm_cuda", T, B, 3)
    P, M, K = B.shape
    X = torch.empty_like(B)
    sync = torch.empty(batched_trsm_scratch(P, M, K), dtype=torch.int32, device=T.device)
    _build.launch("gfs_batched_trsm", T.data_ptr(), P, M, ld, batch_stride, trans, int(lower), B.data_ptr(),
                  X.data_ptr(), K, sync.data_ptr(), on=T)
    return X


def _solve(T, B, lower):
    # plain for CPU tensors; any other tensor goes to the kernel of its rank,
    # which launches or raises (ops.linalg.kernels_active decides whether
    # the kernels are wanted at all)
    if T.device.type == "cpu":
        return solve_triangular_plain(T, B, lower)
    return (trsm_cuda if T.dim() == 2 else batched_trsm_cuda)(T, B, lower)


class _Trsm(torch.autograd.Function):
    """Forward: the TRSM, one triangle or a batch (kernel or plain).
    Backward: ``_trsm_bwd`` / ``_batched_trsm_bwd`` of the JAX package:
    gB = T^-T g by this Function on the transposed view, read in place, and
    dT = -tri(gB X^T) by a (batched) matrix product (the JAX package
    computes that product outside any kernel too). A ``T`` broadcast with
    ``expand`` gets the sum over the batch from autograd's ``expand``
    backward. ``vmap``: a batch of single-triangle solves is one batched
    solve (an unbatched ``T`` broadcast over it with stride 0); a batch of
    batched solves is one call per entry."""

    @staticmethod
    def forward(T, B, lower):
        with named_scope("gfs.trsm.fwd"):
            return _solve(T, B, lower)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.lower = inputs[2]
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        T, X = ctx.saved_tensors
        with named_scope("gfs.trsm.bwd"):
            gB = _Trsm.apply(T.mT, g.contiguous(), not ctx.lower)
            dT = -(gB @ X.mT)
            return (dT.tril() if ctx.lower else dT.triu()), gB, None

    @staticmethod
    def vmap(info, in_dims, T, B, lower):
        dT, dB, _ = in_dims
        if T.dim() - (dT is not None) == 3:
            return vmap_loop(lambda t, b: _Trsm.apply(t, b.contiguous(), lower), info, (dT, dB), T, B)
        n = info.batch_size
        T = T.movedim(dT, 0) if dT is not None else T.expand(n, -1, -1)
        B = B.movedim(dB, 0) if dB is not None else B.expand(n, -1, -1)
        if _layout(T) is None:
            T = T.contiguous()
        return _Trsm.apply(T, B.contiguous(), lower), 0


def _apply(T, B, lower):
    # the kernels read B's rows contiguously: a transposed view (the
    # BayesianGPLVM's psi1^T) is copied first
    X = _Trsm.apply(T, (B if B.dim() == 2 else B[:, None]).contiguous(), lower)
    return X if B.dim() == 2 else X[:, 0]


def solve_lower(L, B):
    """Differentiable ``L^-1 B``, ``L`` lower triangular, ``B`` (N, P) or
    (N,) (then the result is 1-D)."""
    return _apply(L, B, True)


def solve_upper(U, B):
    """Differentiable ``U^-1 B``, ``U`` upper triangular (``L.T`` of a
    lower factor is read in place), ``B`` (N, P) or (N,)."""
    return _apply(U, B, False)


def batched_solve_lower(L, B):
    """Differentiable ``L[p]^-1 B[p]``, ``L`` (P, M, M) lower triangular
    (a stride-0 batch is read in place), ``B`` (P, M, K)."""
    return _Trsm.apply(L, B, True)


def batched_solve_upper(U, B):
    """Differentiable ``U[p]^-1 B[p]``, ``U`` (P, M, M) upper triangular
    (``L.mT`` of lower factors is read in place), ``B`` (P, M, K)."""
    return _Trsm.apply(U, B, False)
