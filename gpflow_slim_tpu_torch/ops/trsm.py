"""Blocked triangular solve with a wide right-hand side.

Counterpart of the wide path of ``gpflow_slim_tpu/ops/pallas_trsm.py``
(``_trsm_pallas``, ``solve_lower``, ``solve_upper``). The Pallas kernel
``_make_trsm_kernel`` becomes the hand-written CUDA kernel in
``csrc/trsm.cu``; beside it stands its plain PyTorch version
(``solve_triangular_plain``).

The kernel reads the triangle through a row stride and a transpose flag,
so ``solve_upper(L.T, B)`` with ``L`` row-major, or ``L`` a view into a
padded buffer (``ops.cholesky.cholesky``), is solved without a copy of
``L``. It masks the ragged edge itself: nothing is padded.
"""

from __future__ import annotations

import torch

from . import _build


def solve_triangular_plain(T, B, lower):
    """Plain ``T^-1 B`` by ``torch.linalg.solve_triangular``; a 1-D ``B``
    gives a 1-D result."""
    X = torch.linalg.solve_triangular(T, B if B.dim() == 2 else B[:, None], upper=not lower)
    return X if B.dim() == 2 else X[:, 0]


def _layout(T):
    """``(ld, trans)`` of a 2-D triangle the kernel can read in place: row
    major with row stride ``ld``, or the transpose of such a matrix."""
    N = T.shape[0]
    s0, s1 = T.stride()
    if s1 == 1 and s0 >= N:
        return s0, 0
    if s0 == 1 and s1 >= N:
        return s1, 1
    return None


def trsm_cuda(T, B, lower):
    """Launch ``csrc/trsm.cu`` on CUDA float32 tensors: returns ``X`` with
    ``T X = B``, ``T`` (N, N) lower (``lower``) or upper triangular, ``B``
    (N, P), P >= 1, contiguous. ``T`` is row major (any row stride of at
    least N) or the transposed view of such a matrix; only its triangle is
    read."""
    for name, t in (("T", T), ("B", B)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(
                f"trsm_cuda takes 2-D CUDA float32 tensors; {name} is {t.dim()}-D {t.dtype} "
                f"on {t.device}")
    N, P = B.shape
    if T.shape != (N, N) or N < 1 or P < 1:
        raise ValueError(f"bad shapes: T {tuple(T.shape)}, B {tuple(B.shape)} "
                         f"(T square, B with its rows and at least one column)")
    if B.device != T.device:
        raise ValueError(f"T on {T.device} but B on {B.device}")
    if not B.is_contiguous():
        raise ValueError("trsm_cuda needs a contiguous B")
    layout = _layout(T)
    if layout is None:
        raise ValueError(f"trsm_cuda reads T row major or transposed; got strides {T.stride()}")
    ld, trans = layout
    X = B.clone()
    lib = _build.load_library()
    stream = torch.cuda.current_stream(T.device).cuda_stream
    code = lib.gfs_trsm(T.data_ptr(), N, ld, trans, int(lower), X.data_ptr(), P, stream)
    _build.check(lib, code, "trsm")
    trsm_cuda.launches += 1
    return X


trsm_cuda.launches = 0


def _solve(T, B, lower):
    # plain for CPU tensors; any other tensor goes to the kernel, which
    # launches or raises (ops.linalg.kernels_active decides whether the
    # kernels are wanted at all)
    if T.device.type == "cpu":
        return solve_triangular_plain(T, B, lower)
    return trsm_cuda(T, B, lower)


class _Trsm(torch.autograd.Function):
    """Forward: the TRSM (kernel or plain). Backward: ``_trsm_bwd`` of the
    JAX package: gB = T^-T g by the same TRSM on the transposed view, and
    dT = -tri(gB X^T) by a plain matrix product (the JAX package computes
    that product outside any kernel too)."""

    @staticmethod
    def forward(ctx, T, B, lower):
        X = _solve(T, B, lower)
        ctx.lower = lower
        ctx.save_for_backward(T, X)
        return X

    @staticmethod
    def backward(ctx, g):
        T, X = ctx.saved_tensors
        gB = _solve(T.mT, g.contiguous(), not ctx.lower)
        dT = -(gB @ X.mT)
        return (dT.tril() if ctx.lower else dT.triu()), gB, None


def _apply(T, B, lower):
    X = _Trsm.apply(T, B if B.dim() == 2 else B[:, None], lower)
    return X if B.dim() == 2 else X[:, 0]


def solve_lower(L, B):
    """Differentiable ``L^-1 B``, ``L`` lower triangular, ``B`` (N, P) or
    (N,) (then the result is 1-D)."""
    return _apply(L, B, True)


def solve_upper(U, B):
    """Differentiable ``U^-1 B``, ``U`` upper triangular (``L.T`` of a
    lower factor is read in place), ``B`` (N, P) or (N,)."""
    return _apply(U, B, False)
