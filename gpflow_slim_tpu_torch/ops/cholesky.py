"""Fused Cholesky factor, forward solve and log-determinant.

Counterpart of the fused path of ``gpflow_slim_tpu/ops/pallas_cholesky.py``
(``_cholesky_solve_pallas`` and ``cholesky_solve_logdet``). The Pallas
kernel ``_make_chol_kernel(fuse_p=P)`` becomes the hand-written CUDA
kernel in ``csrc/chol_solve.cu``; beside it stands its plain PyTorch
version (``cholesky_solve_plain``).

Both factor ``Kp`` in place, as the TPU kernel aliases its input to its
output: at N = 10000 that saves a 400 MB copy of the operand. The
autograd wrapper declares the overwrite with ``ctx.mark_dirty``.
"""

from __future__ import annotations

import torch

from . import _build

BLOCK = 64  # the kernel's block size; Kp's side must be a multiple of it


def _nan_where_failed(L, info):
    # a failed factorization gives NaN, never an exception, as the kernel
    # and the TPU/XLA paths do
    return torch.where(info[..., None, None] > 0, torch.full_like(L, float("nan")), L)


def cholesky_solve_plain(Kp, Dp):
    """Plain version: ``cholesky_ex``, ``solve_triangular``, sum log diag.

    Reads only the lower triangle of ``Kp``, then overwrites ``Kp`` with the
    factor. Returns ``(Kp, alpha, half_logdet)`` like the kernel.
    """
    L, info = torch.linalg.cholesky_ex(Kp)
    L = _nan_where_failed(L, info)
    alpha = torch.linalg.solve_triangular(L, Dp, upper=False)
    half_logdet = torch.sum(torch.log(torch.diagonal(L)))
    Kp.copy_(L)
    return Kp, alpha, half_logdet


def cholesky_solve_cuda(Kp, Dp):
    """Launch ``csrc/chol_solve.cu`` on CUDA float32 tensors.

    ``Kp`` (Np, Np), Np a multiple of 64, is factored in place (its lower
    triangle becomes L; strictly-upper entries outside the diagonal blocks
    keep whatever they held). ``Dp`` (Np, P), any P >= 1, is not modified.
    Returns ``(Kp, alpha, half_logdet)``.
    """
    for name, t in (("Kp", Kp), ("Dp", Dp)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"cholesky_solve_cuda takes contiguous 2-D CUDA float32 tensors; "
                f"{name} is {t.dim()}-D {t.dtype} on {t.device}"
            )
    Np = Kp.shape[0]
    P = Dp.shape[1]
    if Kp.shape[1] != Np or Np % BLOCK or Dp.shape[0] != Np or P < 1:
        raise ValueError(
            f"bad shapes: Kp {tuple(Kp.shape)} (square, side a multiple of {BLOCK}), "
            f"Dp {tuple(Dp.shape)} (Np rows, at least one column)"
        )
    if Dp.device != Kp.device:
        raise ValueError(f"Kp on {Kp.device} but Dp on {Dp.device}")
    if Kp.data_ptr() % 16:
        raise ValueError("Kp must be 16-byte aligned (the kernel reads it as float4)")
    alpha = Dp.clone()
    # f64 scratch: per-panel logdet partials, then the f64 pivots
    work = torch.empty(Np // BLOCK + Np, dtype=torch.float64, device=Kp.device)
    half_logdet = torch.empty((), dtype=torch.float32, device=Kp.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(Kp.device).cuda_stream
    code = lib.gfs_chol_solve_logdet(
        Kp.data_ptr(), Np, alpha.data_ptr(), P, work.data_ptr(), half_logdet.data_ptr(), stream)
    _build.check(lib, code, "chol_solve_logdet")
    cholesky_solve_cuda.launches += 1
    return Kp, alpha, half_logdet


cholesky_solve_cuda.launches = 0


def cholesky_solve(Kp, Dp):
    """``(Lp, alpha, half_logdet)`` of the padded system, factoring ``Kp``
    in place. Plain for CPU tensors; any other tensor goes to the kernel,
    which launches or raises. Whether the kernels are wanted at all is
    decided once, by ``ops.linalg.kernels_active``."""
    if Kp.device.type == "cpu":
        return cholesky_solve_plain(Kp, Dp)
    return cholesky_solve_cuda(Kp, Dp)


class _CholSolveLogdet(torch.autograd.Function):
    """Forward: the fused factor/solve/logdet, in place on ``Kp``.
    Backward: ``_csl_bwd`` of the JAX package, in torch.linalg (the JAX
    package also computes it with plain XLA ops, outside any kernel)."""

    @staticmethod
    def forward(ctx, Kp, Dp):
        Lp, alpha, half_logdet = cholesky_solve(Kp, Dp)
        ctx.mark_dirty(Kp)
        ctx.mark_non_differentiable(Lp)
        ctx.save_for_backward(Lp, alpha)
        return Lp, half_logdet, torch.sum(torch.square(alpha))

    @staticmethod
    def backward(ctx, _gL, ghl, gq):
        # d(half_logdet)/dK = K^-1 / 2; quad = D^T K^-1 D, so dquad/dK =
        # -beta beta^T and dquad/dD = 2 beta with beta = K^-1 D = L^-T alpha.
        # The full symmetric K-bar: the operand's VJP reads all of it, and a
        # lower-only K-bar would double the off-diagonal gradient. The solves
        # read only the lower triangle of Lp.
        #
        # It runs in float64 for float32 inputs: the variance gradient is
        # about (N - noise tr K^-1) / 2, a difference of two ~N terms, and an
        # f32 K^-1 put it 1e-2 off the f64 path at N = 10000 (2.7e-5 with
        # this f64 backward of the same f32 factor; H100, 700 W).
        Lp, alpha = ctx.saved_tensors
        dtype = Lp.dtype
        Lp, alpha = Lp.double(), alpha.double()
        ghl, gq = ghl.double(), gq.double()
        beta = torch.linalg.solve_triangular(Lp.mT, alpha, upper=True)
        eye = torch.eye(Lp.shape[0], dtype=Lp.dtype, device=Lp.device)
        Linv = torch.linalg.solve_triangular(Lp, eye, upper=False)
        Kinv = Linv.T @ Linv
        Kbar = 0.5 * ghl * Kinv - gq * (beta @ beta.T)
        Dbar = 2.0 * gq * beta
        return Kbar.to(dtype), Dbar.to(dtype)


def cholesky_solve_logdet(Kp, Dp):
    """Differentiable ``(half_logdet, quad)`` = ``(sum log diag chol(K),
    ||chol(K)^-1 D||_F^2)``. ``Kp`` is the padded operand (unit-diagonal
    extension) and is overwritten by its factor; ``Dp`` has zero pad rows.
    Both scalars are then exact for the leading system."""
    _, half_logdet, quad = _CholSolveLogdet.apply(Kp, Dp)
    return half_logdet, quad
