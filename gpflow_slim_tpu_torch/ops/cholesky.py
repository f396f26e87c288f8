"""Blocked Cholesky: the fused factor/solve/logdet, and the factor alone.

Counterpart of ``gpflow_slim_tpu/ops/pallas_cholesky.py``. Its Pallas
kernel ``_make_chol_kernel`` becomes the hand-written CUDA kernel in
``csrc/chol_solve.cu``, in its two modes, each with its plain PyTorch
version beside it:

- fused (``fuse_p=P``, ``cholesky_solve_logdet``): ``cholesky_solve_cuda``;
  plain ``cholesky_solve_plain``;
- factor only (``fuse_p=None``, ``cholesky``): ``cholesky_cuda``; plain
  ``cholesky_plain``.

The kernel factors the padded ``Kp`` in place, as the TPU kernel aliases
its input to its output: at N = 10000 that saves a 400 MB copy. The fused
autograd wrapper declares the overwrite with ``ctx.mark_dirty``; inside a
``torch.func`` transform it factors a copy instead (a transform that
batches the Function cannot return its input as written). The factor-only
wrapper pads into a buffer of its own and factors that.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from . import trsm as _trsm
from ._func import transforms_active, vmap_loop

BLOCK = 64  # the kernel's block size; Kp's side must be a multiple of it


def _nan_where_failed(L, info):
    # a failed factorization gives NaN, never an exception, as the kernel
    # and the TPU/XLA paths do
    return torch.where(info[..., None, None] > 0, torch.full_like(L, float("nan")), L)


def cholesky_plain(K):
    """Plain lower Cholesky factor: ``cholesky_ex``, NaN where it fails.
    Reads only the lower triangle of ``K``."""
    L, info = torch.linalg.cholesky_ex(K)
    return _nan_where_failed(L, info)


def _check_square(name, Kp):
    if not Kp.is_cuda or Kp.dtype != torch.float32 or Kp.dim() != 2 or not Kp.is_contiguous():
        raise ValueError(
            f"{name} takes a contiguous 2-D CUDA float32 Kp; got {Kp.dim()}-D {Kp.dtype} "
            f"on {Kp.device}")
    if Kp.shape[0] != Kp.shape[1] or Kp.shape[0] % BLOCK or Kp.shape[0] == 0:
        raise ValueError(f"bad shape: Kp {tuple(Kp.shape)} (square, side a multiple of {BLOCK})")
    if Kp.data_ptr() % 16:
        raise ValueError("Kp must be 16-byte aligned (the kernel reads it as float4)")


def cholesky_cuda(Kp):
    """Launch the factor-only mode of ``csrc/chol_solve.cu`` on a CUDA
    float32 ``Kp`` (Np, Np), Np a multiple of 64, factored in place: its
    lower triangle becomes L, with the diagonal blocks' upper entries 0;
    strictly-upper entries outside the diagonal blocks keep what they held.
    Returns ``Kp``."""
    _check_square("cholesky_cuda", Kp)
    Np = Kp.shape[0]
    work = torch.empty(Np, dtype=torch.float64, device=Kp.device)  # the f64 pivots
    lib = _build.load_library()
    code = lib.gfs_cholesky(Kp.data_ptr(), Np, work.data_ptr(), _build.stream_of(Kp))
    _build.check(lib, code, "cholesky")
    cholesky_cuda.launches += 1
    return Kp


cholesky_cuda.launches = 0


def _factor_padded(K):
    """``tril(chol(K))`` through the padded in-place factorization: ``K``
    is copied into a (Np, Np) buffer with a unit-diagonal extension (Np the
    next multiple of 64), the buffer is factored in place, and the result
    is the masked leading block, a view into the buffer (row stride Np)."""
    N = K.shape[0]
    Np = N + (-N) % BLOCK
    # contiguous: a zero pad keeps K's strides, and the kernel reads rows
    Kp = F.pad(K, (0, Np - N, 0, Np - N)).contiguous()
    Kp.diagonal()[N:] = 1.0
    if Kp.device.type == "cpu":  # plain for CPU tensors; launch or raise otherwise
        Kp.copy_(cholesky_plain(Kp))
    else:
        cholesky_cuda(Kp)
    return Kp[:N, :N].tril_()


# refinement steps of the Cholesky VJP's float32 solves: each multiplies
# the solve's error by ~cond(U) x 6e-8, so one reaches the float32 rounding
# of the VJP's output at cond(K) ~1e6 (tests/test_torch_ops.py)
REFINE_STEPS = 1


def _solve_upper_refined(U, B):
    """``U^-1 B`` to float64 accuracy for a float32 triangle ``U`` and a
    float64 ``B``: the TRSM's Function in float32, then ``REFINE_STEPS``
    steps of iterative refinement on float64 residuals ``B - U X``."""
    U64 = U.double()
    X = _trsm.solve_upper(U, B.float()).double()
    for _ in range(REFINE_STEPS):
        X = X + _trsm.solve_upper(U, (B - U64 @ X).float()).double()
    return X


def _chol_vjp(L, g):
    # Murray (2016), as `_chol_vjp_bwd` of the JAX package: the full
    # symmetric K-bar (a lower-only one doubles the off-diagonal gradient).
    # The two solves go through the TRSM's Function, read on L's transposed
    # view: the wide TRSM kernel on a CUDA tensor, its plain version on a
    # CPU one, never a library solve on the card.
    #
    # For a float32 factor it runs in float64: products in float64, the
    # solves refined to float64 accuracy (`_solve_upper_refined`). In
    # float32 it put SGPR's inducing-point gradient (BASELINE config #2)
    # further off the f64 path than autograd's float32 Cholesky backward
    # does, in float64 ten times closer (tools/sgpr_zgrad.py on an H100).
    dtype = L.dtype
    refine = dtype == torch.float32
    solve = _solve_upper_refined if refine else _trsm.solve_upper
    L = torch.tril(L)
    Lt = L.mT
    if refine:
        L, g = L.double(), g.double()
    Lbar = torch.tril(g)
    P = L.mT @ Lbar
    P = torch.tril(P) - 0.5 * torch.diag_embed(torch.diagonal(P))
    X = solve(Lt, P + P.mT)
    S = solve(Lt, X.mT.contiguous())
    return (0.25 * (S + S.mT)).to(dtype)


class _Cholesky(torch.autograd.Function):
    """Forward: the padded factor-only Cholesky (kernel or plain). Backward:
    ``_chol_vjp_bwd`` of the JAX package: two triangular solves on the
    factor's transposed view through ``ops.trsm`` (the TRSM kernel on a
    CUDA tensor) and matrix products, in float64 for a float32 factor (the
    JAX package computes the whole VJP with plain XLA ops). ``vmap``: the
    Function on each matrix of the batch."""

    @staticmethod
    def forward(K):
        return _factor_padded(K)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (L,) = ctx.saved_tensors
        return _chol_vjp(L, g)

    @staticmethod
    def vmap(info, in_dims, K):
        return vmap_loop(_Cholesky.apply, info, in_dims, K)


def cholesky(K):
    """Differentiable lower Cholesky factor of ``K`` (N, N), the masked
    ``tril(L)`` of ``pallas_cholesky.cholesky``. Only the lower triangle of
    ``K`` is read; a failed factorization gives NaN."""
    return _Cholesky.apply(K)


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
    _check_square("cholesky_solve_cuda", Kp)
    if not Dp.is_cuda or Dp.dtype != torch.float32 or Dp.dim() != 2 or not Dp.is_contiguous():
        raise ValueError(
            f"cholesky_solve_cuda takes a contiguous 2-D CUDA float32 Dp; got {Dp.dim()}-D "
            f"{Dp.dtype} on {Dp.device}")
    Np = Kp.shape[0]
    P = Dp.shape[1]
    if Dp.shape[0] != Np or P < 1:
        raise ValueError(f"bad shape: Dp {tuple(Dp.shape)} (Np = {Np} rows, at least one column)")
    if Dp.device != Kp.device:
        raise ValueError(f"Kp on {Kp.device} but Dp on {Dp.device}")
    alpha = Dp.clone()
    # f64 scratch: per-panel logdet partials, then the f64 pivots
    work = torch.empty(Np // BLOCK + Np, dtype=torch.float64, device=Kp.device)
    half_logdet = torch.empty((), dtype=torch.float32, device=Kp.device)
    lib = _build.load_library()
    code = lib.gfs_chol_solve_logdet(Kp.data_ptr(), Np, alpha.data_ptr(), P, work.data_ptr(),
                                     half_logdet.data_ptr(), _build.stream_of(Kp))
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
    """Forward: the fused factor/solve/logdet, in place on ``Kp``
    (``in_place``) or on a copy of it. Outputs ``(Lp, half_logdet, quad,
    alpha)``; ``Lp`` and ``alpha`` are not differentiable. Backward:
    ``_csl_bwd`` of the JAX package, in torch.linalg (the JAX package also
    computes it with plain XLA ops, outside any kernel). ``vmap``: the
    Function on a copy of each system of the batch."""

    @staticmethod
    def forward(Kp, Dp, in_place):
        if not in_place:
            Kp = Kp.clone(memory_format=torch.contiguous_format)
        Lp, alpha, half_logdet = cholesky_solve(Kp, Dp)
        return Lp, half_logdet, torch.sum(torch.square(alpha)), alpha

    @staticmethod
    def setup_context(ctx, inputs, output):
        Lp, _, _, alpha = output
        if inputs[2]:
            ctx.mark_dirty(inputs[0])
        ctx.mark_non_differentiable(Lp, alpha)
        ctx.save_for_backward(Lp, alpha)

    @staticmethod
    def vmap(info, in_dims, Kp, Dp, in_place):
        return vmap_loop(lambda k, d: _CholSolveLogdet.apply(k, d.contiguous(), False), info, in_dims[:2],
                         Kp, Dp)

    @staticmethod
    def backward(ctx, _gL, ghl, gq, _galpha):
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
        return Kbar.to(dtype), Dbar.to(dtype), None


def cholesky_solve_logdet(Kp, Dp):
    """Differentiable ``(half_logdet, quad)`` = ``(sum log diag chol(K),
    ||chol(K)^-1 D||_F^2)``. ``Kp`` is the padded operand (unit-diagonal
    extension) and is overwritten by its factor, except inside a
    ``torch.func`` transform, which factors a copy; ``Dp`` has zero pad
    rows. Both scalars are then exact for the leading system."""
    _, half_logdet, quad, _ = _CholSolveLogdet.apply(Kp, Dp, not transforms_active())
    return half_logdet, quad
