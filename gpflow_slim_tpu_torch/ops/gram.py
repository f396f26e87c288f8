"""Gram matrices of stationary kernels, and the one-pass Cholesky operand.

Counterpart of ``gpflow_slim_tpu/ops/pallas_gram.py``. The Pallas kernel
``_gram_chol_operand_kernel`` becomes the hand-written CUDA kernel in
``csrc/gram_operand.cu``; beside it stands its plain PyTorch version
(``gram_chol_operand_plain``), which the CPU tests run and the card
compares against.

Maps (static ``kind``), with r = sqrt(d^2 + 1e-12):
  rbf:         var * exp(-d^2 / 2)
  matern12:    var * exp(-r)
  matern32:    var * (1 + sqrt3 r) exp(-sqrt3 r)
  matern52:    var * (1 + sqrt5 r + 5 d^2 / 3) exp(-sqrt5 r)
  exponential: var * exp(-r / 2)   (the GPflow-1.x constant)
  cosine:      var * cos(r)
"""

from __future__ import annotations

import math

import torch

from . import _build

EUCLID_EPS = 1e-12
# kind -> id of the ``Kind`` enum in csrc/gram_operand.cu
KINDS = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3, "exponential": 4, "cosine": 5}


def apply_map(kind, variance, d2):
    if kind == "rbf":
        return variance * torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + EUCLID_EPS)
    if kind == "matern12":
        return variance * torch.exp(-r)
    if kind == "matern32":
        s3 = math.sqrt(3.0)
        return variance * (1.0 + s3 * r) * torch.exp(-s3 * r)
    if kind == "matern52":
        s5 = math.sqrt(5.0)
        return variance * (1.0 + s5 * r + 5.0 / 3.0 * d2) * torch.exp(-s5 * r)
    if kind == "exponential":
        return variance * torch.exp(-0.5 * r)
    if kind == "cosine":
        return variance * torch.cos(r)
    raise ValueError(f"unknown kind {kind!r}")


def square_dist(Xs, X2s):
    """Pairwise squared distance of pre-scaled inputs by the ||x||^2 -
    2 x.y + ||y||^2 expansion, clamped at 0. The cross product runs in full
    precision: the package never enables TF32."""
    xs = torch.sum(torch.square(Xs), dim=-1)
    ys = torch.sum(torch.square(X2s), dim=-1)
    return torch.clamp(xs[:, None] - 2.0 * (Xs @ X2s.T) + ys[None, :], min=0.0)


def gram_reference(kind, Xs, X2s, variance):
    """Plain ``K(Xs, X2s)`` from pre-scaled inputs: ``square_dist``, then
    the map."""
    return apply_map(kind, variance, square_dist(Xs, X2s))


def gram_chol_operand_plain(kind, Xs, variance, noise, pad_to):
    """Plain version of the operand kernel: the full ``K + noise * I`` in
    the leading block, the unit diagonal in the pad extension. It writes
    the whole matrix, which the operand's contract allows."""
    N = Xs.shape[0]
    eye = torch.eye(N, dtype=Xs.dtype, device=Xs.device)
    out = torch.eye(pad_to, dtype=Xs.dtype, device=Xs.device)
    out[:N, :N] = gram_reference(kind, Xs, Xs, variance) + noise * eye
    return out


def gram_chol_operand_cuda(kind, Xs, variance, noise, pad_to):
    """Launch ``csrc/gram_operand.cu`` on CUDA float32 tensors.

    Returns a (pad_to, pad_to) float32 matrix whose lower tiles hold
    ``K + noise * I`` with the unit-diagonal pad extension. Its strictly
    upper 32 x 32 tiles are left as ``torch.empty`` made them: consumers
    read only the lower triangle.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if not Xs.is_cuda or Xs.dtype != torch.float32 or Xs.dim() != 2:
        raise ValueError(
            f"gram_chol_operand_cuda takes a 2-D CUDA float32 Xs; got "
            f"{Xs.dim()}-D {Xs.dtype} on {Xs.device}"
        )
    if not Xs.is_contiguous():
        raise ValueError("gram_chol_operand_cuda needs a contiguous Xs")
    N, D = Xs.shape
    if D < 1 or pad_to < N:
        raise ValueError(f"bad shapes: Xs {tuple(Xs.shape)}, pad_to {pad_to}")
    scal = torch.stack([
        torch.as_tensor(variance, dtype=torch.float32, device=Xs.device).reshape(()),
        torch.as_tensor(noise, dtype=torch.float32, device=Xs.device).reshape(()),
    ])
    out = torch.empty((pad_to, pad_to), dtype=torch.float32, device=Xs.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    code = lib.gfs_gram_chol_operand(
        Xs.data_ptr(), N, D, scal.data_ptr(), KINDS[kind], pad_to, out.data_ptr(), stream)
    _build.check(lib, code, "gram_chol_operand")
    gram_chol_operand_cuda.launches += 1
    return out


gram_chol_operand_cuda.launches = 0


def _operand(kind, Xs, variance, noise, pad_to):
    # plain for CPU tensors; any other tensor goes to the kernel, which
    # launches or raises (ops.linalg.kernels_active decides whether the
    # kernels are wanted at all)
    if Xs.device.type == "cpu":
        return gram_chol_operand_plain(kind, Xs, variance, noise, pad_to)
    return gram_chol_operand_cuda(kind, Xs, variance, noise, pad_to)


class _GramCholOperand(torch.autograd.Function):
    """Forward: the operand (kernel or plain). Backward: ``_opnd_bwd`` of the
    JAX package, the VJP of the plain full-Gram + noise * I composite on the
    ``[:N, :N]`` block of the cotangent, by recomputation."""

    @staticmethod
    def forward(ctx, kind, Xs, variance, noise, pad_to):
        ctx.kind = kind
        ctx.save_for_backward(Xs, variance, noise)
        return _operand(kind, Xs, variance, noise, pad_to)

    @staticmethod
    def backward(ctx, g):
        Xs, variance, noise = ctx.saved_tensors
        N = Xs.shape[0]
        with torch.enable_grad():
            a = Xs.detach().requires_grad_()
            v = variance.detach().requires_grad_()
            n = noise.detach().requires_grad_()
            eye = torch.eye(N, dtype=a.dtype, device=a.device)
            K = gram_reference(ctx.kind, a, a, v) + n * eye
            ga, gv, gn = torch.autograd.grad(K, (a, v, n), g[:N, :N])
        return None, ga, gv, gn, None


def gram_chol_operand(kind, Xs, variance, noise, pad_to):
    """Differentiable one-pass Cholesky operand of ``K(Xs, Xs) + noise * I``,
    padded to ``pad_to`` with a unit diagonal (see ``gram_chol_operand_cuda``
    for which entries are specified). ``Xs = X / lengthscales``: gradients
    to the lengthscales flow through that scaling, outside this function."""
    variance = torch.as_tensor(variance, dtype=Xs.dtype, device=Xs.device)
    noise = torch.as_tensor(noise, dtype=Xs.dtype, device=Xs.device)
    return _GramCholOperand.apply(kind, Xs, variance, noise, pad_to)
