"""Gram matrices of stationary kernels, and the one-pass Cholesky operand.

Counterpart of ``gpflow_slim_tpu/ops/pallas_gram.py``. Its Pallas kernels
become hand-written CUDA kernels, each with its plain PyTorch version
beside it, which the CPU tests run and the card compares against:

- ``_gram_kernel`` (the cross Gram K(Xs, X2s)): ``gram_cuda`` in
  ``csrc/gram.cu``; plain ``gram_reference``;
- ``_gram_lower_kernel`` (the lower-tile Gram): ``gram_lower_cuda`` in
  ``csrc/gram.cu``; plain ``gram_lower_plain``;
- ``_gram_chol_operand_kernel``: ``gram_chol_operand_cuda`` in
  ``csrc/gram_operand.cu``; plain ``gram_chol_operand_plain``.

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
# kind -> id of the ``Kind`` enum in csrc/common.cuh
KINDS = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3, "exponential": 4, "cosine": 5}
TILE = 32  # the output tile of csrc/gram.cu: the lower-tile Gram zeroes whole tiles


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


def gram_lower_plain(kind, Xs, variance):
    """Plain version of the lower-tile Gram: ``K(Xs, Xs)`` with every
    strictly-upper ``TILE`` x ``TILE`` tile zeroed, as the kernel writes it."""
    K = gram_reference(kind, Xs, Xs, variance)
    t = torch.arange(Xs.shape[0], device=Xs.device) // TILE
    return K.masked_fill(t[:, None] < t[None, :], 0.0)


def _check_xs(name, *xs):
    for x in xs:
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2:
            raise ValueError(
                f"{name} takes 2-D CUDA float32 inputs; got {x.dim()}-D {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")
        if x.shape[1] < 1:
            raise ValueError(f"{name}: inputs need at least one column, got {tuple(x.shape)}")


def _variance_on(variance, x):
    # a float32 scalar on x's device (no copy when it is one already)
    return torch.as_tensor(variance, dtype=torch.float32, device=x.device).reshape(1)


def gram_cuda(kind, Xs, X2s, variance):
    """Launch the cross-Gram kernel of ``csrc/gram.cu`` on CUDA float32
    tensors: returns the (N, M) ``K(Xs, X2s)``. ``gram_cuda.launches``
    counts every launch, and ``gram_cuda.by_shape`` the launches of each
    (N, M)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _check_xs("gram_cuda", Xs, X2s)
    (N, D), M = Xs.shape, X2s.shape[0]
    if X2s.shape[1] != D or X2s.device != Xs.device:
        raise ValueError(f"bad inputs: Xs {tuple(Xs.shape)} on {Xs.device}, "
                         f"X2s {tuple(X2s.shape)} on {X2s.device}")
    var = _variance_on(variance, Xs)
    out = torch.empty((N, M), dtype=torch.float32, device=Xs.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    code = lib.gfs_gram(Xs.data_ptr(), N, X2s.data_ptr(), M, D, var.data_ptr(), KINDS[kind],
                        out.data_ptr(), stream)
    _build.check(lib, code, "gram")
    gram_cuda.launches += 1
    gram_cuda.by_shape[(N, M)] = gram_cuda.by_shape.get((N, M), 0) + 1
    return out


gram_cuda.launches = 0
gram_cuda.by_shape = {}


def gram_lower_cuda(kind, Xs, variance):
    """Launch the lower-tile Gram kernel of ``csrc/gram.cu`` on a CUDA
    float32 tensor: the (N, N) ``K(Xs, Xs)`` on and below the diagonal
    tiles, zero in the strictly-upper ``TILE`` x ``TILE`` tiles."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _check_xs("gram_lower_cuda", Xs)
    N, D = Xs.shape
    var = _variance_on(variance, Xs)
    out = torch.empty((N, N), dtype=torch.float32, device=Xs.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    code = lib.gfs_gram_lower(Xs.data_ptr(), N, D, var.data_ptr(), KINDS[kind], out.data_ptr(),
                              stream)
    _build.check(lib, code, "gram_lower")
    gram_lower_cuda.launches += 1
    return out


gram_lower_cuda.launches = 0


def _gram_vjp(kind, g, Xs, X2s, variance):
    # the VJP of the plain composite, by recomputation (`_bwd` and
    # `_lower_bwd` of the JAX package)
    with torch.enable_grad():
        a = Xs.detach().requires_grad_()
        b = a if X2s is None else X2s.detach().requires_grad_()
        v = variance.detach().requires_grad_()
        inputs = (a, v) if X2s is None else (a, b, v)
        return torch.autograd.grad(gram_reference(kind, a, b, v), inputs, g)


class _Gram(torch.autograd.Function):
    """Forward: the cross Gram (kernel or plain). Backward: ``_bwd`` of the
    JAX package, the VJP of the plain composite by recomputation."""

    @staticmethod
    def forward(ctx, kind, Xs, X2s, variance):
        ctx.kind = kind
        ctx.save_for_backward(Xs, X2s, variance)
        if Xs.device.type == "cpu":  # plain for CPU tensors; launch or raise otherwise
            return gram_reference(kind, Xs, X2s, variance)
        return gram_cuda(kind, Xs, X2s, variance)

    @staticmethod
    def backward(ctx, g):
        return (None, *_gram_vjp(ctx.kind, g, *ctx.saved_tensors))


class _GramLower(torch.autograd.Function):
    """Forward: the lower-tile Gram (kernel or plain). Backward:
    ``_lower_bwd`` of the JAX package, the full composite's VJP, exact for
    consumers that read only the lower triangle. It saves its inputs, not
    its output, so a caller may add to the output in place."""

    @staticmethod
    def forward(ctx, kind, Xs, variance):
        ctx.kind = kind
        ctx.save_for_backward(Xs, variance)
        if Xs.device.type == "cpu":
            return gram_lower_plain(kind, Xs, variance)
        return gram_lower_cuda(kind, Xs, variance)

    @staticmethod
    def backward(ctx, g):
        Xs, variance = ctx.saved_tensors
        return (None, *_gram_vjp(ctx.kind, g, Xs, None, variance))


def stationary_gram(kind, Xs, X2s, variance):
    """Differentiable ``K(Xs, X2s)`` from pre-scaled inputs
    (``Xs = X / lengthscales``; lengthscale gradients flow through that
    scaling, outside this function)."""
    variance = torch.as_tensor(variance, dtype=Xs.dtype, device=Xs.device)
    return _Gram.apply(kind, Xs, X2s, variance)


def stationary_gram_lower(kind, Xs, variance):
    """Differentiable lower-tile ``K(Xs, Xs)``: equal to the Gram on and
    below the diagonal, zero in the strictly-upper tiles. For consumers
    that read only the lower triangle (``ops.linalg.cholesky``)."""
    variance = torch.as_tensor(variance, dtype=Xs.dtype, device=Xs.device)
    return _GramLower.apply(kind, Xs, variance)


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

    Returns a (pad_to, pad_to) float32 matrix whose lower triangle holds
    ``K + noise * I`` with the unit-diagonal pad extension. Entries above
    the diagonal outside its 8 x 8 diagonal blocks are left as
    ``torch.empty`` made them: consumers read only the lower triangle.
    ``pad_to`` is a multiple of 4 (the kernel stores 16-byte runs of a row).
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if pad_to < Xs.shape[0] or pad_to % 4:
        raise ValueError(f"bad shapes: Xs {tuple(Xs.shape)}, pad_to {pad_to} (at least N, a multiple of 4)")
    _check_xs("gram_chol_operand_cuda", Xs)
    N, D = Xs.shape
    var, nz = _variance_on(variance, Xs), _variance_on(noise, Xs)
    out = torch.empty((pad_to, pad_to), dtype=torch.float32, device=Xs.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    code = lib.gfs_gram_chol_operand(
        Xs.data_ptr(), N, D, var.data_ptr(), nz.data_ptr(), KINDS[kind], pad_to, out.data_ptr(), stream)
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
