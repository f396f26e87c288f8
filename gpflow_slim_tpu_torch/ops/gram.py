"""Gram matrices of stationary kernels, and the one-pass Cholesky operand.

Counterpart of ``gpflow_slim_tpu/ops/pallas_gram.py``. Its Pallas kernels
become hand-written CUDA kernels, each with its plain PyTorch version
beside it, which the CPU tests run and the card compares against:

- ``_gram_kernel`` (the cross Gram K(Xs, X2s)): ``gram_cuda`` in
  ``csrc/gram.cu``; plain ``gram_reference``;
- ``_gram_lower_kernel`` (the lower-tile Gram): ``gram_lower_cuda`` in
  ``csrc/gram.cu``; plain ``gram_lower_plain``;
- ``_gram_chol_operand_kernel``: ``gram_chol_operand_cuda`` in
  ``csrc/gram_operand.cu``; plain ``gram_chol_operand_plain``;
- the operand's VJP, ``_opnd_bwd`` (XLA ops, no TPU kernel):
  ``gram_operand_vjp_cuda`` in ``csrc/gram_operand.cu``; plain
  ``gram_operand_vjp_plain``.

Maps (static ``kind``), with r = sqrt(d^2 + 1e-12):
  rbf:         var * exp(-d^2 / 2)
  matern12:    var * exp(-r)
  matern32:    var * (1 + sqrt3 r) exp(-sqrt3 r)
  matern52:    var * (1 + sqrt5 r + 5 d^2 / 3) exp(-sqrt5 r)
  exponential: var * exp(-r / 2)   (the GPflow-1.x constant)
  cosine:      var * cos(r)
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..utils.trace import named_scope
from . import _build
from ._func import kernel_function, loop_vmap, on_device

EUCLID_EPS = 1e-12
# kind -> id of the ``Kind`` enum in csrc/common.cuh
KINDS = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3, "exponential": 4, "cosine": 5}
TILE = 32  # the lower-tile Gram of csrc/gram.cu zeroes whole TILE x TILE tiles above the diagonal
S3, S5 = math.sqrt(3.0), math.sqrt(5.0)


def apply_map(kind, variance, d2):
    if kind == "rbf":
        return variance * torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + EUCLID_EPS)
    if kind == "matern12":
        return variance * torch.exp(-r)
    if kind == "matern32":
        return variance * (1.0 + S3 * r) * torch.exp(-S3 * r)
    if kind == "matern52":
        return variance * (1.0 + S5 * r + 5.0 / 3.0 * d2) * torch.exp(-S5 * r)
    if kind == "exponential":
        return variance * torch.exp(-0.5 * r)
    if kind == "cosine":
        return variance * torch.cos(r)
    raise ValueError(f"unknown kind {kind!r}")


def _tf32_enabled():
    matmul = torch.backends.cuda.matmul
    precision = getattr(matmul, "fp32_precision", None)  # the per-backend setting (torch >= 2.9)
    return matmul.allow_tf32 if precision is None else precision == "tf32"


@contextlib.contextmanager
def full_precision():
    """Runs its body with TF32 off for cuBLAS float32 products, whatever the
    process set, and restores the caller's setting on exit (the JAX
    package's ``Precision.HIGHEST``). Switched through the API that set it:
    ``torch.set_float32_matmul_precision`` (or ``allow_tf32``), else the
    per-backend ``fp32_precision``. The setting is the process's: not for
    use from several threads at once."""
    if not _tf32_enabled():
        yield
        return
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError:  # TF32 was turned on through the per-backend setting alone
        saved = None
    if saved is None:
        torch.backends.cuda.matmul.fp32_precision = "ieee"
    else:
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if saved is None:
            torch.backends.cuda.matmul.fp32_precision = "tf32"
        else:
            torch.set_float32_matmul_precision(saved)


def _expansion(Xs, X2s):
    # ||x||^2 - 2 x.y + ||y||^2 before the clamp
    xs = torch.sum(torch.square(Xs), dim=-1)
    ys = torch.sum(torch.square(X2s), dim=-1)
    with full_precision():
        cross = Xs @ X2s.T
    return xs[:, None] - 2.0 * cross + ys[None, :]


def square_dist(Xs, X2s):
    """Pairwise squared distance of pre-scaled inputs by the ||x||^2 -
    2 x.y + ||y||^2 expansion, clamped at 0, as the JAX package's
    ``_gram_reference`` forms it. The cross product runs with TF32 off
    whatever the process set (``full_precision``)."""
    return torch.clamp(_expansion(Xs, X2s), min=0.0)


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


def _scalar_on(value, x):
    # a float32 scalar on x's device, for its address: the tensor itself when
    # it is one already
    if isinstance(value, torch.Tensor) and value.dtype == torch.float32 and value.numel() == 1 \
            and value.get_device() == x.get_device():
        return value
    return torch.as_tensor(value, dtype=torch.float32, device=x.device)


def gram_cuda(kind, Xs, X2s, variance):
    """Launch the cross-Gram kernel of ``csrc/gram.cu`` on CUDA float32
    tensors: returns the (N, M) ``K(Xs, X2s)``. Counted in
    ``_build.launches`` as ``"gfs_gram"`` and ``("gfs_gram", (N, M))``."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _build.check_tensor("gram_cuda", "Xs", Xs, 2, at_least=(0, 1))
    _build.check_tensor("gram_cuda", "X2s", X2s, 2, at_least=(0, 1))
    (N, D), (M, D2) = Xs.shape, X2s.shape
    if D2 != D or X2s.get_device() != Xs.get_device():
        raise ValueError(f"bad inputs: Xs {tuple(Xs.shape)} on {Xs.device}, "
                         f"X2s {tuple(X2s.shape)} on {X2s.device}")
    var = _scalar_on(variance, Xs)
    out = Xs.new_empty((N, M))
    _build.launch("gfs_gram", Xs.data_ptr(), N, X2s.data_ptr(), M, D, var.data_ptr(), KINDS[kind], out.data_ptr(),
                  on=Xs, detail=(N, M))
    return out


def gram_lower_cuda(kind, Xs, variance):
    """Launch the lower-tile Gram kernel of ``csrc/gram.cu`` on a CUDA
    float32 tensor: the (N, N) ``K(Xs, Xs)`` on and below the diagonal
    tiles, zero in the strictly-upper ``TILE`` x ``TILE`` tiles. One launch
    writes 8-row (or, for N below 2112, 1-row) bands of 1024-column sweeps:
    the Gram left of each band's tile-row edge, zero stores alone right of
    it."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _build.check_tensor("gram_lower_cuda", "Xs", Xs, 2, at_least=(0, 1))
    N, D = Xs.shape
    var = _scalar_on(variance, Xs)
    out = Xs.new_empty((N, N))
    _build.launch("gfs_gram_lower", Xs.data_ptr(), N, D, var.data_ptr(), KINDS[kind], out.data_ptr(), on=Xs)
    return out


def _unit_map_and_slope(kind, d2):
    # the map at unit variance, f(d2), and its derivative df/dd2
    if kind == "rbf":
        f = torch.exp(-0.5 * d2)
        return f, -0.5 * f
    r = torch.sqrt(d2 + EUCLID_EPS)  # dr/dd2 = 1 / (2 r)
    if kind == "matern12":
        f = torch.exp(-r)
        return f, -0.5 * f / r
    if kind == "matern32":
        e = torch.exp(-S3 * r)
        return (1.0 + S3 * r) * e, -1.5 * e
    if kind == "matern52":
        e = torch.exp(-S5 * r)
        return (1.0 + S5 * r + 5.0 / 3.0 * d2) * e, -(5.0 / 6.0) * e * (1.0 + S5 * d2 / r)
    if kind == "exponential":
        f = torch.exp(-0.5 * r)
        return f, -0.25 * f / r
    if kind == "cosine":
        return torch.cos(r), -0.5 * torch.sin(r) / r
    raise ValueError(f"unknown kind {kind!r}")


def _gram_vjp(kind, g, Xs, X2s, variance, needs=(True, True, True)):
    """The VJP of the plain composite ``gram_reference`` in closed form:
    ``(gXs, gX2s, gvar)``, or ``(gXs, gvar)`` for the same-input Gram
    (``X2s`` None). ``needs`` masks the three (None where False).

    With G = g * var * f'(d2), where the clamp d2 = max(pre, 0) passes the
    cotangent (1 above 0, 1/2 at 0, as ``jax.lax.max`` splits a tie, 0
    below): gXs = 2 (Xs * rowsum(G) - G X2s), gX2s = 2 (X2s * colsum(G) -
    G^T Xs), both on Xs for the same-input Gram, and gvar = sum(g * f(d2))
    with f the map at unit variance. It is ``_bwd`` / ``_lower_bwd`` of the
    JAX package, written out: no nested autograd graph, and composable
    with ``torch.func``. The products run with TF32 off."""
    same = X2s is None
    Y = Xs if same else X2s
    pre = _expansion(Xs, Y)
    f, slope = _unit_map_and_slope(kind, torch.clamp(pre, min=0.0))
    gvar = torch.sum(g * f).reshape(variance.shape) if needs[2] else None
    gX = gY = None
    if needs[0] or needs[1]:
        cut = (pre > 0).to(pre.dtype) + 0.5 * (pre == 0).to(pre.dtype)
        G = g * (variance * slope) * cut
        with full_precision():
            if needs[0] or same:
                gX = 2.0 * (Xs * torch.sum(G, dim=1, keepdim=True) - G @ Y)
            if needs[1] or same:
                gY = 2.0 * (Y * torch.sum(G, dim=0)[:, None] - G.T @ Xs)
    if same:
        return (gX + gY if needs[0] else None), gvar
    return gX, gY, gvar


_gram_forward = on_device(gram_reference, gram_cuda, at=1)
_gram_lower_forward = on_device(gram_lower_plain, gram_lower_cuda, at=1)


@loop_vmap
class _Gram(torch.autograd.Function):
    """Forward: the cross Gram (kernel or plain). Backward: ``_bwd`` of the
    JAX package in closed form (``_gram_vjp``). ``vmap``: the Function on
    each entry of the batch."""

    @staticmethod
    def forward(kind, Xs, X2s, variance):
        with named_scope("gfs.gram.fwd"):
            return _gram_forward(kind, Xs, X2s, variance)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.kind = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        with named_scope("gfs.gram.bwd"):
            return (None, *_gram_vjp(ctx.kind, g, *ctx.saved_tensors, needs=ctx.needs_input_grad[1:]))


@loop_vmap
class _GramLower(torch.autograd.Function):
    """Forward: the lower-tile Gram (kernel or plain). Backward:
    ``_lower_bwd`` of the JAX package, the full composite's VJP, exact for
    consumers that read only the lower triangle. It saves its inputs, not
    its output, so a caller may add to the output in place."""

    @staticmethod
    def forward(kind, Xs, variance):
        with named_scope("gfs.gram_lower.fwd"):
            return _gram_lower_forward(kind, Xs, variance)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.kind = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        Xs, variance = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with named_scope("gfs.gram_lower.bwd"):
            return (None, *_gram_vjp(ctx.kind, g, Xs, None, variance, needs=(needs[1], False, needs[2])))


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


def _check_pad_to(X, pad_to):
    # the operand kernels store 16-byte runs of a row; checked before the
    # tensors' device
    if pad_to < X.shape[0] or pad_to % 4:
        raise ValueError(f"bad shapes: X {tuple(X.shape)}, pad_to {pad_to} (at least N, a multiple of 4)")


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
    _check_pad_to(Xs, pad_to)
    _build.check_tensor("gram_chol_operand_cuda", "Xs", Xs, 2, at_least=(0, 1))
    N, D = Xs.shape
    var, nz = _scalar_on(variance, Xs), _scalar_on(noise, Xs)
    out = Xs.new_empty((pad_to, pad_to))
    _build.launch("gfs_gram_chol_operand", Xs.data_ptr(), N, D, var.data_ptr(), nz.data_ptr(), KINDS[kind], pad_to,
                  out.data_ptr(), on=Xs)
    return out


def gram_operand_vjp_plain(kind, g, Xs, variance):
    """Plain version of ``gram_operand_vjp_cuda``, and the operand's
    backward on CPU tensors: the ``[:N, :N]`` block of the cotangent ``g``
    widened to float64, ``_gram_vjp`` against ``Xs`` (N, D) and the tensor
    ``variance``, and the block's trace. Returns ``(gXs, gvar, gnoise)`` in
    float64."""
    N = Xs.shape[0]
    g = g[:N, :N].double()
    gX, gvar = _gram_vjp(kind, g, Xs.double(), None, variance.double())
    return gX, gvar, torch.sum(torch.diagonal(g))


def gram_operand_vjp_cuda(kind, g, Xs, variance):
    """Launch the operand's VJP of ``csrc/gram_operand.cu``: the float32
    cotangent ``g`` (at least N x N, rows contiguous, on ``Xs``'s card;
    only its ``[:N, :N]`` block is read, in place) against the operand of
    the CUDA float32 ``Xs`` (N, D) and ``variance``. Returns ``(gXs, gvar,
    gnoise)`` in float32, the last two 0-d; every sum in float64, in a
    fixed order (the same bits from run to run), rounded once. Two launches
    (the tiles, then their reduce), no host sync."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _build.check_tensor("gram_operand_vjp_cuda", "Xs", Xs, 2, at_least=(0, 1))
    N, D = Xs.shape
    _build.check_tensor("gram_operand_vjp_cuda", "g", g, 2, layout="rows", on=Xs, at_least=(N, N))
    var = _scalar_on(variance, Xs)
    partial = torch.empty(_build.load_library().gfs_gram_operand_vjp_scratch(N, D), dtype=torch.float64,
                          device=Xs.device)
    gX = Xs.new_empty((N, D))
    gvar, gnoise = Xs.new_empty(()), Xs.new_empty(())
    _build.launch("gfs_gram_operand_vjp", g.data_ptr(), g.stride(0), Xs.data_ptr(), N, D, var.data_ptr(), KINDS[kind],
                  partial.data_ptr(), partial.numel(), gX.data_ptr(), gvar.data_ptr(), gnoise.data_ptr(), on=Xs)
    return gX, gvar, gnoise


# the operand's VJP: plain for CPU tensors, the kernel for any other
_operand_vjp = kernel_function(gram_operand_vjp_plain, gram_operand_vjp_cuda, at=1)
_operand = on_device(gram_chol_operand_plain, gram_chol_operand_cuda, at=1)


@loop_vmap
class _GramCholOperand(torch.autograd.Function):
    """Forward: the operand (kernel or plain). Backward: ``_opnd_bwd`` of the
    JAX package, the VJP of the plain full-Gram + noise * I composite on the
    ``[:N, :N]`` block of the cotangent, in closed form (the noise takes the
    block's trace), in float64 for float32 inputs: the cotangent comes from
    the fused Cholesky's float64 backward, and the closed form's input
    gradient, which carries the lengthscales', is a difference of two sums
    ~10x its size (Xs * rowsum(G) - G Xs) that float32 loses (12x further
    from the f64 gradient at BASELINE config #4, N=1000, noise 0.05, on the
    CPU). CPU tensors take ``gram_operand_vjp_plain``; any other tensor takes
    ``gram_operand_vjp_cuda`` (through ``_operand_vjp``, a Function), which
    forms the same closed form pair by pair and launches or raises."""

    @staticmethod
    def forward(kind, Xs, variance, noise, pad_to):
        with named_scope("gfs.gram_operand.fwd"):
            return _operand(kind, Xs, variance, noise, pad_to)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.kind = inputs[0]
        ctx.save_for_backward(*inputs[1:4])

    @staticmethod
    def backward(ctx, g):
        Xs, variance, noise = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with named_scope("gfs.gram_operand.bwd"):
            # the kernel reads g's rows in place; float64 from the plain version
            ga, gv, gn = _operand_vjp(ctx.kind, g if g.stride(-1) == 1 else g.contiguous(), Xs, variance)
            return (None, ga.to(Xs.dtype) if needs[1] else None,
                    gv.to(Xs.dtype).reshape(variance.shape) if needs[2] else None,
                    gn.to(Xs.dtype).reshape(noise.shape) if needs[3] else None, None)


def gram_chol_operand(kind, Xs, variance, noise, pad_to):
    """Differentiable one-pass Cholesky operand of ``K(Xs, Xs) + noise * I``,
    padded to ``pad_to`` with a unit diagonal (see ``gram_chol_operand_cuda``
    for which entries are specified). ``Xs = X / lengthscales``: gradients
    to the lengthscales flow through that scaling, outside this function."""
    variance = torch.as_tensor(variance, dtype=Xs.dtype, device=Xs.device)
    noise = torch.as_tensor(noise, dtype=Xs.dtype, device=Xs.device)
    return _GramCholOperand.apply(kind, Xs, variance, noise, pad_to)
