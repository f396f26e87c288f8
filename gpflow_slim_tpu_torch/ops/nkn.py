"""The one-pass Cholesky operand of exact GPR under a Neural Kernel Network
(Sun et al., ICML 2018), and its VJP.

The network is the paper's time-series one (``NET``): 8 primitive kernels,
then Linear(8 -> 8), Product(step 2), Linear(4 -> 4), Product(step 2),
Linear(2 -> 1), no biases. Its primitives are Linear, Periodic,
RationalQuadratic or a stationary kind of ``ops.gram`` (``KINDS``), each
with ARD over D = 1 or 2 inputs. Its parameters travel as one vector
``theta`` (``theta_size(D)`` numbers; ``kernels_nkn.NKN`` packs it): for
primitive k a slot of ``slot(D)`` = 1 + 2 D numbers,
``[var, a_0 .. a_{D-1}, c_0 .. c_{D-1}]``, a_d = 1 / lengthscale_d (or
Linear's ARD variance, whose var is unused), c_d = pi / period_d
(Periodic) or c_0 = alpha (RationalQuadratic), else 0; then the three
weight matrices row-major, (out, in) as ``NKNLinear`` holds them.
``csrc/nkn_operand.cu`` writes the same maps; its ``gfs_nkn_layout``
reports the kind numbers and layer widths it was built for, which the
launches hold to ``layout()``.

- ``nkn_operand_cuda`` (``csrc/nkn_operand.cu``): one launch writes the
  lower triangle of the padded operand ``K_NKN(X, X) + noise I`` with a
  unit-diagonal pad, each entry's primitives and layers in registers;
  plain version ``nkn_operand_plain``.
- ``nkn_vjp_cuda``: one launch reads the cotangent's lower triangle once
  (taken as symmetric), forms each entry again and accumulates every
  parameter's gradient and the noise's (the block's trace), float64 past a
  warp's sums; a second, small launch adds the blocks' float64 partials.
  Plain version ``nkn_vjp_plain``: the same closed form on the whole
  ``[:N, :N]`` block in float64 torch.
- ``_NKNCholOperand``: the two as an autograd Function, the operand's
  contract that of ``ops.gram.gram_chol_operand``; nothing of size N^2 is
  saved for the backward.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.trace import named_scope
from . import _build
from ._func import kernel_function, loop_vmap, on_device
from .gram import KINDS, _check_pad_to, _scalar_on, _unit_map_and_slope, apply_map

# the covered network: ("linear", in, out) and ("product", in, step)
NET = (("linear", 8, 8), ("product", 8, 2), ("linear", 4, 4), ("product", 4, 2), ("linear", 2, 1))
PRIMS = 8
DIMS = (1, 2)  # input dimensions the kernels are built for
# primitive kinds past the stationary maps
RQ, LINEAR, PERIODIC = len(KINDS), len(KINDS) + 1, len(KINDS) + 2
_NAMES = {v: k for k, v in KINDS.items()}
_LINEARS = [(i, o) for kind, i, o in NET if kind == "linear"]


def slot(D):
    """Numbers a primitive takes in ``theta``."""
    return 1 + 2 * D


def theta_size(D):
    return PRIMS * slot(D) + sum(i * o for i, o in _LINEARS)


def layout():
    """What ``gfs_nkn_layout`` reports of the kernels: the primitives, the
    kinds RQ, LINEAR, PERIODIC, and each Linear layer's (in, out)."""
    return (PRIMS, RQ, LINEAR, PERIODIC, *(w for io in _LINEARS for w in io))


def acc_size(D):
    """Float64 numbers ``nkn_vjp_cuda`` returns: the parameters, the noise,
    zeros to a multiple of 32."""
    return -(-(theta_size(D) + 1) // 32) * 32


def _weights(theta, D):
    """The Linear layers' weight matrices, (out, in), from ``theta``."""
    out, at = [], PRIMS * slot(D)
    for i, o in _LINEARS:
        out.append(theta[at:at + o * i].reshape(o, i))
        at += o * i
    return out


def _primitive(X, X2, theta, k, kind, grad):
    """Primitive k's (N, M) Gram between X and X2 and, with ``grad``, its
    derivatives by the slot's numbers (a list of ``slot(D)`` tensors, None
    where 0)."""
    D = X.shape[1]
    b = k * slot(D)
    var, a, c = theta[b], theta[b + 1:b + 1 + D], theta[b + 1 + D:b + 1 + 2 * D]
    dp = [None] * slot(D)
    if kind == LINEAR:
        if grad:
            for d in range(D):
                dp[1 + d] = X[:, None, d] * X2[None, :, d]
        return (X * a) @ X2.T, dp
    delta = X[:, None, :] - X2[None, :, :]  # (N, M, D)
    if kind == PERIODIC:
        sn, cs = torch.sin(c * delta), torch.cos(c * delta)
        q = sn * a
        f = torch.exp(-0.5 * torch.sum(q * q, dim=-1))
        p = var * f
        if grad:
            dp[0] = f
            for d in range(D):
                dp[1 + d] = -p * q[..., d] * sn[..., d]
                dp[1 + D + d] = -p * q[..., d] * a[d] * cs[..., d] * delta[..., d]
        return p, dp
    t = delta * a
    d2 = torch.sum(t * t, dim=-1)
    if kind == RQ:
        alpha = c[0]
        z = d2 * (0.5 / alpha)
        lu = torch.log1p(z)
        f = torch.exp(-alpha * lu)
        slope = -0.5 * f / (1.0 + z)
        if grad:
            dp[1 + D] = var * f * (z / (1.0 + z) - lu)
    elif grad:
        f, slope = _unit_map_and_slope(_NAMES[kind], d2)
    else:
        return apply_map(_NAMES[kind], var, d2), dp
    if grad:
        dp[0] = f
        for d in range(D):
            dp[1 + d] = 2.0 * var * slope * t[..., d] * delta[..., d]
    return var * f, dp


def _forward_layers(A0, W):
    """The layers' pre-product outputs H1, H2 and products A1, A2, and the
    network's value, from the stacked primitives A0 (8, N, M)."""
    H1 = torch.tensordot(W[0], A0, dims=([1], [0]))
    A1 = H1[0::2] * H1[1::2]
    H2 = torch.tensordot(W[1], A1, dims=([1], [0]))
    A2 = H2[0::2] * H2[1::2]
    return H1, A1, H2, A2, torch.tensordot(W[2], A2, dims=([1], [0]))[0]


def nkn_gram_plain(X, theta, kinds, X2=None):
    """Plain ``K_NKN(X, X2)`` from ``theta`` (X2 defaults to X): the (N, M)
    Gram."""
    X2 = X if X2 is None else X2
    A0 = torch.stack([_primitive(X, X2, theta, k, kind, False)[0] for k, kind in enumerate(kinds)])
    return _forward_layers(A0, _weights(theta, X.shape[1]))[-1]


def nkn_operand_plain(X, theta, noise, kinds, pad_to):
    """Plain version of the operand kernel: the full ``K_NKN + noise * I`` in
    the leading block, the identity in the pad."""
    N = X.shape[0]
    out = torch.eye(pad_to, dtype=X.dtype, device=X.device)
    out[:N, :N] = nkn_gram_plain(X, theta, kinds) + noise * torch.eye(N, dtype=X.dtype, device=X.device)
    return out


def nkn_vjp_plain(g, X, theta, kinds, rows=None):
    """Plain version of the VJP kernels: ``(gtheta, gnoise)`` of ``sum(g[:N,
    :N] * (K_NKN + noise I))``, in float64, by the closed form the kernel
    writes (the primitives' slot derivatives, the layers' backward), on the
    whole block: equal to the kernel's lower-triangle reading for a
    symmetric g. ``rows``: the block is taken that many rows at a time (the
    sum is linear in g), so the float64 temporaries, ~90 N^2 numbers at
    once (70 GB at N = 10000), hold ~90 rows x N instead."""
    N = X.shape[0]
    X, theta, g = X.double(), theta.double(), g[:N, :N].double()
    step = rows or max(N, 1)
    gtheta = sum((_vjp_rows(g[r:r + step], X[r:r + step], X, theta, kinds) for r in range(0, N, step)),
                 torch.zeros_like(theta))
    return gtheta, torch.sum(torch.diagonal(g))


def _vjp_rows(g, X, X2, theta, kinds):
    """``nkn_vjp_plain``'s gtheta of the (N, M) block g of K_NKN(X, X2)."""
    D = X.shape[1]
    prims = [_primitive(X, X2, theta, k, kind, True) for k, kind in enumerate(kinds)]
    A0 = torch.stack([p for p, _ in prims])
    W = _weights(theta, D)
    H1, A1, H2, A2, _ = _forward_layers(A0, W)
    gW3 = torch.einsum("nm,inm->i", g, A2)[None, :]
    Ab2 = W[2][0][:, None, None] * g
    Hb2 = torch.stack([Ab2 * H2[1::2], Ab2 * H2[0::2]], dim=1).reshape(H2.shape)
    gW2 = torch.einsum("onm,inm->oi", Hb2, A1)
    Ab1 = torch.tensordot(W[1], Hb2, dims=([0], [0]))
    Hb1 = torch.stack([Ab1 * H1[1::2], Ab1 * H1[0::2]], dim=1).reshape(H1.shape)
    gW1 = torch.einsum("onm,inm->oi", Hb1, A0)
    Ab0 = torch.tensordot(W[0], Hb1, dims=([0], [0]))
    zero = theta.new_zeros(())
    gslots = [torch.sum(Ab0[k] * d) if d is not None else zero for k, (_, dp) in enumerate(prims) for d in dp]
    return torch.cat([torch.stack(gslots), gW1.reshape(-1), gW2.reshape(-1), gW3.reshape(-1)])


def _check(name, X, theta, kinds):
    _build.check_tensor(name, "X", X, 2, at_least=(0, 1))
    D = X.shape[1]
    if D not in DIMS:
        raise ValueError(f"{name}: D = {D}; the kernels are built for D in {DIMS}")
    _build.check_tensor(name, "theta", theta, 1, on=X)
    if theta.shape != (theta_size(D),):
        raise ValueError(f"bad shapes: theta {tuple(theta.shape)} (a vector of {theta_size(D)})")
    if len(kinds) != PRIMS or not all(0 <= int(k) <= PERIODIC for k in kinds):
        raise ValueError(f"{name}: kinds {kinds} (8 kinds, each 0..{PERIODIC})")
    return D


def _kinds_arg(kinds):
    return (ctypes.c_int * PRIMS)(*(int(k) for k in kinds))


def _library(name):
    """The kernels' library, its ``gfs_nkn_layout`` held to ``layout()``
    once."""
    lib = _build.load_library()
    if not getattr(lib, "nkn_layout_checked", False):
        want = layout()
        got = (ctypes.c_int * len(want))()
        n = lib.gfs_nkn_layout(got, len(want))
        if n != len(want) or tuple(got) != want:
            raise RuntimeError(f"{name}: csrc/nkn_operand.cu is built for the layout {tuple(got)[:n]}, "
                               f"ops.nkn's is {want}")
        lib.nkn_layout_checked = True
    return lib


def nkn_operand_cuda(X, theta, noise, kinds, pad_to):
    """Launch ``csrc/nkn_operand.cu``'s forward on CUDA float32 tensors:
    ``X`` (N, D), ``theta``, ``noise`` (a scalar, on X's device), ``kinds``
    (8 ints). Returns a (pad_to, pad_to) matrix whose lower triangle is
    ``K_NKN + noise * I`` with the unit-diagonal pad; entries above the
    diagonal outside its 8 x 8 diagonal blocks are left as ``torch.empty``
    made them. ``pad_to`` is a multiple of 4 and at least N."""
    D = _check("nkn_operand_cuda", X, theta, kinds)
    N = X.shape[0]
    _check_pad_to(X, pad_to)
    nz = _scalar_on(noise, X)
    out = X.new_empty((pad_to, pad_to))
    _library("nkn_operand_cuda")
    _build.launch("gfs_nkn_operand", X.data_ptr(), N, D, theta.data_ptr(), theta.numel(), _kinds_arg(kinds),
                  nz.data_ptr(), pad_to, out.data_ptr(), on=X)
    return out


def nkn_vjp_cuda(g, X, theta, kinds):
    """Launch ``csrc/nkn_operand.cu``'s VJP on CUDA float32 tensors: ``g``
    (at least N x N, unit column stride; its leading block's lower triangle
    is read and taken as symmetric). Returns ``(gtheta, gnoise)`` in float64;
    no host sync."""
    D = _check("nkn_vjp_cuda", X, theta, kinds)
    N = X.shape[0]
    _build.check_tensor("nkn_vjp_cuda", "g", g, 2, layout="rows", on=X, at_least=(N, N))
    n_partial = _library("nkn_vjp_cuda").gfs_nkn_vjp_scratch(N, D)
    partial = torch.empty(n_partial, dtype=torch.float64, device=X.device)
    out = torch.empty(acc_size(D), dtype=torch.float64, device=X.device)
    _build.launch("gfs_nkn_vjp", X.data_ptr(), N, D, theta.data_ptr(), theta.numel(), _kinds_arg(kinds), g.data_ptr(),
                  g.stride(0), partial.data_ptr(), n_partial, out.data_ptr(), on=X)
    n = theta_size(D)
    return out[:n], out[n]


# ``(gtheta, gnoise)`` in float64: plain for CPU tensors, the kernels for any other
nkn_vjp = kernel_function(nkn_vjp_plain, nkn_vjp_cuda, at=1)
_nkn_operand = on_device(nkn_operand_plain, nkn_operand_cuda)


@loop_vmap
class _NKNCholOperand(torch.autograd.Function):
    """Forward: the operand (kernel or plain). Backward: ``nkn_vjp`` on the
    cotangent's ``[:N, :N]`` block, in float64 for float32 inputs (the
    cotangent comes from the fused Cholesky's float64 backward), rounded to
    the inputs' dtype once. Saves X, theta and noise only. X takes no
    gradient (``NKN.gram_chol_operand`` leaves an X that needs one to the
    composite route)."""

    @staticmethod
    def forward(X, theta, noise, kinds, pad_to):
        with named_scope("gfs.nkn_operand.fwd"):
            return _nkn_operand(X, theta, noise, kinds, pad_to)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.kinds = inputs[3]
        ctx.save_for_backward(*inputs[:3])

    @staticmethod
    def backward(ctx, g):
        X, theta, noise = ctx.saved_tensors
        with named_scope("gfs.nkn_operand.bwd"):
            # the kernel reads g's rows in place
            gtheta, gnoise = nkn_vjp(g if g.stride(-1) == 1 else g.contiguous(), X, theta, ctx.kinds)
            return None, gtheta.to(theta.dtype), gnoise.reshape(noise.shape).to(noise.dtype), None, None


def nkn_chol_operand(X, theta, noise, kinds, pad_to):
    """Differentiable one-pass Cholesky operand of ``K_NKN(X, X) + noise *
    I``, padded to ``pad_to`` with a unit diagonal; only its lower triangle
    is specified (``nkn_operand_cuda``). Gradients flow to ``theta`` and
    ``noise``."""
    noise = torch.as_tensor(noise, dtype=X.dtype, device=X.device)
    return _NKNCholOperand.apply(X, theta, noise, tuple(int(k) for k in kinds), pad_to)

