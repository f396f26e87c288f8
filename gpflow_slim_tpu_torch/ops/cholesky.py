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

``syrk`` picks the arithmetic of the trailing update, by the TPU kernel's
names (``SYRK_MODES``; ``True``/``False`` stand for ``"s3"``/``"hi"``):

- ``"hi"`` (the default everywhere): exact float32 products;
- ``"s3"``/``"s4"``: each float32 operand of the trailing product is split
  into ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, and the product is the
  float32 sum of hh + hl + lh (+ ll for ``"s4"``), each a product of bf16
  values (``split_product_plain``); on the card the bf16 tensor cores
  compute them;
- a ``"d"`` suffix keeps the diagonal tiles of each trailing update
  (128 x 128 in the kernel) exact; only the off-diagonal ones take the split;
- an ``"x2"`` suffix names the TPU kernel's two-panel schedule, the same
  arithmetic in another order, whose purpose (halving the trailing
  update's traffic) the kernel's 256-wide panels already serve: ``"s4x2"``
  runs what ``"s4"`` runs.

In every mode the panels are factored exactly and the diagonal entries
(the pivots) take exact products, as the kernel's float64 pivots do. Here
the port's "s3"/"s4" differ from the TPU kernel's, whose update splits the
whole diagonal block, its diagonal entries included; the plain split
versions take that form with ``exact_pivots=False``. The plain split
versions, ``cholesky_split_plain`` and ``cholesky_solve_split_plain``,
apply each panel's product 64 inner indices at a time, as the kernel adds
them to its tile; a CPU tensor takes them for a split mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.trace import named_scope
from . import _build
from . import chol_inverse as _inverse
from . import trsm as _trsm
from ._func import loop_vmap, transforms_active
from .gram import full_precision

BLOCK = 64  # the kernel's block size; Kp's side must be a multiple of it
PANEL = 256  # the kernel's outer panel: one trailing update per panel
TILE = 128  # the trailing update's output tile; "d" keeps its diagonal tiles exact
SYRK_BASES = ("hi", "s3", "s4", "s3d", "s4d")
SYRK_MODES = SYRK_BASES + tuple(b + "x2" for b in SYRK_BASES)
# the mode argument of the C entry points: the split's passes (0 for exact
# products), + 8 for exact diagonal tiles
_MODE_CODES = {"hi": 0, "s3": 3, "s4": 4, "s3d": 3 + 8, "s4d": 4 + 8}


def padded_size(N):
    """The side of the padded system of N rows: the next multiple of
    ``BLOCK``."""
    return N + (-N) % BLOCK


def pad_system(K, D=None):
    """``(Kp, Dp)``: ``K`` (N, N) copied into an (Np, Np) matrix with a
    unit-diagonal extension, Np = ``padded_size(N)``, and ``D`` (N, P)
    with zero pad rows (None without a ``D``). Its factor is ``chol(K)`` in
    the leading block and the identity in the pad, so the pad rows of
    ``chol(Kp)^-1 Dp`` are exactly zero and the pad's log-diagonal terms
    exactly log 1: the padded system's half-logdet and quad are the leading
    system's."""
    N = K.shape[0]
    Np = padded_size(N)
    # contiguous: a zero pad keeps K's strides, and the kernel reads rows
    Kp = F.pad(K, (0, Np - N, 0, Np - N)).contiguous()
    Kp.diagonal()[N:] = 1.0
    return Kp, None if D is None else pad_rows(D, Np, K.dtype)


def pad_rows(D, Np, dtype):
    """``D`` (N, P) in ``dtype`` with zero rows to Np, contiguous: the
    right-hand side of the padded system."""
    return F.pad(D.to(dtype), (0, 0, 0, Np - D.shape[0])).contiguous()


def _nan_where_failed(L, info):
    # a failed factorization gives NaN, never an exception, as the kernel
    # and the TPU/XLA paths do
    return torch.where(info[..., None, None] > 0, torch.full_like(L, float("nan")), L)


def cholesky_plain(K):
    """Plain lower Cholesky factor: ``cholesky_ex``, NaN where it fails.
    Reads only the lower triangle of ``K``."""
    L, info = torch.linalg.cholesky_ex(K)
    return _nan_where_failed(L, info)


def norm_syrk(syrk):
    """The mode name of ``syrk``: ``True`` is ``"s3"``, ``False`` and
    ``None`` are ``"hi"`` (``_norm_syrk`` of the JAX package); any other
    value must be one of ``SYRK_MODES``."""
    if syrk is True:
        return "s3"
    if syrk is False or syrk is None:
        return "hi"
    if syrk not in SYRK_MODES:
        raise ValueError(f"unknown syrk mode {syrk!r}: one of {SYRK_MODES}, True or False")
    return syrk


def syrk_base(syrk):
    """The arithmetic ``syrk`` runs: its name without the ``"x2"`` suffix."""
    syrk = norm_syrk(syrk)
    return syrk[:-2] if syrk.endswith("x2") else syrk


def bf16_split(x):
    """``(hi, lo)`` in ``x``'s dtype: ``hi = bf16(x)``, ``lo = bf16(x -
    f32(hi))``, both rounded to nearest even (``_bf16_split`` of the JAX
    package; for a float64 ``x`` the difference is taken in float64)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi.to(x.dtype), lo.to(x.dtype)


def split_product_plain(A, B, syrk):
    """``A B^T`` by the split of ``syrk`` (``"s3"``/``"s4"``, any suffix):
    the float32 sum hh + hl + lh (+ ll) of products of the bf16 halves of
    ``A`` and ``B``, each product in float32 with TF32 off (``_dot_nt`` of
    the JAX package). Returns float32."""
    base = syrk_base(syrk)
    if base == "hi":
        raise ValueError("split_product_plain takes a split mode, not 'hi'")
    ah, al = (t.float() for t in bf16_split(A))
    bh, bl = (t.float() for t in bf16_split(B))
    with full_precision():
        prod = ah @ bh.mT + ah @ bl.mT + al @ bh.mT
        if base.startswith("s4"):
            prod = prod + al @ bl.mT
    return prod


def cholesky_split_plain(K, syrk, panel=PANEL, tile=TILE, chunk=BLOCK, exact_pivots=True):
    """Plain blocked right-looking factor of ``K`` in the split mode
    ``syrk``: each ``panel``-wide panel is factored exactly
    (``cholesky_ex``, ``solve_triangular``), then the trailing matrix C
    takes the panel's product ``chunk`` inner indices at a time, as the
    kernel adds each 64 of them to its tile once: ``C - split_product_plain(
    L_q, L_q)`` in C's dtype, L_q the chunk's columns of the panel's rows
    below it (with ``chunk`` = ``panel``, the TPU kernel's one update a
    panel). The diagonal entries (unless ``exact_pivots`` is false, as in
    the TPU kernel), and with a ``"d"`` mode the diagonal ``tile`` x
    ``tile`` blocks, take the exact product instead. Reads only the lower
    triangle of ``K``; returns ``tril(L)``, all NaN where a panel does not
    factor."""
    base = syrk_base(syrk)
    if base == "hi":
        return cholesky_plain(K)
    N = K.shape[0]
    A = torch.tril(K)
    A = A + torch.tril(A, -1).mT  # symmetric from the lower triangle
    L = torch.zeros_like(A)
    t = torch.arange(N, device=K.device) // tile
    for p0 in range(0, N, panel):
        p1 = min(p0 + panel, N)
        Lpp, info = torch.linalg.cholesky_ex(A[p0:p1, p0:p1])
        if int(info) > 0:
            return torch.full_like(K, float("nan"))
        L[p0:p1, p0:p1] = Lpp
        if p1 == N:
            break
        Lr = torch.linalg.solve_triangular(Lpp.mT, A[p1:, p0:p1], upper=True, left=False)
        L[p1:, p0:p1] = Lr
        for q0 in range(0, p1 - p0, chunk):
            Lq = Lr[:, q0:q0 + chunk]
            with full_precision():
                exact = Lq @ Lq.mT
            upd = split_product_plain(Lq, Lq, base).to(A.dtype)
            if base.endswith("d"):
                upd = torch.where(t[p1:, None] == t[None, p1:], exact, upd)
            if exact_pivots:
                upd.diagonal().copy_(exact.diagonal())
            A[p1:, p1:] -= upd
    return torch.tril(L)


def check_padded(fn, name, Kp):
    """Raise unless ``Kp`` is what the kernels factor, or read as a factor:
    contiguous, 16-byte aligned CUDA float32, square, its side a positive
    multiple of ``BLOCK``."""
    _build.check_tensor(fn, name, Kp, 2, aligned=True)
    if Kp.shape[0] != Kp.shape[1] or Kp.shape[0] % BLOCK or Kp.shape[0] == 0:
        raise ValueError(f"bad shape: {name} {tuple(Kp.shape)} (square, side a multiple of {BLOCK})")


def _mode_code(syrk):
    return _MODE_CODES[syrk_base(syrk)]


def cholesky_cuda(Kp, syrk="hi"):
    """Launch the factor-only mode of ``csrc/chol_solve.cu`` on a CUDA
    float32 ``Kp`` (Np, Np), Np a multiple of 64, factored in place: its
    lower triangle becomes L, with the diagonal blocks' upper entries 0;
    strictly-upper entries outside the diagonal blocks keep what they held.
    ``syrk`` is the trailing update's arithmetic (module docstring).
    Counted in ``_build.launches`` as ``"gfs_cholesky"`` and
    ``("gfs_cholesky", syrk_base(syrk))``. Returns ``Kp``."""
    check_padded("cholesky_cuda", "Kp", Kp)
    base = syrk_base(syrk)
    Np = Kp.shape[0]
    work = torch.empty(Np, dtype=torch.float64, device=Kp.device)  # the f64 pivots
    _build.launch("gfs_cholesky", Kp.data_ptr(), Np, work.data_ptr(), _MODE_CODES[base], on=Kp, detail=base)
    return Kp


def _factor_padded(K, syrk="hi"):
    """``tril(chol(K))`` through the padded in-place factorization: ``K``
    is copied into its padded system (``pad_system``), the buffer is
    factored in place, and the result is the masked leading block, a view
    into the buffer (row stride Np)."""
    N = K.shape[0]
    Kp, _ = pad_system(K)
    if Kp.device.type == "cpu":  # plain for CPU tensors; launch or raise otherwise
        Kp.copy_(cholesky_split_plain(Kp, syrk))
    else:
        cholesky_cuda(Kp, syrk)
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


@loop_vmap
class _Cholesky(torch.autograd.Function):
    """Forward: the padded factor-only Cholesky (kernel or plain). Backward:
    ``_chol_vjp_bwd`` of the JAX package: two triangular solves on the
    factor's transposed view through ``ops.trsm`` (the TRSM kernel on a
    CUDA tensor) and matrix products, in float64 for a float32 factor (the
    JAX package computes the whole VJP with plain XLA ops). ``vmap``: the
    Function on each matrix of the batch. ``syrk`` is not differentiable,
    and the backward does not depend on it (nor does the JAX package's)."""

    @staticmethod
    def forward(K, syrk):
        with named_scope("gfs.cholesky.fwd"):
            return _factor_padded(K, syrk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (L,) = ctx.saved_tensors
        with named_scope("gfs.cholesky.bwd"):
            return _chol_vjp(L, g), None


def cholesky(K, syrk="hi"):
    """Differentiable lower Cholesky factor of ``K`` (N, N), the masked
    ``tril(L)`` of ``pallas_cholesky.cholesky``, its trailing updates in
    the arithmetic ``syrk`` (module docstring). Only the lower triangle of
    ``K`` is read; a failed factorization gives NaN."""
    return _Cholesky.apply(K, norm_syrk(syrk))


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


def cholesky_solve_split_plain(Kp, Dp, syrk, panel=PANEL, tile=TILE, chunk=BLOCK, exact_pivots=True):
    """Plain version of the fused kernel in a split mode:
    ``cholesky_split_plain``, ``solve_triangular``, sum log diag. Reads
    only the lower triangle of ``Kp``, then overwrites ``Kp`` with the
    factor. Returns ``(Kp, alpha, half_logdet)`` like the kernel."""
    L = cholesky_split_plain(Kp, syrk, panel, tile, chunk, exact_pivots)
    alpha = torch.linalg.solve_triangular(L, Dp, upper=False)
    half_logdet = torch.sum(torch.log(torch.diagonal(L)))
    Kp.copy_(L)
    return Kp, alpha, half_logdet


def cholesky_solve_cuda(Kp, Dp, syrk="hi"):
    """Launch ``csrc/chol_solve.cu`` on CUDA float32 tensors.

    ``Kp`` (Np, Np), Np a multiple of 64, is factored in place (its lower
    triangle becomes L; strictly-upper entries outside the diagonal blocks
    keep whatever they held). ``Dp`` (Np, P), any P >= 1, is not modified.
    ``syrk`` as for ``cholesky_cuda``; counted in ``_build.launches`` as
    ``"gfs_chol_solve_logdet"`` and ``("gfs_chol_solve_logdet",
    syrk_base(syrk))``. Returns ``(Kp, alpha, half_logdet)``.
    """
    check_padded("cholesky_solve_cuda", "Kp", Kp)
    base = syrk_base(syrk)
    _build.check_tensor("cholesky_solve_cuda", "Dp", Dp, 2, on=Kp)
    Np, P = Kp.shape[0], Dp.shape[1]
    if Dp.shape[0] != Np or P < 1:
        raise ValueError(f"bad shape: Dp {tuple(Dp.shape)} (Np = {Np} rows, at least one column)")
    alpha = Dp.clone()
    # f64 scratch: per-panel logdet partials, then the f64 pivots
    work = torch.empty(Np // BLOCK + Np, dtype=torch.float64, device=Kp.device)
    half_logdet = torch.empty((), dtype=torch.float32, device=Kp.device)
    _build.launch("gfs_chol_solve_logdet", Kp.data_ptr(), Np, alpha.data_ptr(), P, work.data_ptr(),
                  half_logdet.data_ptr(), _MODE_CODES[base], on=Kp, detail=base)
    return Kp, alpha, half_logdet


def cholesky_solve(Kp, Dp, syrk="hi"):
    """``(Lp, alpha, half_logdet)`` of the padded system, factoring ``Kp``
    in place, its trailing updates in the arithmetic ``syrk``. Plain for
    CPU tensors; any other tensor goes to the kernel, which launches or
    raises. Whether the kernels are wanted at all is decided once, by
    ``ops.linalg.kernels_active``."""
    if Kp.device.type == "cpu":
        if syrk_base(syrk) == "hi":
            return cholesky_solve_plain(Kp, Dp)
        return cholesky_solve_split_plain(Kp, Dp, syrk)
    return cholesky_solve_cuda(Kp, Dp, syrk)


@loop_vmap(pin={2: False})
class _CholSolveLogdet(torch.autograd.Function):
    """Forward: the fused factor/solve/logdet, in place on ``Kp``
    (``in_place``) or on a copy of it. Outputs ``(Lp, half_logdet, quad,
    alpha)``; ``Lp`` and ``alpha`` are not differentiable. Backward:
    ``_csl_bwd`` of the JAX package (plain XLA ops there), whatever
    ``syrk``: ``ops.chol_inverse.csl_vjp``, the kernels of
    ``csrc/chol_inverse.cu`` on a CUDA tensor, torch.linalg on a CPU one.
    ``vmap``: the Function on a copy of each system of the batch (never in
    place)."""

    @staticmethod
    def forward(Kp, Dp, in_place, syrk):
        with named_scope("gfs.chol_solve_logdet.fwd"):
            if not in_place:
                Kp = Kp.clone(memory_format=torch.contiguous_format)
            Lp, alpha, half_logdet = cholesky_solve(Kp, Dp, syrk)
            return Lp, half_logdet, torch.sum(torch.square(alpha)), alpha

    @staticmethod
    def setup_context(ctx, inputs, output):
        Lp, _, _, alpha = output
        if inputs[2]:
            ctx.mark_dirty(inputs[0])
        ctx.mark_non_differentiable(Lp, alpha)
        ctx.save_for_backward(Lp, alpha)

    @staticmethod
    def backward(ctx, _gL, ghl, gq, _galpha):
        # d(half_logdet)/dK = K^-1 / 2; quad = D^T K^-1 D, so dquad/dK =
        # -beta beta^T and dquad/dD = 2 beta with beta = K^-1 D = L^-T alpha:
        # ops.chol_inverse, in float64, the full symmetric K-bar
        Lp, alpha = ctx.saved_tensors
        with named_scope("gfs.chol_solve_logdet.bwd"):
            return (*_inverse.csl_vjp(Lp, alpha, ghl, gq), None, None)


def cholesky_solve_logdet(Kp, Dp, syrk="hi"):
    """Differentiable ``(half_logdet, quad)`` = ``(sum log diag chol(K),
    ||chol(K)^-1 D||_F^2)``, the factor's trailing updates in the
    arithmetic ``syrk`` (module docstring). ``Kp`` is the padded operand
    (unit-diagonal extension) and is overwritten by its factor, except
    inside a ``torch.func`` transform, which factors a copy; ``Dp`` has
    zero pad rows. Both scalars are then exact for the leading system."""
    _, half_logdet, quad, _ = _CholSolveLogdet.apply(Kp, Dp, not transforms_active(), norm_syrk(syrk))
    return half_logdet, quad
