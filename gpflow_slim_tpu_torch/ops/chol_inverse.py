"""The fused Cholesky's VJP: K-bar and D-bar from the factor, in float64.

For ``(half_logdet, quad)`` of the padded system (``ops.cholesky``) with
the factor ``Lp`` and ``alpha = Lp^-1 Dp``, and the cotangents ``ghl``
and ``gq``::

    beta = Lp^-T alpha,   Kbar = 1/2 ghl K^-1 - gq beta beta^T,   Dbar = 2 gq beta,

``K^-1 = Lp^-T Lp^-1`` and ``Kbar`` full and symmetric (the operand's VJP
reads all of it; a lower-only one would double the off-diagonal gradient).
It runs in float64 for a float32 factor: the variance gradient is about
(N - noise tr K^-1) / 2, a difference of two ~N terms, and an f32 K^-1 put
it 1e-2 off the f64 path at N = 10000 (2.7e-5 with an f64 backward of the
same f32 factor; H100, 700 W).

Counterpart of ``_csl_bwd`` in ``gpflow_slim_tpu/ops/pallas_cholesky.py``,
which is plain XLA ops (no TPU kernel). Here it is the hand-written CUDA
kernels of ``csrc/chol_inverse.cu`` (``csl_vjp_cuda``: a triangular inverse
and the lower half of ``W^T W`` on the FP64 tensor cores, the cotangent's
epilogue fused), with its plain PyTorch version beside it
(``csl_vjp_plain``: a solve against the identity and a full product).
``csl_vjp`` takes the plain version for CPU tensors and launches the
kernels for any other, through ``_CslVjp`` so that a backward run under a
``torch.func`` transform hands the kernels plain tensors.
"""

from __future__ import annotations

import torch

from . import _build
from ._func import vmap_loop

BLOCK = 64  # the kernels' tile; Lp's side must be a multiple of it
BETA_CHUNK = 512  # about the rows of W a block of the beta product sums over


def csl_vjp_plain(Lp, alpha, ghl, gq):
    """Plain version: ``torch.linalg.solve_triangular`` for ``beta`` and for
    ``Lp^-1`` against the identity, a full product for ``K^-1``, all in
    float64; reads only the lower triangle of ``Lp``. Returns ``(Kbar,
    Dbar)`` in ``Lp``'s dtype."""
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


def csl_vjp_cuda(Lp, alpha, ghl, gq):
    """Launch ``csrc/chol_inverse.cu`` on CUDA float32 tensors: ``Lp`` (Np,
    Np) contiguous, Np a multiple of 64, its lower triangle the factor
    (nothing above the diagonal blocks is read); ``alpha`` (Np, P), P >= 1;
    ``ghl`` and ``gq`` 0-d. Every product is in float64; ``Kbar`` and
    ``Dbar`` are rounded to float32 once. Scratch: ``W = Lp^-1`` (Np, Np)
    and ``beta`` with its partial sums in float64. Returns ``(Kbar, Dbar)``; no host sync.
    ``csl_vjp_cuda.launches`` counts the calls."""
    for name, t in (("Lp", Lp), ("alpha", alpha), ("ghl", ghl), ("gq", gq)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"csl_vjp_cuda takes CUDA float32 tensors; {name} is {t.dtype} on {t.device}")
        if t.device != Lp.device:
            raise ValueError(f"Lp on {Lp.device} but {name} on {t.device}")
    Np = Lp.shape[0]
    if Lp.dim() != 2 or Lp.shape[1] != Np or Np % BLOCK or Np == 0 or not Lp.is_contiguous():
        raise ValueError(f"bad Lp: {tuple(Lp.shape)}, contiguous {Lp.is_contiguous()} (contiguous, square, "
                         f"side a multiple of {BLOCK})")
    if alpha.dim() != 2 or alpha.shape[0] != Np or alpha.shape[1] < 1 or ghl.dim() or gq.dim():
        raise ValueError(f"bad shapes: alpha {tuple(alpha.shape)} (Np = {Np} rows, at least one column), "
                         f"ghl {tuple(ghl.shape)}, gq {tuple(gq.shape)} (0-d)")
    if Lp.data_ptr() % 16:
        raise ValueError("Lp must be 16-byte aligned (the kernels copy it 16 bytes at a time)")
    alpha = alpha.contiguous()
    P = alpha.shape[1]
    chunks = -(-Np // BETA_CHUNK)  # each block column's sum for beta, split over this many blocks
    W = torch.empty(Np, Np, dtype=torch.float64, device=Lp.device)
    beta = torch.empty(chunks + 1, Np, P, dtype=torch.float64, device=Lp.device)
    Kbar = torch.empty(Np, Np, dtype=torch.float32, device=Lp.device)
    Dbar = torch.empty(Np, P, dtype=torch.float32, device=Lp.device)
    lib = _build.load_library()
    code = lib.gfs_csl_vjp(Lp.data_ptr(), Np, alpha.data_ptr(), P, ghl.data_ptr(), gq.data_ptr(), W.data_ptr(),
                           beta.data_ptr(), chunks, Kbar.data_ptr(), Dbar.data_ptr(), _build.stream_of(Lp))
    _build.check(lib, code, "csl_vjp")
    csl_vjp_cuda.launches += 1
    return Kbar, Dbar


csl_vjp_cuda.launches = 0


class _CslVjp(torch.autograd.Function):
    """``csl_vjp_cuda`` as a Function: under a ``torch.func`` transform a
    backward gets wrapped tensors, and only a Function's forward hands a
    kernel plain ones. Not differentiable (no backward). ``vmap``: the
    Function on each entry of the batch."""

    @staticmethod
    def forward(Lp, alpha, ghl, gq):
        return csl_vjp_cuda(Lp, alpha, ghl, gq)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, Lp, alpha, ghl, gq):
        return vmap_loop(lambda l, a, h, q: _CslVjp.apply(l.contiguous(), a, h, q), info, in_dims, Lp, alpha,
                         ghl, gq)


def csl_vjp(Lp, alpha, ghl, gq):
    """``(Kbar, Dbar)`` of the fused factor/solve/logdet (module docstring),
    in ``Lp``'s dtype. Plain for CPU tensors; any other tensor goes to the
    kernels, which launch or raise."""
    if Lp.device.type == "cpu":
        return csl_vjp_plain(Lp, alpha, ghl, gq)
    return _CslVjp.apply(Lp, alpha, ghl, gq)
