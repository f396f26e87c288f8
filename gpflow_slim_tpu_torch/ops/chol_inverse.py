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
kernels for any other, through a Function (``_func.kernel_function``) so
that a backward run under a ``torch.func`` transform hands the kernels
plain tensors.
"""

from __future__ import annotations

import torch

from . import _build
from . import cholesky as _chol  # which imports this module: read at call time
from ._func import kernel_function

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
    and ``beta`` with its partial sums in float64. Returns ``(Kbar, Dbar)``; no host sync."""
    _chol.check_padded("csl_vjp_cuda", "Lp", Lp)
    _build.check_tensor("csl_vjp_cuda", "alpha", alpha, 2, layout=None, on=Lp)
    for name, t in (("ghl", ghl), ("gq", gq)):
        _build.check_tensor("csl_vjp_cuda", name, t, 0, layout=None, on=Lp)
    Np, P = Lp.shape[0], alpha.shape[1]
    if alpha.shape[0] != Np or P < 1:
        raise ValueError(f"bad shapes: alpha {tuple(alpha.shape)} (Np = {Np} rows, at least one column)")
    alpha = alpha.contiguous()
    chunks = -(-Np // BETA_CHUNK)  # each block column's sum for beta, split over this many blocks
    W = torch.empty(Np, Np, dtype=torch.float64, device=Lp.device)
    beta = torch.empty(chunks + 1, Np, P, dtype=torch.float64, device=Lp.device)
    Kbar = torch.empty(Np, Np, dtype=torch.float32, device=Lp.device)
    Dbar = torch.empty(Np, P, dtype=torch.float32, device=Lp.device)
    _build.launch("gfs_csl_vjp", Lp.data_ptr(), Np, alpha.data_ptr(), P, ghl.data_ptr(), gq.data_ptr(), W.data_ptr(),
                  beta.data_ptr(), chunks, Kbar.data_ptr(), Dbar.data_ptr(), on=Lp)
    return Kbar, Dbar


# ``csl_vjp(Lp, alpha, ghl, gq)``: ``(Kbar, Dbar)`` of the fused
# factor/solve/logdet (module docstring), in ``Lp``'s dtype; plain for CPU
# tensors, the kernels for any other
csl_vjp = kernel_function(csl_vjp_plain, csl_vjp_cuda)
