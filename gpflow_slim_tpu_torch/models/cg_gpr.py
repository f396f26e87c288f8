"""GPRCG: exact-GP regression with iterative (CG/SLQ) inference
(counterpart of ``gpflow_slim_tpu.models.cg_gpr``).

The GPyTorch BBMM recipe (Gardner et al. 2018; preconditioning 2021): the
marginal likelihood and its gradients never factorize K.

  forward:  alpha = A^-1 y by (preconditioned) CG, logdet A by SLQ,
            mll = -1/2 y^T alpha - 1/2 logdet A - N/2 log 2 pi
  gradient: dmll/dtheta = 1/2 alpha^T (dA/dtheta) alpha
            - 1/2 (1/P) sum_i u_i^T (dA/dtheta) z_i, with the probe solves
            u_i = A^-1 z_i of the forward pass.

The JAX package writes the gradient as a ``custom_vjp``. The port returns
``mll.detach() + (s - s.detach())``, where the surrogate ``s`` holds the
same quadratic forms with alpha, Z and U detached: its value is the
estimate and autograd's gradient of it is BBMM's, and it reaches every
parameter the kernel reads (a ``DeepKernel``'s warp, NKN weights), which an
``autograd.Function`` cannot return. The surrogate is built only when a
gradient is wanted.

``materialize_k=False`` never forms K: every matvec regenerates K one
4096-row panel at a time (``kern.K(xb, X)``, the cross-Gram kernel on the
kernel route, then a product). The surrogate's panels go through one
autograd Function (``_PanelTerms``) that takes the kernel's parameter
tensors as explicit inputs and calls the kernel on them through
``torch.func.functional_call``; its backward (``_PanelTermsGrad``, a
Function too) regenerates each panel and takes the panel's VJP, as
``jax.checkpoint`` does in the JAX package: no more than one panel is held
in either direction, also under ``vmap``, whose rules take the batch one
entry at a time. Both are in the ``forward`` + ``setup_context`` form with
a ``vmap`` rule (``ops/_func.py``), so they compose with ``torch.func.grad``
and ``vmap``, and ``mcmc`` samples a streaming GPRCG. The alpha solve and
the trace-probe solves share one batched CG (their columns are
independent, so each is the JAX package's solve), and the logdet probes
one batched Lanczos.

The probes come from ``ops.iterative.cg_probes``: redrawn whenever the
hyperparameters move, the same within one evaluation. Predictions solve
against the training system by CG, marginal variances only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..likelihoods import Gaussian
from ..ops import iterative
from ..ops._func import vmap_loop
from .model import GPModel, as_tensor_like

__all__ = ["GPRCG"]

STREAM_BLOCK = 4096


def _make_A_matvec(K, noise):
    return lambda v: K @ v + noise * v


def _stream_block(N):
    # padding a small N up to the whole block would compute mostly pad
    # rows: cap it at N rounded up to 128, as the JAX package does
    return min(STREAM_BLOCK, -(-N // 128) * 128)


def _panels(X, block):
    """X's rows in panels of ``block`` (the last one padded with zero
    rows)."""
    N = X.shape[0]
    Xp = F.pad(X, (0, 0, 0, (-N) % block))
    return Xp.split(block)


def _make_streaming_matvec(kern, X, noise):
    """A v without materializing K: one ``STREAM_BLOCK`` x N Gram panel at a
    time, each used at once (``_StreamMatvec``). Peak memory O(N
    STREAM_BLOCK)."""
    call = _KernelCall(kern)
    named = list(call.named_parameters())
    names, params = tuple(n for n, _ in named), [t for _, t in named]
    block = _stream_block(X.shape[0])

    def mv(v):
        return _StreamMatvec.apply(call, names, block, X, v, *params) + noise * v

    return mv


class _KernelCall(nn.Module):
    """``kern.K(xb, X)`` as a module call, for ``functional_call``."""

    def __init__(self, kern):
        super().__init__()
        self.kern = kern

    def forward(self, xb, X):
        return self.kern.K(xb, X, presliced=False)


class _StreamMatvec(torch.autograd.Function):
    """``K(X, X) @ v`` by panels of ``block`` rows, K the kernel of ``call``
    on ``params`` (as ``_PanelTerms``). For the solvers, which run without
    gradients: not differentiable. ``vmap``: the Function on each entry of
    the batch, so that each entry's products are the unbatched ones (a
    batched product sums in another order, and the float32 CG and Lanczos
    amplify that) and one panel is held at a time."""

    @staticmethod
    def forward(call, names, block, X, v, *params):
        state = dict(zip(names, params))
        return torch.cat([functional_call(call, state, (xb, X)) @ v for xb in _panels(X, block)])[:X.shape[0]]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("the streaming matvec serves the solvers, which run without gradients")

    @staticmethod
    def vmap(info, in_dims, call, names, block, *tensors):
        return vmap_loop(lambda *ts: _StreamMatvec.apply(call, names, block, *ts), info, in_dims[3:], *tensors)


class _PanelTerms(torch.autograd.Function):
    """``sum_b sum(C_b * (K(xb, X) @ W))`` over the ``block``-row panels xb
    of X (C padded to whole panels), with ``K`` the kernel evaluated on
    ``params``, the tensors ``names`` of ``call`` (a ``_KernelCall``).
    Forward: one panel at a time, each dropped once used. Backward:
    ``_PanelTermsGrad``, which regenerates the panels. ``vmap``: the
    Function on each entry of the batch."""

    @staticmethod
    def forward(call, names, block, X, W, C, *params):
        state = dict(zip(names, params))
        return sum(torch.sum(cb * (functional_call(call, state, (xb, X)) @ W))
                   for xb, cb in zip(_panels(X, block), C.split(block)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.call, ctx.names, ctx.block = inputs[:3]
        ctx.save_for_backward(*inputs[3:])

    @staticmethod
    def backward(ctx, g):
        wanted = tuple(i for i, n in enumerate(ctx.needs_input_grad[3:]) if n)
        grads = [None] * len(ctx.saved_tensors)
        if wanted:
            out = _PanelTermsGrad.apply(ctx.call, ctx.names, ctx.block, wanted, g, *ctx.saved_tensors)
            for i, gi in zip(wanted, out):
                grads[i] = gi
        return (None, None, None, *grads)

    @staticmethod
    def vmap(info, in_dims, call, names, block, *tensors):
        return vmap_loop(lambda *ts: _PanelTerms.apply(call, names, block, *ts), info, in_dims[3:], *tensors)


class _PanelTermsGrad(torch.autograd.Function):
    """The VJP of ``_PanelTerms`` in its inputs ``wanted`` (indices into X,
    W, C, *params): each panel regenerated and its VJP taken with
    ``torch.func.vjp``, one panel at a time. A Function of its own, so that
    a transform's backward (``torch.func.grad`` records it to differentiate
    again) holds none of a panel's temporaries, and so that its ``vmap``
    rule takes the batch one entry at a time: one panel's VJP is held at
    once. Differentiable once."""

    @staticmethod
    def forward(call, names, block, wanted, g, *inputs):
        grads = [torch.zeros_like(inputs[i]) for i in wanted]
        for b in range(inputs[2].shape[0] // block):
            rows = slice(b * block, (b + 1) * block)

            def panel(*diff, rows=rows, b=b):
                args = list(inputs)
                for i, t in zip(wanted, diff):
                    args[i] = t
                X, W, C, *params = args
                return torch.sum(C[rows] * (functional_call(call, dict(zip(names, params)),
                                                            (_panels(X, block)[b], X)) @ W))

            _, vjp = torch.func.vjp(panel, *(inputs[i] for i in wanted))
            for acc, gi in zip(grads, vjp(g)):
                acc += gi
        return tuple(grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the streaming GPRCG surrogate is differentiable once")

    @staticmethod
    def vmap(info, in_dims, call, names, block, wanted, *tensors):
        return vmap_loop(lambda *ts: _PanelTermsGrad.apply(call, names, block, wanted, *ts), info, in_dims[4:],
                         *tensors)


def _panel_terms(kern, X, block, W, C):
    """``sum(C * (K(X, X) @ W))`` by panels of ``block`` rows (C padded to
    whole panels), each regenerated in the backward."""
    call = _KernelCall(kern)
    named = list(call.named_parameters())
    return _PanelTerms.apply(call, tuple(n for n, _ in named), block, X, W, C, *(t for _, t in named))


def _surrogate(kern, noise, X, err, alpha, Z, U, num_probes, materialize, K=None):
    """The BBMM surrogate: 1/2 alpha^T A alpha - 1/2 (P_out / S) sum(U * A Z)
    - err^T alpha, with alpha, Z and U constant. Its gradient in the kernel's
    parameters, the noise, X and err is the estimate's."""
    num_out = err.shape[1]
    c = 0.5 * num_out / num_probes
    t_err = -torch.sum(err * alpha)
    if materialize:
        t_quad = 0.5 * torch.sum(alpha * (K @ alpha + noise * alpha))
        t_trace = -c * torch.sum(U * (K @ Z + noise * Z))
        return t_quad + t_trace + t_err
    # streaming: the same forms panel by panel (pad rows carry zero
    # weight), each panel regenerated in the backward
    N = X.shape[0]
    block = _stream_block(N)
    W = torch.cat([alpha, Z], dim=1)
    C = F.pad(torch.cat([0.5 * alpha, -c * U], dim=1), (0, 0, 0, (-N) % block))
    tot = _panel_terms(kern, X, block, W, C)
    t_noise = 0.5 * noise * torch.sum(torch.square(alpha)) - c * noise * torch.sum(U * Z)
    return tot + t_noise + t_err


def _wants_grad(*tensors, module=None):
    if not torch.is_grad_enabled():
        return False
    if any(t.requires_grad for t in tensors):
        return True
    return module is not None and any(p.requires_grad for p in module.parameters())


def cg_mll(kern, noise, X, err, num_probes, cg_iters, slq_steps, precond_rank, materialize):
    """``(mll, residuals)``: the CG/SLQ estimate of the log marginal
    likelihood of ``err ~ N(0, kern.K(X) + noise I)``, with BBMM's
    gradient, and the CG's final residual norms (err's columns, then the
    probes')."""
    N, num_out = err.shape
    wants_grad = _wants_grad(noise, X, err, module=kern)
    K = None
    if materialize:
        K = kern.K(X) if wants_grad else None
        with torch.no_grad():
            Kc = K.detach() if K is not None else kern.K(X)
            mv = _make_A_matvec(Kc, noise.detach())
    else:
        if precond_rank > 0:
            raise NotImplementedError(
                "pivoted-Cholesky preconditioning requires materialize_k; streaming mode runs plain CG "
                "(precond_rank=0)")
        mv = _make_streaming_matvec(kern, X, noise.detach())
    with torch.no_grad():
        pre = None
        if precond_rank > 0:
            pre = iterative.woodbury_solve_fn(iterative.pivoted_cholesky(Kc, precond_rank), noise.detach())
        # probes redrawn whenever the hyperparameters move, the same within
        # one evaluation and its gradient
        Z_ld, Z = iterative.cg_probes([*kern.parameters(), noise], N, num_probes, err.dtype)
        # the alpha solve and the trace probes' solves, one batched CG
        sol, res = iterative.batched_cg(mv, torch.cat([err.detach(), Z], dim=1), max_iters=cg_iters,
                                        precond=pre)
        alpha, U = sol[:, :num_out], sol[:, num_out:]
        logdet = iterative.slq_logdet(mv, Z_ld, num_steps=slq_steps)
        mll = (-0.5 * torch.sum(err.detach() * alpha) - 0.5 * num_out * logdet
               - 0.5 * N * num_out * math.log(2.0 * math.pi))
    if not wants_grad:
        return mll, res
    s = _surrogate(kern, noise, X, err, alpha, Z, U, num_probes, materialize, K)
    return mll + (s - s.detach()), res


class GPRCG(GPModel):
    """Exact GPR with CG/SLQ inference (a matrix-free marginal likelihood).

    The GPR API; ``build_likelihood`` is a stochastic estimate of the log
    marginal likelihood whose gradient is BBMM's. ``num_probes``,
    ``cg_iters``, ``slq_steps`` and ``precond_rank`` trade accuracy for
    work; ``materialize_k=False`` streams Gram panels through every matvec,
    forward and backward (O(N block) memory; requires ``precond_rank=0``).
    ``last_cg_residuals``: the last evaluation's final CG residual norms
    (the outputs' columns, then the probes'), None before the first.
    """

    def __init__(self, X, Y, kern, mean_function=None, num_probes=16, cg_iters=100, slq_steps=25,
                 precond_rank=0, materialize_k=True, name="gprcg", device=None, dtype=None):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name, device=device, dtype=dtype)
        self.num_probes = int(num_probes)
        self.cg_iters = int(cg_iters)
        self.slq_steps = int(slq_steps)
        self.precond_rank = int(precond_rank)
        self.materialize_k = bool(materialize_k)
        self.last_cg_residuals = None

    def build_likelihood(self):
        noise = torch.squeeze(self.likelihood.variance.value)
        err = self.Y - self.mean_function(self.X)
        mll, self.last_cg_residuals = cg_mll(self.kern, noise, self.X, err, self.num_probes, self.cg_iters,
                                             self.slq_steps, self.precond_rank, self.materialize_k)
        return mll

    def build_predict(self, Xnew, full_cov=False):
        if full_cov:
            raise NotImplementedError("GPRCG predicts marginal variances only (use GPR for full covariances)")
        Xnew = as_tensor_like(Xnew, self.X)
        noise = torch.squeeze(self.likelihood.variance.value)
        if self.materialize_k:
            mv = _make_A_matvec(self.kern.K(self.X), noise)
        else:
            mv = _make_streaming_matvec(self.kern, self.X, noise)
        err = self.Y - self.mean_function(self.X)
        alpha, _ = iterative.batched_cg(mv, err, max_iters=self.cg_iters)
        Kx = self.kern.K(self.X, Xnew)  # (N, N*)
        fmean = Kx.T @ alpha + self.mean_function(Xnew)
        # marginal variances: k** - k_x^T A^-1 k_x by CG on the columns
        W, _ = iterative.batched_cg(mv, Kx, max_iters=self.cg_iters)
        fvar = self.kern.Kdiag(Xnew) - torch.sum(Kx * W, dim=0)
        return fmean, fvar[:, None].expand(-1, self.num_latent)
