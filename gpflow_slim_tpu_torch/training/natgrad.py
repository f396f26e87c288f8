"""Natural gradients for the Gaussian variational parameters of an SVGP
(counterpart of ``gpflow_slim_tpu.training.natgrad``).

Salimbeni, Eleftheriadis & Hensman (2018): the update is taken in the
natural-parameter coordinates theta = (S^-1 m, -1/2 S^-1), where the natural
gradient is exactly dL/deta, eta = (m, S + m m^T) the expectation
parameters:

    theta <- theta - gamma * dL/deta,   then theta is mapped back to
    xi = (q_mu, q_sqrt).

dL/deta comes from autograd through eta -> xi -> the loss, with the model's
``q_mu`` and ``q_sqrt`` Params replaced by functions of eta
(``torch.func.functional_call``), so no Param is rebuilt. The maps between
the coordinates are batched ``torch.linalg`` calls over the P outputs, as
the JAX package leaves them to XLA.

``fit_svgp_natgrad`` alternates a natgrad step on q with an Adam step on the
other trainable parameters (the canonical SVGP loop).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from ..ops.cholesky import cholesky_plain
from ..params import trainable_leaves

__all__ = ["natgrad_step", "fit_svgp_natgrad"]

MAX_HALVINGS = 8  # gamma back-tracking: at most this many halvings per step


# -- the coordinate maps, batched over the P outputs -------------------------
# xi = (m (M, P), L (P, M, M) lower);  S = L L^T
# eta = (m, S + m m^T);  theta = (S^-1 m, -1/2 S^-1)

def _sym(A):
    return 0.5 * (A + A.mT)


def _chol_batched(S):
    # no jitter: the exactness of the conjugate one-step jump depends on
    # these round trips; a factorization that fails gives NaN, which makes
    # natgrad_step halve gamma
    return cholesky_plain(_sym(S))


def _outer(m):
    return torch.einsum("mp,np->pmn", m, m)


def _xi_to_expectation(m, L):
    return m, L @ L.mT + _outer(m)


def _expectation_to_xi(eta1, eta2):
    return eta1, _chol_batched(eta2 - _outer(eta1))


def _inverse_gram(L):
    # (L L^T)^-1 = L^-T L^-1 for a batch of lower factors
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.mT @ Linv


def _xi_to_natural(m, L):
    Sinv = _inverse_gram(L)
    return torch.einsum("pmn,np->mp", Sinv, m), -0.5 * Sinv


def _natural_to_xi(nat1, nat2):
    S = _inverse_gram(_chol_batched(-2.0 * _sym(nat2)))  # the precision's factor
    return torch.einsum("pmn,np->mp", S, nat1), _chol_batched(S)


def _q_unconstrained(model, m, L):
    """The unconstrained values of ``q_mu`` and ``q_sqrt`` that give (m, L)."""
    q = torch.diagonal(L, dim1=-2, dim2=-1).T if model.q_diag else L  # (M, P) diagonal
    return model.q_mu.transform.backward(m), model.q_sqrt.transform.backward(q)


class _Bound(torch.nn.Module):
    """``fn(model)`` as a module call, for ``functional_call``."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self):
        return self.fn(self.model)


def _loss_at(model, loss_fn, m, L):
    """``loss_fn(model)`` with q = (m, L): differentiable in m and L."""
    u_mu, u_sqrt = _q_unconstrained(model, m, L)
    return functional_call(_Bound(model, loss_fn), {"model.q_mu.unconstrained": u_mu,
                                                     "model.q_sqrt.unconstrained": u_sqrt}, ())


def _attempts(m0, L0, d1, d2, gamma):
    """The natgrad update of q = (m0, L0) by dL/deta = (d1, d2): the steps
    gamma 2^-k, k = 0 .. ``MAX_HALVINGS``, tried side by side in one batched
    pass, and the first whose q is finite taken. Returns ``(m, L, found,
    halvings)``: ``found`` False (and (m, L) not finite) where every
    attempt failed, ``halvings`` the k taken (``MAX_HALVINGS`` then)."""
    nat1, nat2 = _xi_to_natural(m0, L0)
    (M, P), K = nat1.shape, MAX_HALVINGS + 1
    g = gamma * 0.5 ** torch.arange(K, dtype=nat1.dtype, device=nat1.device)  # (K,)
    # the K attempts side by side: nat1 (M, K P), nat2 (K P, M, M)
    n1 = (nat1 - g[:, None, None] * d1).permute(1, 0, 2).reshape(M, K * P)
    n2 = (nat2 - g[:, None, None, None] * d2).reshape(K * P, M, M)
    m_all, L_all = _natural_to_xi(n1, n2)
    m_all = m_all.reshape(M, K, P).permute(1, 0, 2)  # (K, M, P)
    L_all = L_all.reshape(K, P, M, M)
    ok = torch.isfinite(m_all).flatten(1).all(1) & torch.isfinite(L_all).flatten(1).all(1)  # (K,)
    found = ok.any()
    first = torch.argmax(ok.to(torch.int32))  # the first finite attempt (0 if none is)
    pick = first.reshape(1)  # an index on the device: m_all[first] would read it on the host
    return (m_all.index_select(0, pick)[0], L_all.index_select(0, pick)[0], found,
            torch.where(found, first, MAX_HALVINGS))


# (shapes, dtype, device, gamma) -> (graph, its input buffers, its outputs)
_GRAPHS = {}


def _update(m0, L0, d1, d2, gamma):
    """``_attempts``; on a CUDA device, replayed from a CUDA graph captured on
    the first call for its shapes, dtype and gamma (that call waits for the
    device once): the ~170 launches of the batched pass, cuSOLVER's batched
    factorizations among them, become one. The outputs are the graph's own
    buffers, valid until its next replay."""
    inputs = (m0, L0, d1, d2)
    if m0.device.type != "cuda":
        return _attempts(*inputs, gamma)
    key = (tuple(t.shape for t in inputs), m0.dtype, m0.device, gamma)
    if key not in _GRAPHS:
        buffers = [t.clone() for t in inputs]
        side = torch.cuda.Stream(m0.device)
        side.wait_stream(torch.cuda.current_stream(m0.device))
        with torch.cuda.stream(side):  # warm-up outside the capture: library handles and workspaces
            _attempts(*buffers, gamma)
        torch.cuda.current_stream(m0.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = _attempts(*buffers, gamma)
        _GRAPHS[key] = graph, buffers, outputs
    graph, buffers, outputs = _GRAPHS[key]
    for b, t in zip(buffers, inputs):
        b.copy_(t)
    graph.replay()
    return outputs


def natgrad_step(model, loss_fn: Callable, gamma: float):
    """One natural-gradient update of (q_mu, q_sqrt), in place; the other
    parameters are untouched. ``loss_fn(model)`` is a scalar (typically
    -ELBO on a batch). Returns ``model``.

    For a conjugate (Gaussian) likelihood dL/deta = theta - theta*, so one
    step with gamma = 1 lands on the optimal q. With other likelihoods a
    large gamma can make the new precision indefinite: gamma is then halved,
    up to ``MAX_HALVINGS`` times, and if every attempt fails q is kept. The
    attempts gamma 2^-k, k = 0 .. ``MAX_HALVINGS``, run as one batched pass
    on the device and the first whose q is finite is taken (the JAX
    package's ``lax.while_loop`` and ``jnp.where``), so the step never
    waits on the device (``_update``; on a CUDA device replayed from a CUDA
    graph). ``natgrad_step.backtracked``, ``.halvings`` and
    ``.kept`` count the steps that halved, the halvings and the steps that
    kept q; they add up on the device (0-dim tensors once a step has run),
    for the caller to read when it wants them.
    """
    m0 = model.q_mu.value.detach()
    L0 = model.q_sqrt_array().detach()
    with torch.enable_grad():
        eta1, eta2 = (t.detach().requires_grad_() for t in _xi_to_expectation(m0, L0))
        loss = _loss_at(model, loss_fn, *_expectation_to_xi(eta1, eta2))
        d1, d2 = torch.autograd.grad(loss, (eta1, eta2))

    with torch.no_grad():
        m_new, L_new, found, halvings = _update(m0, L0, d1, d2, gamma)
        u_mu, u_sqrt = _q_unconstrained(model, m_new, L_new)
        # where every attempt failed, q keeps its own unconstrained values
        model.q_mu.unconstrained.copy_(torch.where(found, u_mu, model.q_mu.unconstrained))
        model.q_sqrt.unconstrained.copy_(torch.where(found, u_sqrt, model.q_sqrt.unconstrained))
    natgrad_step.halvings = natgrad_step.halvings + halvings
    natgrad_step.backtracked = natgrad_step.backtracked + (halvings > 0).long()
    natgrad_step.kept = natgrad_step.kept + (~found).long()
    return model


natgrad_step.backtracked = 0
natgrad_step.halvings = 0
natgrad_step.kept = 0


def fit_svgp_natgrad(model, num_steps: int, generator: torch.Generator | None = None,
                     gamma: float = 0.1, learning_rate: float = 0.01,
                     batch_size: int | None = None, optimizer=None):
    """Alternating natgrad(q) + Adam(hyperparameters) SVGP training, in place.

    Each step draws a minibatch of ``batch_size`` points without replacement
    (``torch.randperm`` with ``generator``, a ``torch.Generator`` on the
    model's device in place of the JAX key; None uses torch's default), takes
    a natural-gradient step on (q_mu, q_sqrt), then an optimizer step on
    every other trainable leaf (``params.trainable_leaves``: a
    ``DeepKernel``'s warp too; optax's ``masked`` optimizer of the JAX
    package). ``optimizer``, in place of the JAX package's optax
    transformation, builds the hyperparameters' optimizer from their list of
    tensors (``lambda ps: torch.optim.SGD(ps, lr=0.01)``); None is Adam at
    ``learning_rate``. ``batch_size=None`` uses all N points. Returns
    ``(model, losses)``, ``losses`` (num_steps,) the batch loss after each
    natgrad step.
    """
    N = model.num_data
    B = batch_size or N
    q_leaves = {id(model.q_mu.unconstrained), id(model.q_sqrt.unconstrained)}
    hypers = [t for _, t in trainable_leaves(model) if id(t) not in q_leaves]
    if optimizer is None:
        def optimizer(ps):
            return torch.optim.Adam(ps, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    opt = optimizer(hypers) if hypers else None
    losses = []
    for _ in range(num_steps):
        idx = torch.randperm(N, generator=generator, device=model.X.device)[:B]
        Xb, Yb = model.X[idx], model.Y[idx]

        def batch_loss(mm):
            return -(mm.build_likelihood_batch(Xb, Yb) + mm.log_prior())

        natgrad_step(model, batch_loss, gamma)
        loss = batch_loss(model)
        if opt is not None:
            for p, g in zip(hypers, torch.autograd.grad(loss, hypers)):
                p.grad = g
            opt.step()
        losses.append(loss.detach())
    return model, torch.stack(losses)
