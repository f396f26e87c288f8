"""MCMC plumbing (counterpart of ``gpflow_slim_tpu.mcmc.base``): model <->
flat unconstrained vector, the batched value and gradient over chains,
dual averaging, Welford, the leapfrog.

The chain state is a tensor whose leading dimension is the chain: ``z``
(C, D), ``logp`` (C,), ``grad`` (C, D), and the adaptation states hold one
entry per chain. Where the JAX package ``vmap``s one chain's sampler, the
port's samplers run all chains in one loop on the host and batch each
gradient evaluation over the chains with ``torch.func.vmap``.

The target is ``model.log_posterior()`` through ``torch.func.functional_call``
with the trainable unconstrained leaves taken from the vector: prior
log-probs and transform log-Jacobians included, so sampling in
unconstrained coordinates is measure-correct. On CUDA float32 models the
batched evaluation runs each chain's factorization on the hand-written
kernels (each ``ops`` Function's ``vmap`` rule launches once per chain).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, grad_and_value, vmap

from ..params import pack_trainable


class _LogPosterior(nn.Module):
    """``model.log_posterior()`` as a module call, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self):
        return self.model.log_posterior()


def model_logprob(model):
    """Return ``(logprob_fn, x0, unpack)`` for MCMC over a model's params.

    ``logprob_fn(v)`` is the log posterior of the model with its trainable
    unconstrained leaves replaced from the flat vector ``v`` (D,), the
    model itself untouched; ``x0`` is the model's current vector and
    ``unpack`` is ``params.pack_trainable``'s.
    """
    x0, unpack = pack_trainable(model)
    call = _LogPosterior(model)

    def logprob_fn(v):
        return functional_call(call, {f"model.{n}": t for n, t in unpack(v).items()}, ())

    return logprob_fn, x0, unpack


def batched_value_and_grad(logprob_fn: Callable):
    """``z (B, D) -> (logp (B,), grad (B, D))``: ``logprob_fn`` and its
    gradient at each row, ``vmap(grad_and_value(logprob_fn))``, the
    counterpart of ``jax.vmap(jax.value_and_grad(logprob_fn))``."""
    vg = vmap(grad_and_value(logprob_fn))

    def fn(z):
        g, lp = vg(z)
        return lp, g

    return fn


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging for step-size adaptation (Hoffman & Gelman),
    one entry per chain."""

    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    gradient_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(step_size):
    step_size = torch.as_tensor(step_size)
    return DualAveragingState(
        log_step=torch.log(step_size),
        log_step_avg=torch.log(step_size),
        gradient_avg=torch.zeros_like(step_size),
        t=torch.zeros_like(step_size),
        mu=torch.log(10.0 * step_size),
    )


def da_update(state: DualAveragingState, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    t = state.t + 1.0
    g = target - accept_prob
    gradient_avg = (1 - 1 / (t + t0)) * state.gradient_avg + g / (t + t0)
    log_step = state.mu - torch.sqrt(t) / gamma * gradient_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, gradient_avg, t, state.mu)


class WelfordState(NamedTuple):
    mean: torch.Tensor   # (C, D)
    m2: torch.Tensor     # (C, D)
    count: torch.Tensor  # (C,)


def welford_init(z):
    """Empty moments for chain states shaped like ``z`` (C, D)."""
    return WelfordState(mean=torch.zeros_like(z), m2=torch.zeros_like(z), count=torch.zeros_like(z[..., 0]))


def welford_update(state: WelfordState, x):
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, regularize=True):
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)[..., None]
    if regularize:
        # Stan's shrinkage toward unit metric
        n = state.count[..., None]
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def leapfrog(logprob_grad_fn: Callable, z, r, grad, step_size, inv_mass):
    """One leapfrog step of every row of ``(z, r)`` with cached ``grad``;
    ``step_size`` (B, 1) or a scalar, ``inv_mass`` (B, D).

    Returns (z', r', logp', grad'): one batched gradient evaluation.
    """
    r_half = r + 0.5 * step_size * grad
    z_new = z + step_size * inv_mass * r_half
    lp_new, grad_new = logprob_grad_fn(z_new)
    r_new = r_half + 0.5 * step_size * grad_new
    return z_new, r_new, lp_new, grad_new


def kinetic_energy(r, inv_mass):
    return 0.5 * torch.sum(torch.square(r) * inv_mass, dim=-1)


def per_chain(x0, value):
    """``value`` (a float, a (C,) tensor or one of any shape that broadcasts
    against ``x0``'s leading dimensions) as a tensor of ``x0``'s dtype and
    device, one entry per chain."""
    if not isinstance(value, torch.Tensor):
        return torch.full(x0.shape[:-1], value, dtype=x0.dtype, device=x0.device)  # no host copy
    return value.to(dtype=x0.dtype, device=x0.device).expand(x0.shape[:-1]).clone()


class ChainShard(NamedTuple):
    """This rank's chains of a run whose chains are split over ranks
    (``parallel.sample_chains`` with a mesh): chains ``[start, start +
    count)`` of ``total``, and the process group of the chain axis. Every
    rank draws each random tensor for all ``total`` chains from a generator
    seeded alike and keeps its rows, and the samplers' loops run until no
    chain on any rank is live, so a chain's draws do not depend on the
    number of ranks."""

    total: int
    start: int
    count: int
    group: object


def mine(t, chains: ChainShard | None):
    """This rank's rows of a draw for all the chains."""
    return t if chains is None else t[chains.start:chains.start + chains.count]


def num_chains(x, chains: ChainShard | None) -> int:
    """The number of chains over every rank, for ``x``'s of this rank."""
    return x.shape[0] if chains is None else chains.total


def total(k: int, chains: ChainShard | None, device) -> int:
    """``k`` summed over the chain axis's ranks (a host integer)."""
    if chains is None:
        return k
    t = torch.tensor([k], device=device)
    dist.all_reduce(t, group=chains.group)
    return int(t.item())


def share(x, shared: bool, chains: ChainShard | None = None):
    """The mean over the chains (over every rank's chains), broadcast back
    to every chain, when the adaptation is shared (the JAX package's
    ``pmean`` over the chain axes); ``x`` itself otherwise. Over ranks the
    chains' values are all-gathered and averaged in the one-rank order: a
    sum of per-rank sums rounds otherwise, and dual averaging amplifies a
    last-bit difference over a warmup."""
    if not shared:
        return x
    if chains is not None:
        parts = [torch.empty_like(x) for _ in range(chains.total // chains.count)]
        dist.all_gather(parts, x.contiguous(), group=chains.group)
        return torch.cat(parts).mean(dim=0, keepdim=True).expand_as(x)
    return x.mean(dim=0, keepdim=True).expand_as(x)
