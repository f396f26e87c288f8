"""Leapfrog HMC with GPflow-1.x sampler semantics over a batch of chains
(counterpart of ``gpflow_slim_tpu.mcmc.hmc``).

Per sample and chain: step size drawn uniformly from
±[ε(1−jitter), ε(1+jitter)] (random sign: a reversed trajectory is
measure-preserving), leapfrog count L ~ U{lmin, …, lmax−1}, standard
leapfrog, Metropolis accept, burn and thin. Optional dual-averaging
step-size adaptation during burn-in (off by default, for the reference's
semantics), its accept statistic averaged over the chains when
``shared_adaptation``.

Each chain draws its own L. The transition reads the chains' L to the host
(its one host sync), orders the chains by L, and integrates at step s only
the chains with L > s: a suffix of that order, so no further sync.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, NamedTuple

import torch

from .base import (ChainShard, batched_value_and_grad, da_init, da_update, kinetic_energy, leapfrog, mine, num_chains,
                   per_chain, share)


class HMCState(NamedTuple):
    z: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


def _integrate(logprob_grad_fn, z, r, logp, grad, eps, L, inv_mass):
    """``L[c]`` leapfrog steps of chain c from ``(z, r)`` (C, D) with step
    ``eps`` (C,); ``L`` (C,) integers on the chains' device, read to the
    host once. Returns (z, r, logp, grad)."""
    steps = sorted(L.tolist())  # the transition's host sync
    order = torch.argsort(L, stable=True)
    eps = eps[:, None]
    for s in range(steps[-1]):
        first = bisect.bisect_right(steps, s)  # chains order[first:] have L > s
        idx = order[first:] if first else None
        rows = (lambda x: x) if idx is None else (lambda x: x.index_select(0, idx))
        za, ra, lpa, ga = leapfrog(logprob_grad_fn, rows(z), rows(r), rows(grad), rows(eps), rows(inv_mass))
        if idx is None:
            z, r, logp, grad = za, ra, lpa, ga
        else:
            z, r = z.index_copy(0, idx, za), r.index_copy(0, idx, ra)
            logp, grad = logp.index_copy(0, idx, lpa), grad.index_copy(0, idx, ga)
    return z, r, logp, grad


def _hmc_transition(logprob_grad_fn, state: HMCState, generator, epsilon, lmin, lmax, epsilon_jitter, inv_mass,
                    chains=None):
    z = state.z
    C = num_chains(z, chains)  # every rank draws for all the chains and keeps its own
    dtype, device = z.dtype, z.device

    def uniform():
        return mine(torch.rand(C, generator=generator, dtype=dtype, device=device), chains)

    lo, hi = epsilon * (1.0 - epsilon_jitter), epsilon * (1.0 + epsilon_jitter)
    eps_mag = lo + (hi - lo) * uniform()
    sign = torch.where(uniform() < 0.5, 1.0, -1.0).to(dtype)
    eps = eps_mag * sign
    L = mine(torch.randint(lmin, max(lmax, lmin + 1), (C,), generator=generator, device=device), chains)

    r0 = mine(torch.randn((C, z.shape[1]), generator=generator, dtype=dtype, device=device),
              chains) / torch.sqrt(inv_mass)
    H0 = state.logp - kinetic_energy(r0, inv_mass)
    z1, r1, lp1, grad1 = _integrate(logprob_grad_fn, z, r0, state.logp, state.grad, eps, L, inv_mass)
    H1 = lp1 - kinetic_energy(r1, inv_mass)
    log_accept_ratio = H1 - H0
    # NaN-robust: an f32 posterior can return NaN at extreme proposals; the
    # comparison below rejects NaN, but the accept STATISTIC would carry it
    # into dual averaging: NaN counts as log-ratio -inf (certain rejection)
    log_accept_ratio = torch.where(torch.isnan(log_accept_ratio), -math.inf, log_accept_ratio)
    accept_prob = torch.clamp(torch.exp(log_accept_ratio), max=1.0)
    accept = torch.log(uniform()) < log_accept_ratio
    new_state = HMCState(
        z=torch.where(accept[:, None], z1, z),
        logp=torch.where(accept, lp1, state.logp),
        grad=torch.where(accept[:, None], grad1, state.grad),
    )
    return new_state, accept_prob


def hmc(
    logprob_fn: Callable,
    x0,
    generator,
    num_samples: int,
    epsilon: float = 0.01,
    lmin: int = 10,
    lmax: int = 21,
    thin: int = 1,
    burn: int = 0,
    epsilon_jitter: float = 0.1,
    inv_mass=None,
    adapt_step_size: bool = False,
    target_accept: float = 0.8,
    shared_adaptation: bool = False,
    chains: ChainShard | None = None,
):
    """Run HMC chains from ``x0`` (C, D), or one chain from ``x0`` (D,);
    ``generator`` a ``torch.Generator`` on ``x0``'s device. Returns
    ``(samples, dict(logp, accept_rate, epsilon))``: samples (C, S, D),
    post burn-in and thinned, logp (C, S), accept_rate and epsilon (C,);
    for one chain without the leading dimension. ``shared_adaptation``:
    dual averaging's accept statistic is averaged over the chains.
    ``chains``: ``x0`` is this rank's share of a run over ranks
    (``ChainShard``; ``parallel.sample_chains`` passes it)."""
    single = x0.dim() == 1
    z = x0[None] if single else x0
    inv_mass = torch.ones_like(z) if inv_mass is None else torch.as_tensor(inv_mass).to(z).expand_as(z).clone()
    fn = batched_value_and_grad(logprob_fn)
    state = HMCState(z, *fn(z))

    # burn-in, with optional dual-averaging adaptation
    eps0 = per_chain(z, epsilon)
    da = da_init(eps0)
    for _ in range(burn):
        eps = torch.exp(da.log_step) if adapt_step_size else eps0
        state, accept_prob = _hmc_transition(fn, state, generator, eps, lmin, lmax, epsilon_jitter, inv_mass, chains)
        if adapt_step_size:
            da = da_update(da, share(accept_prob, shared_adaptation, chains), target=target_accept)
    eps_final = torch.exp(da.log_step_avg) if adapt_step_size else eps0

    # sampling, thinned
    zs, logps, accepts = [], [], []
    for _ in range(num_samples):
        aps = []
        for _ in range(thin):
            state, ap = _hmc_transition(fn, state, generator, eps_final, lmin, lmax, epsilon_jitter, inv_mass, chains)
            aps.append(ap)
        zs.append(state.z)
        logps.append(state.logp)
        accepts.append(torch.stack(aps).mean(dim=0))
    samples = torch.stack(zs, dim=1)
    info = {"logp": torch.stack(logps, dim=1), "accept_rate": torch.stack(accepts, dim=1).mean(dim=1),
            "epsilon": eps_final}
    if single:
        return samples[0], {k: v[0] for k, v in info.items()}
    return samples, info
