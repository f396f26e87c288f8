"""Iterative multinomial NUTS over a batch of chains (counterpart of
``gpflow_slim_tpu.mcmc.nuts``), with the same arithmetic per chain.

The JAX package ``vmap``s one chain's ``lax.while_loop``, so every chain
steps until the last one stops and finished chains are masked. Here the
loops run on the host over all chains at once, in lockstep (every chain
still building a trajectory is at the same depth and leaf), and each leaf
integrates only the chains still building their subtree: their rows are
gathered, one batched value-and-gradient evaluates them, and the results
are scattered back, so a finished chain costs nothing. Finding those rows
is the one host sync of a leaf (``nonzero``); the first leaf of a
transition, where every chain builds, needs none. The leapfrog and the
target never sync.

Per transition:
  * tree doublings up to ``max_depth``; each integrates ``2^depth``
    leapfrog steps with the **iterative U-turn checkpoint scheme**: even
    leaf ``i`` is stored at slot ``popcount(i)``; odd leaf ``i`` with ``t``
    trailing one-bits closes the subtrees of sizes 2, 4, ..., 2^t, whose
    start states live in slots ``popcount(i) - t .. popcount(i) - 1``.
    The leaf index is shared by every building chain, so the slots are
    host integers;
  * multinomial (progressive) sampling of the proposal within each
    subtree, biased sampling across subtrees (Betancourt's scheme);
  * divergence when the energy error passes 1000, or is NaN (an f32 GP
    target gives NaN where a proposal's covariance does not factor).

Warmup is Stan's windowed scheme (``warmup_schedule``): dual averaging of
the step size, Welford moments of the draws for a diagonal mass, both
shared across the chains when ``shared_adaptation`` (the mean over the
chains takes the place of the JAX package's ``pmean``). Randomness comes
from one ``torch.Generator`` on the chains' device, which takes the place
of the JAX key; the draws do not match the JAX package's streams.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

from .base import (
    ChainShard,
    batched_value_and_grad,
    da_init,
    da_update,
    kinetic_energy,
    leapfrog,
    mine,
    num_chains,
    per_chain,
    share,
    total,
    welford_init,
    welford_update,
    welford_variance,
)

_MAX_DELTA_ENERGY = 1000.0


def warmup_schedule(num_warmup: int, init_buffer: int = 75, term_buffer: int = 50, base_window: int = 25):
    """Stan-style adaptation windows: ``[("fast", n), ("slow", n), ...]``.

    An initial fast window adapts the step size only; then doubling slow
    windows (25, 50, 100, ...) accumulate Welford moments and re-estimate
    the diagonal mass at each window end (restarting dual averaging with
    the new metric); a final fast window re-tunes the step size against
    the final mass. The last slow window absorbs any remainder. For short
    warmups the buffers scale proportionally (15% / 75% / 10%).
    """
    if num_warmup <= 0:
        return []
    if num_warmup < 20:
        return [("fast", num_warmup)]
    if init_buffer + base_window + term_buffer > num_warmup:
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.10 * num_warmup))
        base_window = num_warmup - init_buffer - term_buffer
    windows = [("fast", init_buffer)]
    slow_end = num_warmup - term_buffer
    pos, w = init_buffer, base_window
    while pos < slow_end:
        end = slow_end if pos + 3 * w > slow_end else pos + w
        windows.append(("slow", end - pos))
        pos, w = end, 2 * w
    windows.append(("fast", term_buffer))
    return windows


def _is_turning(z_minus, r_minus, z_plus, r_plus, inv_mass):
    dz = z_plus - z_minus
    return torch.logical_or(
        torch.sum(dz * (r_minus * inv_mass), dim=-1) < 0.0,
        torch.sum(dz * (r_plus * inv_mass), dim=-1) < 0.0,
    )


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _trailing_ones(x: int) -> int:
    # number of trailing 1-bits = popcount(x & ~(x+1))
    return _popcount(x & ~(x + 1))


class _Subtree(NamedTuple):
    """A subtree of every chain (rows of chains that did not build it keep
    their start values); ``stopped``: every building chain turned or
    diverged before its last leaf (a host bool)."""

    z: torch.Tensor
    r: torch.Tensor
    grad: torch.Tensor
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    log_weight: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    leaves_done: torch.Tensor
    stopped: bool


def _rows(x, idx):
    return x if idx is None else x.index_select(0, idx)


def _put(x, idx, v):
    if idx is None:
        return v
    return x.index_copy(0, idx, v)


def _build_subtree(logprob_grad_fn, z0, r0, grad0, depth: int, direction, step_size, inv_mass, H0,
                   generator, building=None, idx=None, chains=None):
    """Integrate ``2^depth`` leapfrog steps from ``(z0, r0)`` of each chain
    in ``building`` (C,) bool (None: all), whose indices ``idx`` are known
    on the device (None: all); iterative U-turn checks. ``direction`` and
    ``step_size`` (C,), ``inv_mass`` (C, D), ``H0`` (C,). ``chains``: this
    rank's chains of a run over ranks (``ChainShard``), None for all."""
    C, D = z0.shape
    C_all = num_chains(z0, chains)
    dtype, device = z0.dtype, z0.device
    eps = (direction * step_size)[:, None]
    z, r, grad = z0, r0, grad0
    z_prop, grad_prop = z0, grad0
    logp_prop = torch.full((C,), -math.inf, dtype=dtype, device=device)
    log_weight = torch.full((C,), -math.inf, dtype=dtype, device=device)
    turning = torch.zeros(C, dtype=torch.bool, device=device)
    diverging = torch.zeros(C, dtype=torch.bool, device=device)
    sum_accept = torch.zeros(C, dtype=dtype, device=device)
    leaves_done = torch.zeros(C, dtype=torch.int64, device=device)
    ckpt_z = torch.zeros((C, depth + 1, D), dtype=dtype, device=device)
    ckpt_r = torch.zeros((C, depth + 1, D), dtype=dtype, device=device)
    stopped = False
    for i in range(1 << depth):
        if i > 0:
            live = ~(turning | diverging)
            if building is not None:
                live &= building
            act = live.nonzero()[:, 0]  # the leaf's host sync
            if total(act.numel(), chains, device) == 0:
                stopped = True
                break
            idx = None if act.numel() == C else act
        u = mine(torch.rand(C_all, generator=generator, dtype=dtype, device=device), chains)
        if idx is not None and idx.numel() == 0:
            continue  # no chain of this rank builds this leaf; another rank's do
        ima = _rows(inv_mass, idx)
        za, ra, lpa, ga = leapfrog(logprob_grad_fn, _rows(z, idx), _rows(r, idx), _rows(grad, idx),
                                   _rows(eps, idx), ima)
        H = lpa - kinetic_energy(ra, ima)
        delta = H - _rows(H0, idx)  # log w_leaf
        # NaN-robust divergence: `delta < -MAX` is False for NaN, which would
        # leak NaN into sum_accept -> dual averaging -> the step size;
        # ~(delta >= -MAX) flags NaN as a divergence, and the leaf is left
        # out of the weights and statistics below
        div = torch.logical_not(delta >= -_MAX_DELTA_ENERGY)
        delta = torch.where(div, -math.inf, delta)
        acc = torch.where(div, 0.0, torch.clamp(torch.exp(delta), max=1.0))

        # progressive multinomial proposal within the subtree
        lw = _rows(log_weight, idx)
        lw_new = torch.logaddexp(lw, delta)
        switch = _rows(u, idx) < torch.exp(delta - lw_new)
        z_prop = _put(z_prop, idx, torch.where(switch[:, None], za, _rows(z_prop, idx)))
        logp_prop = _put(logp_prop, idx, torch.where(switch, lpa, _rows(logp_prop, idx)))
        grad_prop = _put(grad_prop, idx, torch.where(switch[:, None], ga, _rows(grad_prop, idx)))

        # iterative U-turn checks
        pc = _popcount(i)
        if i % 2 == 0:
            # store even leaves at slot popcount(i)
            turn_here = None
            if idx is None:
                ckpt_z[:, pc] = za
                ckpt_r[:, pc] = ra
            else:
                ckpt_z[:, pc].index_copy_(0, idx, za)
                ckpt_r[:, pc].index_copy_(0, idx, ra)
        else:
            # odd leaves close t subtrees: their start states are in slots
            # pc - t .. pc - 1; orientation: forward => the checkpoint is
            # the left end, else the right
            t = _trailing_ones(i)
            cz = _rows(ckpt_z, idx)[:, pc - t:pc]
            cr = _rows(ckpt_r, idx)[:, pc - t:pc]
            fwd = (_rows(direction, idx) > 0)[:, None, None]
            dz = torch.where(fwd, za[:, None] - cz, cz - za[:, None])
            r_left = torch.where(fwd, cr, ra[:, None])
            r_right = torch.where(fwd, ra[:, None], cr)
            im = ima[:, None]
            turn_k = torch.logical_or(torch.sum(dz * (r_left * im), dim=-1) < 0.0,
                                      torch.sum(dz * (r_right * im), dim=-1) < 0.0)
            turn_here = torch.any(turn_k, dim=1)

        z, r, grad = _put(z, idx, za), _put(r, idx, ra), _put(grad, idx, ga)
        log_weight = _put(log_weight, idx, lw_new)
        if turn_here is not None:
            turning = _put(turning, idx, _rows(turning, idx) | turn_here)
        diverging = _put(diverging, idx, _rows(diverging, idx) | div)
        sum_accept = _put(sum_accept, idx, _rows(sum_accept, idx) + acc)
        leaves_done = _put(leaves_done, idx, _rows(leaves_done, idx) + 1)
    return _Subtree(z, r, grad, z_prop, logp_prop, grad_prop, log_weight, turning, diverging, sum_accept,
                    leaves_done, stopped)


def _keep(live, new, old):
    if live is None:
        return new
    return torch.where(live.reshape(-1, *([1] * (new.dim() - 1))), new, old)


class _Transition(NamedTuple):
    z: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    depth: torch.Tensor
    num_leaves: torch.Tensor


def _nuts_transition(logprob_grad_fn, z, logp, grad, generator, step_size, inv_mass, max_depth: int,
                     chains=None):
    """One NUTS transition of every chain: ``z`` (C, D), ``logp`` (C,),
    ``grad`` (C, D), ``step_size`` (C,), ``inv_mass`` (C, D); ``chains`` as
    ``_build_subtree``'s."""
    C = z.shape[0]
    C_all = num_chains(z, chains)
    dtype, device = z.dtype, z.device
    r0 = mine(torch.randn((C_all, z.shape[1]), generator=generator, dtype=dtype, device=device),
              chains) / torch.sqrt(inv_mass)
    H0 = logp - kinetic_energy(r0, inv_mass)

    z_left = z_right = z_prop = z
    r_left = r_right = r0
    g_left = g_right = g_prop = grad
    logp_prop = logp
    log_weight = torch.zeros(C, dtype=dtype, device=device)  # the initial leaf has weight exp(0)
    depth = torch.zeros(C, dtype=torch.int64, device=device)
    turning = torch.zeros(C, dtype=torch.bool, device=device)
    diverging = torch.zeros(C, dtype=torch.bool, device=device)
    sum_accept = torch.zeros(C, dtype=dtype, device=device)
    num_leaves = torch.zeros(C, dtype=dtype, device=device)

    live, idx = None, None  # at depth 0 every chain builds
    for d in range(max_depth):
        if d > 0:
            live = ~(turning | diverging)
            act = live.nonzero()[:, 0]  # the host sync of this doubling's first leaf
            if total(act.numel(), chains, device) == 0:
                break
            idx = None if act.numel() == C else act
            live = None if idx is None else live
        u_dir = mine(torch.rand(C_all, generator=generator, dtype=dtype, device=device), chains)
        direction = torch.where(u_dir < 0.5, 1.0, -1.0).to(dtype)
        fwd = direction > 0
        fwd2 = fwd[:, None]
        sub = _build_subtree(logprob_grad_fn, torch.where(fwd2, z_right, z_left),
                             torch.where(fwd2, r_right, r_left), torch.where(fwd2, g_right, g_left), d,
                             direction, step_size, inv_mass, H0, generator, live, idx, chains)

        # the trajectory's new ends
        nz_left = torch.where(fwd2, z_left, sub.z)
        nr_left = torch.where(fwd2, r_left, sub.r)
        ng_left = torch.where(fwd2, g_left, sub.grad)
        nz_right = torch.where(fwd2, sub.z, z_right)
        nr_right = torch.where(fwd2, sub.r, r_right)
        ng_right = torch.where(fwd2, sub.grad, g_right)

        # biased progressive sampling across the doubling
        lw_new = torch.logaddexp(log_weight, sub.log_weight)
        p_new = torch.exp(torch.clamp(sub.log_weight - log_weight, max=0.0))
        invalid = sub.turning | sub.diverging
        u = mine(torch.rand(C_all, generator=generator, dtype=dtype, device=device), chains)
        take = (u < p_new) & ~invalid
        take2 = take[:, None]
        nz_prop = torch.where(take2, sub.z_prop, z_prop)
        nlogp_prop = torch.where(take, sub.logp_prop, logp_prop)
        ng_prop = torch.where(take2, sub.grad_prop, g_prop)

        # U-turn across the whole (merged) trajectory
        turning_total = sub.turning | _is_turning(nz_left, nr_left, nz_right, nr_right, inv_mass)

        # chains that did not build this doubling keep their tree
        keep = functools.partial(_keep, live)
        z_left, r_left, g_left = keep(nz_left, z_left), keep(nr_left, r_left), keep(ng_left, g_left)
        z_right, r_right, g_right = keep(nz_right, z_right), keep(nr_right, r_right), keep(ng_right, g_right)
        z_prop, logp_prop, g_prop = keep(nz_prop, z_prop), keep(nlogp_prop, logp_prop), keep(ng_prop, g_prop)
        log_weight = keep(torch.where(invalid, log_weight, lw_new), log_weight)
        depth = keep(depth + 1, depth)
        turning = keep(turning_total, turning)
        diverging = keep(diverging | sub.diverging, diverging)
        sum_accept = keep(sum_accept + sub.sum_accept, sum_accept)
        num_leaves = keep(num_leaves + sub.leaves_done.to(dtype), num_leaves)
        if sub.stopped:
            break  # every building chain turned or diverged: every tree is done
    accept_prob = sum_accept / torch.clamp(num_leaves, min=1.0)
    return _Transition(z_prop, logp_prop, g_prop, accept_prob, diverging, depth, num_leaves)


def _warmup_steps(logprob_grad_fn, z, lp, grad, generator, num_steps, da, welford, inv_mass, max_depth,
                  target_accept, adapt_mass, shared_adaptation, chains=None):
    for _ in range(num_steps):
        tr = _nuts_transition(logprob_grad_fn, z, lp, grad, generator, torch.exp(da.log_step), inv_mass,
                              max_depth, chains)
        z, lp, grad = tr.z, tr.logp, tr.grad
        da = da_update(da, share(tr.accept_prob, shared_adaptation, chains), target=target_accept)
        if adapt_mass:
            welford = welford_update(welford, z)
    return z, lp, grad, da, welford


def nuts_warmup_init(x0, step_size: float = 0.1):
    """Initial ``(da, welford, inv_mass)`` adaptation state of the chains
    ``x0`` (C, D), for windowed warmup (``nuts_warmup_window``)."""
    return da_init(per_chain(x0, step_size)), welford_init(x0), torch.ones_like(x0)


def nuts_warmup_window(
    logprob_fn: Callable,
    z,
    generator,
    num_steps: int,
    da,
    welford,
    inv_mass,
    *,
    max_depth: int = 10,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    shared_adaptation: bool = False,
):
    """Advance NUTS warmup of the chains ``z`` (C, D) by ``num_steps``
    transitions, resuming from and returning the full adaptation state
    ``(z, da, welford, inv_mass)``.

    Drive the Stan windows (``warmup_schedule``) phase by phase, and chunk
    within a phase at will: the Welford state rides along and the
    generator's state with it, so a window split into chunks gives the
    draws of one call. Close each slow window with
    ``nuts_slow_window_close`` and finish with ``exp(da.log_step_avg)``.
    The arithmetic of the warmup inside ``nuts``.
    """
    fn = batched_value_and_grad(logprob_fn)
    lp, grad = fn(z)
    z, _, _, da, welford = _warmup_steps(fn, z, lp, grad, generator, num_steps, da, welford, inv_mass,
                                         max_depth, target_accept, adapt_mass, shared_adaptation)
    return z, da, welford, inv_mass


def nuts_slow_window_close(da, welford, shared_adaptation: bool = False, chains: ChainShard | None = None):
    """End a Stan slow window: re-estimate the diagonal inverse mass from
    the window's Welford moments (averaged over the chains, every rank's,
    when shared) and restart dual averaging from the averaged step size."""
    inv_mass = share(welford_variance(welford), shared_adaptation, chains)
    return da_init(torch.exp(da.log_step_avg)), inv_mass


def nuts(
    logprob_fn: Callable,
    x0,
    generator,
    num_samples: int,
    num_warmup: int = 500,
    step_size=0.1,
    max_depth: int = 10,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    shared_adaptation: bool = False,
    inv_mass=None,
    chains: ChainShard | None = None,
):
    """Run NUTS chains from ``x0`` (C, D), or one chain from ``x0`` (D,).

    ``logprob_fn(v)`` takes one vector (D,) and returns a scalar
    (``model_logprob``'s); each leaf evaluates it and its gradient over the
    chains at once. ``generator``: a ``torch.Generator`` on ``x0``'s device.

    ``shared_adaptation``: warmup's accept statistics and Welford variances
    are averaged over the chains (BASELINE's "shared step-size
    adaptation"); each chain adapts alone otherwise.

    ``chains``: ``x0`` is this rank's share of a run over ranks
    (``ChainShard``; ``parallel.sample_chains`` passes it).

    ``step_size`` and ``inv_mass`` (D,) or (C, D): where warmup starts, or
    with ``num_warmup=0`` the sampler's (resuming from a checkpointed
    ``(x0, step_size, inv_mass)``, or sampling window by window).

    Returns ``(samples, info)``: samples (C, S, D), info = dict(logp,
    accept_prob, diverging, depth, num_leaves: (C, S); step_size (C,);
    inv_mass (C, D)); for one chain without its leading dimension.
    """
    single = x0.dim() == 1
    z = x0[None] if single else x0
    fn = batched_value_and_grad(logprob_fn)
    lp, grad = fn(z)
    inv_mass = torch.ones_like(z) if inv_mass is None else torch.as_tensor(inv_mass).to(z).expand_as(z).clone()

    if num_warmup > 0:
        # Stan-style windowed warmup (``warmup_schedule``): fast step-size-only
        # buffers bracket doubling slow windows; each slow window re-estimates
        # the diagonal mass from fresh Welford moments and restarts dual
        # averaging against the new metric
        da = da_init(per_chain(z, step_size))
        for phase, span in warmup_schedule(num_warmup):
            if span <= 0:
                continue
            z, lp, grad, da, w = _warmup_steps(fn, z, lp, grad, generator, span, da, welford_init(z), inv_mass,
                                               max_depth, target_accept, adapt_mass, shared_adaptation, chains)
            if phase == "slow" and adapt_mass:
                da, inv_mass = nuts_slow_window_close(da, w, shared_adaptation, chains)
        eps = torch.exp(da.log_step_avg)
    else:
        eps = per_chain(z, step_size)

    draws = []
    for _ in range(num_samples):
        tr = _nuts_transition(fn, z, lp, grad, generator, eps, inv_mass, max_depth, chains)
        z, lp, grad = tr.z, tr.logp, tr.grad
        draws.append(tr)
    samples = torch.stack([t.z for t in draws], dim=1)
    info = {k: torch.stack([getattr(t, k) for t in draws], dim=1)
            for k in ("logp", "accept_prob", "diverging", "depth", "num_leaves")}
    info.update(step_size=eps, inv_mass=inv_mass)
    if single:
        return samples[0], {k: v[0] for k, v in info.items()}
    return samples, info
