"""MCMC chains batched on one device, or split over the ranks of a mesh
axis (counterpart of ``gpflow_slim_tpu.parallel.chains``).

The JAX package ``vmap``s one chain's sampler over the chains of a device
and ``shard_map``s the chains over a mesh axis, sharing the warmup
adaptation statistics with ``lax.pmean`` over both. The port's samplers
take the chains as the leading dimension of their state, so
``sample_chains`` hands a rank all its chains at once, with the mean over
the chains in place of the ``pmean``: the BASELINE "8+ parallel chains
with shared step-size adaptation". With a mesh, each rank runs its
``C / n`` chains (``mcmc.base.ChainShard``): the shared statistics are
all-gathered over the axis's process group and averaged over all C, every
random tensor is drawn for all C chains and sliced, and the samplers'
loops run until no chain on any rank is live (one ``all_reduce`` of the
live count where the loop already reads it), so each chain's trajectory
does not depend on the number of ranks, as each JAX chain has its own key.
The result is gathered to every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..mcmc.base import ChainShard
from ..mcmc.hmc import hmc as _hmc
from ..mcmc.nuts import nuts as _nuts

__all__ = ["sample_chains"]


def _gather(t, chains):
    """The chains' leading rows of ``t`` from every rank, in rank order."""
    flag = t.dtype == torch.bool
    t = (t.to(torch.uint8) if flag else t).contiguous()
    parts = [torch.empty_like(t) for _ in range(chains.total // chains.count)]
    dist.all_gather(parts, t, group=chains.group)
    out = torch.cat(parts)
    return out.bool() if flag else out


def sample_chains(
    logprob_fn,
    x0s,
    generator,
    num_samples: int,
    sampler: str = "nuts",
    mesh=None,
    axis: str = "chains",
    shared_adaptation: bool = True,
    **sampler_kwargs,
):
    """Run ``C = x0s.shape[0]`` chains, drawing from ``generator`` (a
    ``torch.Generator`` on ``x0s``'s device). Without a mesh (or on an axis
    of one rank) all on ``x0s``'s device; with one, each rank of
    ``mesh[axis]`` runs its contiguous ``C / n`` of them (C divisible by the
    axis size; every rank passes all of ``x0s`` and a generator seeded
    alike). ``shared_adaptation`` averages the warmup adaptation statistics
    over all the chains (for HMC, effective with ``adapt_step_size=True``).
    Returns ``(samples (C, S, dim), info)`` on every rank."""
    if sampler == "nuts":
        base = _nuts
    elif sampler == "hmc":
        base = _hmc
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    n = 1 if mesh is None else mesh.shape[axis]
    if n == 1:
        return base(logprob_fn, x0s, generator, num_samples, shared_adaptation=shared_adaptation, **sampler_kwargs)
    C = x0s.shape[0]
    if C % n != 0:
        raise ValueError(f"{C} chains not divisible by mesh axis {n}")
    if mesh.group(axis) is None:
        raise ValueError(f"mesh axis {axis!r} has {n} ranks but no process group")
    c = C // n
    chains = ChainShard(C, mesh.coordinate(axis) * c, c, mesh.group(axis))
    samples, info = base(logprob_fn, x0s[chains.start:chains.start + c], generator, num_samples,
                         shared_adaptation=shared_adaptation, chains=chains, **sampler_kwargs)
    return _gather(samples, chains), {k: _gather(v, chains) for k, v in info.items()}
