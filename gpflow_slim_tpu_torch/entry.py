"""The port's entry points: one objective+gradient evaluation on the
flagship exact GPR (N=2048 points of a noisy wiggle on [0, 1], RBF with
lengthscale 0.1, float32), the model and data of ``__graft_entry__.py``'s
``entry()``, built with numpy and placed on the card unless the caller asks
for another device. On the card it runs the Gram operand and the fused
factor/solve/logdet kernels, and their backwards::

    fn, args = entry()
    loss, grads = fn(*args)

``dryrun_multichip(n_ranks)`` runs the distributed paths on a world of
``n_ranks`` ranks, each held to its unsharded counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import kernels, likelihoods, mcmc, models, parallel, priors, transforms
from .params import Param, parameters, trainable_leaves


def flagship_model(N: int = 2048, device=None, dtype=np.float32):
    """The flagship GPR: X ~ U[0, 1] from RandomState(0), Y = sin(12 X) +
    0.66 cos(25 X) + 0.1 noise, RBF with lengthscale 0.1."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(dtype)
    Y = (np.sin(12 * X) + 0.66 * np.cos(25 * X) + rng.randn(N, 1) * 0.1).astype(dtype)
    return models.GPR(X, Y, kern=kernels.RBF(1, lengthscales=0.1), device=device)


def entry(device=None):
    """``(fn, args)``: ``fn(model)`` is one objective+gradient evaluation,
    ``(loss, {name: gradient of the unconstrained value})`` for the
    trainable Params, the counterpart of ``jax.value_and_grad`` of the
    objective; ``args`` is ``(flagship_model(device=device),)``."""

    def step(model):
        named = [(n, p.unconstrained) for n, p in parameters(model) if p.trainable]
        loss = model.objective()
        grads = torch.autograd.grad(loss, [t for _, t in named])
        return loss.detach(), {n: g for (n, _), g in zip(named, grads)}

    return step, (flagship_model(device=device),)


def _close(what, got, want, rtol):
    got, want = torch.as_tensor(got).detach().double().cpu(), torch.as_tensor(want).detach().double().cpu()
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if not err <= rtol:
        raise AssertionError(f"dryrun_multichip: {what} is {err:.3e} (relative, max-norm) off its unsharded "
                             f"counterpart (tolerance {rtol:g})")


def _value_and_grads(loss_fn, model):
    leaves = [t for _, t in trainable_leaves(model)]
    loss = loss_fn(model)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def dryrun_multichip(n_ranks: int, device=None, dtype=torch.float32):
    """The distributed paths on a world of ``n_ranks`` ranks (joined by
    ``parallel.initialize_distributed`` first; none is needed for one
    rank), at tiny shapes, as ``__graft_entry__.py``'s ``dryrun_multichip``
    runs them: the distributed exact GPR (ring Gram, blocked factor) with an
    Adam step, the data-parallel SVGP, the distributed CG, the grid
    Cholesky and grid GPR on a 2-D mesh, and NUTS chains over the ranks on a
    GPR hyperposterior. Each is asserted equal to its unsharded counterpart
    on this rank (the loss and every gradient; the chains draw for draw).
    Models go on the card unless ``device`` says otherwise. Returns the
    losses."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_ranks:
        raise ValueError(f"dryrun_multichip({n_ranks}) needs a world of {n_ranks} ranks; this one has {world}")
    rtol = 1e-4 if dtype == torch.float32 else 1e-9
    mesh = parallel.make_mesh({"data": n_ranks})
    N = max(8 * n_ranks, 64)
    bs = N // n_ranks if (N // n_ranks) % 2 == 0 else 8
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(6 * X) + 0.1 * rng.randn(N, 1)
    kw = dict(device=device, dtype=dtype)
    out = {}

    # 1) the distributed exact GPR and one Adam step
    m = models.GPR(X, Y, kern=kernels.RBF(1, lengthscales=0.3), **kw)
    loss_fn = parallel.make_distributed_gpr_loss(m, mesh, axis="data", block_size=bs)
    for step in range(2):
        loss, grads = _value_and_grads(loss_fn, m)
        want, want_g = _value_and_grads(lambda mm: mm.objective(), m)
        _close(f"the distributed GPR loss (step {step})", loss, want, rtol)
        for g, w in zip(grads, want_g):
            _close(f"a distributed GPR gradient (step {step})", g, w, 10 * rtol)
        if step == 0:
            opt = torch.optim.Adam([t for _, t in trainable_leaves(m)], lr=1e-2)
            for (_, t), g in zip(trainable_leaves(m), grads):
                t.grad = g
            opt.step()
    out["dist_gpr"] = loss.item()

    # 2) the data-parallel SVGP gradient
    svgp = models.SVGP(X, Y, kern=kernels.RBF(1), likelihood=likelihoods.Gaussian(), Z=X[:max(4, n_ranks)].copy(),
                       **kw)
    loss, grads = parallel.dp_value_and_grad(svgp, X, Y, mesh, axis="data")
    want, want_g = _value_and_grads(lambda mm: -(mm.build_likelihood_batch(X, Y) + mm.log_prior()), svgp)
    _close("the data-parallel SVGP loss", loss, want, rtol)
    for g, w in zip(grads.values(), want_g):
        _close("a data-parallel SVGP gradient", g, w, 10 * rtol)
    out["dp_svgp"] = loss.item()

    # 3) the distributed CG against GPRCG on one device (the same probes)
    m_cg = models.GPRCG(X, Y, kern=kernels.RBF(1, lengthscales=0.3), cg_iters=8, num_probes=2, slq_steps=5, **kw)
    loss, grads = _value_and_grads(parallel.make_distributed_cg_loss(m_cg, mesh, axis="data", num_probes=2,
                                                                     cg_iters=8, slq_steps=5), m_cg)
    want, want_g = _value_and_grads(lambda mm: mm.objective(), m_cg)
    _close("the distributed CG loss", loss, want, rtol)
    for g, w in zip(grads, want_g):
        _close("a distributed CG gradient", g, w, 10 * rtol)
    out["dist_cg"] = loss.item()

    # 4) the grid Cholesky and the grid GPR on a 2-D mesh
    Pr = n_ranks // 2 if n_ranks >= 4 and n_ranks % 2 == 0 else n_ranks
    mesh2d = parallel.make_mesh({"rows": Pr, "cols": n_ranks // Pr})
    Ng = 8 * max(n_ranks, 2)
    A = rng.randn(Ng, Ng)
    Kg = torch.as_tensor(A @ A.T + Ng * np.eye(Ng), dtype=dtype, device=m.X.device)
    Lg = parallel.grid_cholesky(Kg, mesh2d, ("rows", "cols"), block_size=8)
    _close("the grid Cholesky", Lg, torch.linalg.cholesky(Kg.double()), rtol)
    Xg = rng.uniform(0, 1, (Ng, 1))
    mg = models.GPR(Xg, np.sin(6 * Xg), kern=kernels.RBF(1, lengthscales=0.3), **kw)
    loss, grads = _value_and_grads(parallel.make_grid_gpr_loss(mg, mesh2d, ("rows", "cols"), block_size=8), mg)
    want, want_g = _value_and_grads(lambda mm: mm.objective(), mg)
    _close("the grid GPR loss", loss, want, rtol)
    for g, w in zip(grads, want_g):
        _close("a grid GPR gradient", g, w, 10 * rtol)
    out["grid_gpr"] = loss.item()

    # 5) NUTS chains over the ranks with shared adaptation, on a GPR
    # hyperposterior (config #4's priors), against the chains on one rank
    m_mc = models.GPR(X, Y, kern=kernels.RBF(1, lengthscales=0.3), **kw)
    pos = transforms.positive
    m_mc.kern.variance = Param(1.0, transform=pos(), prior=priors.LogNormal(0.0, 1.0), name="v", **kw)
    m_mc.kern.lengthscales = Param(0.3, transform=pos(), prior=priors.LogNormal(-1.0, 1.0), name="l", **kw)
    m_mc.likelihood.variance = Param(0.05, transform=pos(), prior=priors.LogNormal(-2.0, 1.0), name="n", **kw)
    m_mc.to(device=m_mc.X.device, dtype=dtype)  # the new Params onto the model's device
    lp, x0, _ = mcmc.model_logprob(m_mc)
    x0s = x0[None].repeat(n_ranks, 1)
    runs = [parallel.sample_chains(lp, x0s, torch.Generator(device=x0.device).manual_seed(0), num_samples=2,
                                   sampler="nuts", mesh=mesh_, axis="data", num_warmup=2, max_depth=4)
            for mesh_ in (mesh, None)]
    _close("the chains over the ranks", runs[0][0], runs[1][0], 0.0 if dtype == torch.float32 else 1e-10)
    out["chains"] = tuple(runs[0][0].shape)
    return out
