"""Parity of the port's training loops (gpflow_slim_tpu_torch
``training.make_step_fn`` and ``training.fit_lbfgs``) and of its entry point
(``entry.entry``) with the JAX package, on the CPU in float64 (the entry
point's float32 model against the JAX package's float64 evaluation).

``make_step_fn`` follows the JAX ``make_step_fn`` step for step with the
same optimizer; torch's L-BFGS and optax's take different paths (line
searches of their own), so ``fit_lbfgs`` is held to the JAX package's at
the optimum.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_gpr import GRAD_RTOL, VALUE_RTOL, _pair, _unconstrained, route  # noqa: F401  (route is a fixture)

import __graft_entry__
import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.params import parameters as jax_parameters

torch.set_num_threads(2)

STEP_RTOL = 1e-10   # losses and parameters of a step-for-step trajectory
OPT_VALUE_RTOL = 1e-8  # the objective at the L-BFGS optimum
OPT_PARAM_ATOL = 1e-4  # the hyperparameters (unconstrained) at the optimum

OPTIMIZERS = {
    "adam": (lambda: optax.adam(0.01), lambda ps: torch.optim.Adam(ps, lr=0.01)),
    "sgd": (lambda: optax.sgd(1e-3), lambda ps: torch.optim.SGD(ps, lr=1e-3)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_make_step_fn_matches_jax_step_for_step(name, route):
    jax_opt, torch_opt = OPTIMIZERS[name]
    jm, tm = _pair("RBF", N=40)
    jstep, (leaves, treedef, state) = gfs.training.optimize.make_step_fn(jm, jax_opt())
    jstep = jax.jit(jstep)
    step, opt = gft.training.make_step_fn(tm, torch_opt)
    assert isinstance(opt, torch.optim.Optimizer)
    for i in range(5):
        leaves, state, jloss = jstep(leaves, state)
        loss = step()
        assert loss.shape == () and not loss.requires_grad
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_RTOL, err_msg=f"step {i}")
    got = {n: p.unconstrained.detach().numpy() for n, p in gft.params.parameters(tm)}
    for n, want in _unconstrained(jax.tree_util.tree_unflatten(treedef, leaves)).items():
        np.testing.assert_allclose(got[n], want, rtol=STEP_RTOL, err_msg=n)


def test_make_step_fn_takes_a_loss_fn_and_skips_untrainable():
    _, tm = _pair("RBF", N=30)
    tm.likelihood.variance.trainable = False
    before = float(tm.likelihood.variance.value)
    calls = []

    def loss_fn(m):
        calls.append(m)
        return -m.build_likelihood()

    step, opt = gft.training.make_step_fn(tm, lambda ps: torch.optim.Adam(ps, lr=0.05), loss_fn)
    assert len(opt.param_groups[0]["params"]) == 2
    losses = [step().item() for _ in range(3)]
    assert calls == [tm] * 3 and losses[-1] < losses[0]
    assert float(tm.likelihood.variance.value) == before


def test_fit_lbfgs_matches_jax_at_the_optimum(route):
    jm, tm = _pair("RBF", N=40)
    jm2, jlosses = gfs.training.fit_lbfgs(jm, num_steps=100)
    tm2, losses = gft.training.fit_lbfgs(tm, num_steps=100)
    assert tm2 is tm and losses.shape == (100,) and jlosses.shape == (100,)
    assert bool(torch.isfinite(losses).all()) and bool((losses[1:] <= losses[:-1]).all())
    with torch.no_grad():
        np.testing.assert_allclose(tm.objective().item(), float(jm2.objective()), rtol=OPT_VALUE_RTOL)
    got = {n: p.unconstrained.detach().numpy() for n, p in gft.params.parameters(tm)}
    for n, want in _unconstrained(jm2).items():
        np.testing.assert_allclose(got[n], want, atol=OPT_PARAM_ATOL, err_msg=n)


def test_fit_lbfgs_takes_a_loss_fn():
    """A loss of the caller's (here the objective of one output of a model
    with two) is what L-BFGS minimizes, and its losses are those of the
    starting points of the steps."""
    _, tm = _pair("RBF", N=30)
    _, losses = gft.training.fit_lbfgs(tm, num_steps=4, loss_fn=lambda m: -m.build_likelihood() + 1.0)
    with torch.no_grad():
        final = -tm.build_likelihood().item() + 1.0
    assert losses.shape == (4,) and final <= losses[-1].item() <= losses[0].item()


def test_fit_lbfgs_shortens_a_step_into_nan():
    """A trial point whose loss is NaN (a factorization that failed) makes
    the line search shorten the step, not stall: here the quadratic's
    minimum at 3 lies past a wall of NaN at 2.4."""
    class Quadratic(gft.params.Module):
        def __init__(self):
            super().__init__()
            self.x = gft.params.Param(0.0, name="x")

    m = Quadratic()

    def loss_fn(mm):
        # NaN value and gradient past the wall, as a failed Cholesky gives
        x = mm.x.value
        return torch.square(x - 3.0) + 0.0 * torch.sqrt(2.4 - x)

    _, losses = gft.training.fit_lbfgs(m, num_steps=6, loss_fn=loss_fn)
    assert bool(torch.isfinite(losses).all()) and bool((losses[1:] <= losses[:-1]).all())
    assert 2.0 < m.x.value.item() < 2.4


def test_entry_on_the_cpu_matches_jax():
    """The port's ``entry()`` (float32, on the CPU) against the JAX
    package's ``entry()`` (float64 here): the flagship GPR's objective and
    gradient, within float32's rounding at N=2048."""
    jfn, (jm,) = __graft_entry__.entry()
    jloss, jgrads = jfn(jm)
    fn, (tm,) = gft.entry.entry(device="cpu")
    assert tm.X.shape == (2048, 1) and tm.X.dtype == torch.float32
    loss, grads = fn(tm)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = {n: float(p.unconstrained) for n, p in jax_parameters(jgrads)}
    assert set(grads) == set(want)
    for n, g in grads.items():
        np.testing.assert_allclose(g.item(), want[n], rtol=1e-4, err_msg=n)


def test_entry_model_in_float64_matches_jax(route):
    jm = __graft_entry__._flagship_model(N=256, dtype=np.float64)
    tm = gft.entry.flagship_model(N=256, device="cpu", dtype=np.float64)
    jloss, jgrads = jax.value_and_grad(lambda m: m.objective())(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=VALUE_RTOL)
    for n, p in gft.params.parameters(tm):
        np.testing.assert_allclose(p.unconstrained.grad.item(), float(dict(jax_parameters(jgrads))[n].unconstrained),
                                   rtol=GRAD_RTOL, err_msg=n)
