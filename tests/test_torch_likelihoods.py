"""Parity of the port's likelihoods and densities (gpflow_slim_tpu_torch) with
the JAX package, on the CPU in float64: every likelihood that came with the
full-data variational slice, each of its six methods, and the gradients
through ``SwitchedLikelihood`` with restricted-support children.

Both packages get the same numpy arrays; the port loads the JAX
likelihood's unconstrained values through ``interop.load_unconstrained``.
Where the JAX package raises (a ``SwitchedLikelihood`` has no moments of
its own; ``Ordinal``'s moments do not broadcast over the quadrature axis),
the port must raise too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import GRAD_RTOL, VALUE_RTOL

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.params import parameters as jax_parameters

torch.set_num_threads(2)

N = 12
METHODS = ["logp", "conditional_mean", "conditional_variance", "predict_mean_and_var", "predict_density",
           "variational_expectations"]


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _switched_y(rng, children):
    """Y (N, 2) of a SwitchedLikelihood over ``children``: each row's data
    inside its child's support, its index in the last column."""
    ind = np.arange(N) % len(children)
    y = np.empty(N)
    for i, c in enumerate(children):
        rows = ind == i
        y[rows] = {"gaussian": rng.randn(rows.sum()), "gamma": rng.gamma(2.0, 1.0, rows.sum()),
                   "beta": rng.uniform(0.05, 0.95, rows.sum()),
                   "exponential": rng.exponential(1.0, rows.sum())}[c]
    return np.stack([y, ind.astype(float)], axis=1)


def _child(pkg, c, i):
    L = pkg.likelihoods
    return {"gaussian": lambda: L.Gaussian(variance=0.3, name=f"c{i}"),
            "gamma": lambda: L.Gamma(shape=1.7, name=f"c{i}"),
            "beta": lambda: L.Beta(scale=2.5, name=f"c{i}"),
            "exponential": lambda: L.Exponential(name=f"c{i}")}[c]()


# name -> (build(pkg), number of latents, Y(rng))
CASES = {
    "poisson": (lambda pkg: pkg.likelihoods.Poisson(), 1, lambda r: r.poisson(1.5, (N, 1)).astype(float)),
    "poisson_binsize": (lambda pkg: pkg.likelihoods.Poisson(binsize=2.5), 1,
                        lambda r: r.poisson(1.5, (N, 1)).astype(float)),
    # a link other than exp: the base class's quadrature
    "poisson_softplus": (lambda pkg: pkg.likelihoods.Poisson(
        invlink=jax.nn.softplus if pkg is gfs else torch.nn.functional.softplus), 1,
        lambda r: r.poisson(1.5, (N, 1)).astype(float)),
    "exponential": (lambda pkg: pkg.likelihoods.Exponential(), 1, lambda r: r.exponential(1.0, (N, 1))),
    "studentt": (lambda pkg: pkg.likelihoods.StudentT(deg_free=4.0, scale=0.8), 1, lambda r: r.randn(N, 1)),
    "gamma": (lambda pkg: pkg.likelihoods.Gamma(shape=1.7), 1, lambda r: r.gamma(2.0, 1.0, (N, 1))),
    "beta": (lambda pkg: pkg.likelihoods.Beta(scale=2.5), 1, lambda r: r.uniform(0.05, 0.95, (N, 1))),
    "multiclass": (lambda pkg: pkg.likelihoods.MultiClass(3), 3, lambda r: r.randint(0, 3, (N, 1)).astype(float)),
    "switched": (lambda pkg: pkg.likelihoods.SwitchedLikelihood(
        [_child(pkg, c, i) for i, c in enumerate(("gaussian", "gamma", "beta"))]), 1,
        lambda r: _switched_y(r, ("gaussian", "gamma", "beta"))),
    "ordinal": (lambda pkg: pkg.likelihoods.Ordinal(bin_edges=np.array([-1.0, 0.0, 1.2])), 1,
                lambda r: r.randint(0, 4, (N, 1)).astype(float)),
}
# methods the JAX package does not define for a likelihood (it raises)
RAISES = {("switched", "conditional_mean"), ("switched", "conditional_variance"),
          ("switched", "predict_mean_and_var"), ("ordinal", "predict_mean_and_var")}


def _pair(name, seed=0):
    build, P, make_y = CASES[name]
    rng = np.random.RandomState(seed)
    Y = make_y(rng)
    jl, tl = build(gfs), build(gft)
    tl.to(torch.float64)
    gft.interop.load_unconstrained(tl, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jl)})
    F = rng.randn(N, P)
    Fmu = rng.randn(N, P)
    Fvar = 0.05 + rng.rand(N, P) ** 2
    return jl, tl, Y, F, Fmu, Fvar


def _args(method, Y, F, Fmu, Fvar):
    return {"logp": (F, Y), "conditional_mean": (F,), "conditional_variance": (F,),
            "predict_mean_and_var": (Fmu, Fvar), "predict_density": (Fmu, Fvar, Y),
            "variational_expectations": (Fmu, Fvar, Y)}[method]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", list(CASES))
def test_likelihood_method_matches_jax(name, method):
    jl, tl, Y, F, Fmu, Fvar = _pair(name)
    args = _args(method, Y, F, Fmu, Fvar)
    if (name, method) in RAISES:
        with pytest.raises(Exception):
            getattr(jl, method)(*map(jnp.asarray, args))
        with pytest.raises((NotImplementedError, RuntimeError)):
            getattr(tl, method)(*map(_t, args))
        return
    want = getattr(jl, method)(*map(jnp.asarray, args))
    with torch.no_grad():
        got = getattr(tl, method)(*map(_t, args))
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w, rtol=VALUE_RTOL, atol=VALUE_RTOL * np.abs(w).max())


@pytest.mark.parametrize("children", [("gaussian", "gamma"), ("gaussian", "beta"),
                                      ("gaussian", "gamma", "beta", "exponential")])
def test_switched_gradients_finite_and_match_jax(children):
    """A Gamma, Beta or Exponential child sees only its own rows (``_SAFE_Y``
    elsewhere): the variational expectations' gradient, with respect to the
    moments and every child's parameters, is finite and equal to JAX's."""
    rng = np.random.RandomState(3)
    Y = _switched_y(rng, children)
    Y[Y[:, 1] == 0, 0] = -np.abs(Y[Y[:, 1] == 0, 0])  # Gaussian rows outside the others' support
    jl = gfs.likelihoods.SwitchedLikelihood([_child(gfs, c, i) for i, c in enumerate(children)])
    tl = gft.likelihoods.SwitchedLikelihood([_child(gft, c, i) for i, c in enumerate(children)]).to(torch.float64)
    gft.interop.load_unconstrained(tl, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jl)})
    Fmu, Fvar = rng.randn(N, 1), 0.05 + rng.rand(N, 1) ** 2

    def jloss(lik, mu, var):
        return jnp.sum(lik.variational_expectations(mu, var, jnp.asarray(Y)))

    jval, (jg_lik, jg_mu, jg_var) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jl, Fmu, Fvar)
    mu, var = _t(Fmu).requires_grad_(), _t(Fvar).requires_grad_()
    val = torch.sum(tl.variational_expectations(mu, var, _t(Y)))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=VALUE_RTOL)
    for got, want in ((mu.grad, jg_mu), (var.grad, jg_var)):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max())
    want = {gft.interop.port_name(n): np.asarray(p.unconstrained) for n, p in jax_parameters(jg_lik)}
    for n, p in gft.params.parameters(tl):
        assert p.unconstrained.grad is not None and bool(torch.isfinite(p.unconstrained.grad).all()), n
        np.testing.assert_allclose(p.unconstrained.grad.numpy(), want[n], rtol=GRAD_RTOL, err_msg=n)


@pytest.mark.parametrize("density, args", [
    ("poisson", ([0.3, 1.7, 4.2], [0.0, 2.0, 7.0])),
    ("exponential", ([0.3, 1.7, 4.2], [0.1, 2.0, 7.0])),
    ("student_t", ([0.1, -1.3, 2.2], [0.0, 0.5, -1.0], [0.8, 1.3, 2.0], 4.0)),
])
def test_densities_match_jax(density, args):
    want = getattr(gfs.densities, density)(*[jnp.asarray(a) if isinstance(a, list) else a for a in args])
    got = getattr(gft.densities, density)(*[_t(a) if isinstance(a, list) else a for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=VALUE_RTOL)


def test_multiclass_prob_is_largest_sums_to_one():
    """tests/test_likelihoods.py's case on the port: the class probabilities
    sum to one up to the reference's CDF clamp."""
    rng = np.random.RandomState(0)
    lik = gft.likelihoods.MultiClass(4)
    pm, _ = lik.predict_mean_and_var(_t(rng.randn(7, 4)), _t(0.1 + rng.rand(7, 4)))
    np.testing.assert_allclose(pm.sum(1).numpy(), 1.0, atol=5e-4)
    assert bool((pm > 0).all())
