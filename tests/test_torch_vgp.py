"""Parity of the port's full-data variational models (gpflow_slim_tpu_torch
``VGP`` and ``VGPOpperArchambeau``) and mean functions with the JAX package,
on the CPU in float64: the ELBO and every gradient over five likelihoods,
the predictions, the twins of tests/test_models.py's VGP tests, and the
mean functions with their ``+`` and ``*``.

Both models are built from the same numpy arrays, at the same random
unconstrained point; the port loads the JAX model's values (the packed
``q_sqrt`` included) through ``interop.load_unconstrained``. Model cases run
on both of the port's routes (the ``route`` fixture): the plain composite,
and the kernel route that CUDA float32 tensors take (lower-tile Gram,
padded factor-only Cholesky with its VJP on the TRSM, cross Gram, the
factor under ``torch.func.vmap`` for Opper-Archambeau), here through the
kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import GRAD_RTOL, VALUE_RTOL, route  # noqa: F401  (route is a fixture)
from test_torch_svgp import ATOL, _random_q

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.params import parameters as jax_parameters

torch.set_num_threads(2)

LIKELIHOODS = ["gaussian", "poisson", "studentt", "multiclass", "switched"]


def _data(lik, N, rng):
    """X (N, D), Y and the number of latents; in the switched case X's and
    Y's last column is the group index."""
    x = rng.uniform(0, 1, (N, 1))
    f = np.sin(8 * x)
    if lik == "gaussian":
        return x, f + 0.1 * rng.randn(N, 2), 2
    if lik == "poisson":
        return x, rng.poisson(np.exp(f)).astype(float), 1
    if lik == "studentt":
        return x, f + 0.3 * rng.standard_t(4, (N, 1)), 1
    if lik == "multiclass":
        return x, np.argmax(np.concatenate([f, -f, np.cos(5 * x)], 1), 1)[:, None].astype(float), 3
    group = (np.arange(N) % 2).astype(float)[:, None]
    y = np.where(group == 0, f + 0.1 * rng.randn(N, 1), rng.gamma(2.0, 1.0, (N, 1)))
    return np.concatenate([x, group], 1), np.concatenate([y, group], 1), 1


def _parts(pkg, lik):
    L, M = pkg.likelihoods, pkg.mean_functions
    if lik == "switched":
        kern = pkg.kernels.RBF(1, variance=1.2, lengthscales=0.3, active_dims=[0])
        return kern, L.SwitchedLikelihood([L.Gaussian(variance=0.2, name="g0"), L.Gamma(shape=1.5, name="g1")]), \
            M.SwitchedMeanFunction([M.Constant(0.3, name="m0"), M.Linear(A=[[0.5]], b=[0.1], name="m1")])
    kern = pkg.kernels.RBF(1, variance=1.2, lengthscales=0.3)
    like = {"gaussian": lambda: L.Gaussian(variance=0.3), "poisson": lambda: L.Poisson(),
            "studentt": lambda: L.StudentT(deg_free=4.0, scale=0.5), "multiclass": lambda: L.MultiClass(3)}[lik]()
    return kern, like, None


def _random_point(model_cls, jm, N, P, rng):
    """The JAX model's unconstrained values with q moved away from its
    initialisation."""
    arrays = {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}
    if model_cls == "VGP":
        arrays["q_mu"], arrays["q_sqrt"] = _random_q(N, P, False, rng)
        arrays["q_mu"] *= 0.5
    else:
        arrays["q_alpha"] = 0.3 * rng.randn(N, P)
        arrays["q_lambda"] = np.asarray(gfs.transforms.positive().backward(rng.uniform(0.5, 1.5, (N, P))))
    return arrays


def _pair(model_cls, lik, N=24, seed=0):
    """The same model in both packages, at the same random unconstrained
    point; also X and Y."""
    rng = np.random.RandomState(seed)
    X, Y, P = _data(lik, N, rng)

    def make(pkg, **kw):
        kern, like, mean = _parts(pkg, lik)
        return getattr(pkg.models, model_cls)(X, Y, kern=kern, likelihood=like, mean_function=mean,
                                              num_latent=P, **kw)

    jm = make(gfs)
    tm = make(gft, device="cpu", dtype=torch.float64)
    arrays = _random_point(model_cls, jm, N, P, rng)
    jm = gfs.params.unpack_trainable(jm, jnp.concatenate(
        [jnp.ravel(arrays[n]) for n, p in jax_parameters(jm) if p.trainable]))
    gft.interop.load_unconstrained(tm, arrays)
    return jm, tm, X, Y


def _assert_grads_close(tm, jgrads):
    # each array relative to its largest entry: entries near 0 carry no digits
    want = {gft.interop.port_name(n): np.asarray(p.unconstrained) for n, p in jax_parameters(jgrads)}
    assert set(want) == {n for n, _ in gft.params.parameters(tm)}
    for n, p in gft.params.parameters(tm):
        np.testing.assert_allclose(p.unconstrained.grad.numpy(), want[n], rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want[n]).max(), err_msg=n)


@pytest.mark.parametrize("lik", LIKELIHOODS)
@pytest.mark.parametrize("model_cls", ["VGP", "VGPOpperArchambeau"])
def test_elbo_and_grad_match_jax(model_cls, lik, route):
    jm, tm, _, _ = _pair(model_cls, lik)
    jloss, jgrads = jax.value_and_grad(lambda m: m.objective())(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=VALUE_RTOL)
    _assert_grads_close(tm, jgrads)


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("model_cls", ["VGP", "VGPOpperArchambeau"])
def test_predictions_match_jax(model_cls, full_cov, route):
    jm, tm, _, _ = _pair(model_cls, "gaussian")
    Xnew = np.random.RandomState(5).uniform(-0.1, 1.1, (7, 1))
    fn = "predict_f_full_cov" if full_cov else "predict_f"
    want = getattr(jm, fn)(Xnew)
    with torch.no_grad():
        got = getattr(tm, fn)(Xnew)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("model_cls", ["VGP", "VGPOpperArchambeau"])
def test_poisson_predict_y_and_density_match_jax(model_cls, route):
    jm, tm, X, Y = _pair(model_cls, "poisson")
    with torch.no_grad():
        got = (*tm.predict_y(X), tm.predict_density(X, Y))
    want = (*jm.predict_y(X), jm.predict_density(X, Y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=VALUE_RTOL, atol=ATOL)


# -- tests/test_models.py's VGP cases, on the port -------------------------

def _make_data(N=30, D=2, P=1, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(N, P)
    return X, Y


def _make_kern():
    return gft.kernels.RBF(2, variance=1.3, lengthscales=0.8)


def _freeze_hypers(m):
    for p in (m.kern.variance, m.kern.lengthscales, m.likelihood.variance):
        p.trainable = False


def _cpu(cls, *args, **kw):
    return cls(*args, device="cpu", dtype=torch.float64, **kw)


def test_vgp_optimal_approaches_gpr():
    X, Y = _make_data(N=15)
    gpr = _cpu(gft.models.GPR, X, Y, kern=_make_kern())
    noise = gpr.likelihood.variance.value.item()
    vgp = _cpu(gft.models.VGP, X, Y, kern=_make_kern(), likelihood=gft.likelihoods.Gaussian(variance=noise))
    with torch.no_grad():
        lml = float(gpr.build_likelihood())
    _freeze_hypers(vgp)
    gft.training.fit(vgp, num_steps=2000, learning_rate=0.05)
    with torch.no_grad():
        elbo = float(vgp.build_likelihood())
    assert elbo <= lml + 1e-6
    assert elbo > lml - 0.5  # the conjugate case: the optimum is the lml


def test_vgp_opper_archambeau_conjugate_matches_gpr():
    X, Y = _make_data(N=15)
    gpr = _cpu(gft.models.GPR, X, Y, kern=_make_kern())
    noise = gpr.likelihood.variance.value.item()
    vgp = _cpu(gft.models.VGPOpperArchambeau, X, Y, kern=_make_kern(),
               likelihood=gft.likelihoods.Gaussian(variance=noise))
    _freeze_hypers(vgp)
    with torch.no_grad():
        lml = float(gpr.build_likelihood())
        assert float(vgp.build_likelihood()) <= lml + 1e-6
    gft.training.fit(vgp, num_steps=3000, learning_rate=0.05)
    with torch.no_grad():
        elbo = float(vgp.build_likelihood())
        assert elbo <= lml + 1e-6
        assert elbo > lml - 0.5
        # predictions at the optimum match exact GPR
        Xnew = np.random.RandomState(3).randn(6, 2)
        for a, b in zip(gpr.predict_f(Xnew), vgp.predict_f(Xnew)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.05)


def test_vgp_opper_archambeau_classification():
    rng = np.random.RandomState(4)
    X = rng.uniform(-1, 1, (40, 1))
    Y = (np.sin(4 * X) > 0).astype(float)
    m = _cpu(gft.models.VGPOpperArchambeau, X, Y, kern=gft.kernels.RBF(1, lengthscales=0.4),
             likelihood=gft.likelihoods.Bernoulli())
    before = m.objective().item()
    gft.training.fit(m, num_steps=500, learning_rate=0.05)
    with torch.no_grad():
        assert float(m.objective()) < before - 3
        p, _ = m.predict_y(X)
    assert float(np.mean((p.numpy() > 0.5) == (Y > 0.5))) > 0.85


def test_vgp_switched_likelihood_and_mean_gradients_flow():
    """Grouped data (the index in X's and Y's last column) gives a nonzero
    gradient to every per-group parameter."""
    rng = np.random.RandomState(0)
    N = 30
    x = rng.uniform(0, 1, (N, 1))
    group = (rng.rand(N) < 0.5).astype(float)
    y = (np.sin(8 * x[:, 0]) + 1.5 * group + 0.1 * rng.randn(N))[:, None]
    X = np.concatenate([x, group[:, None]], axis=1)
    Y = np.concatenate([y, group[:, None]], axis=1)
    L, M = gft.likelihoods, gft.mean_functions
    m = _cpu(gft.models.VGP, X, Y, kern=gft.kernels.RBF(1, active_dims=[0], lengthscales=0.2),
             likelihood=L.SwitchedLikelihood([L.Gaussian(name="g0"), L.Gaussian(name="g1")]),
             mean_function=M.SwitchedMeanFunction([M.Constant(0.0, name="m0"), M.Constant(0.0, name="m1")]),
             num_latent=1)
    m.objective().backward()
    for i in (0, 1):
        assert abs(float(m.likelihood.likelihood_list[i].variance.unconstrained.grad)) > 0
        assert abs(float(m.mean_function.meanfunctions[i].c.unconstrained.grad.sum())) > 0


# -- mean functions --------------------------------------------------------

def _means(pkg):
    M = pkg.mean_functions
    lin = lambda n: M.Linear(A=[[0.4], [-0.7]], b=[0.2], name=n)  # noqa: E731
    return {
        "identity": lambda: M.Identity(),
        "additive": lambda: M.Additive(M.Constant(1.3, name="c"), lin("l")),
        "product": lambda: M.Product(M.Constant(-0.6, name="c"), lin("l")),
        "add_operator": lambda: lin("l") + M.Constant(0.5, name="c"),
        "mul_operator": lambda: (lin("l") * M.Constant(2.0, name="c")) + M.Zero(),
        "switched": lambda: M.SwitchedMeanFunction([M.Constant(2.5, name="c"), lin("l"), M.Zero()]),
    }


@pytest.mark.parametrize("name", list(_means(gfs)))
def test_mean_function_matches_jax(name):
    """Values and the gradient of a weighted sum, against JAX; the switched
    mean takes X's last column as the group (0, 1, 2)."""
    rng = np.random.RandomState(2)
    X = rng.randn(9, 2)
    if name == "switched":
        X = np.concatenate([X, (np.arange(9) % 3)[:, None].astype(float)], 1)
    jmf, tmf = _means(gfs)[name](), _means(gft)[name]().to(torch.float64)
    gft.interop.load_unconstrained(tmf, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jmf)})
    want = np.asarray(jmf(jnp.asarray(X)))
    got = tmf(torch.tensor(X))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=VALUE_RTOL, atol=1e-14)
    if not gft.params.parameters(tmf):
        assert not jax_parameters(jmf)
        return
    W = rng.randn(*want.shape)
    jg = jax.grad(lambda m: jnp.sum(m(jnp.asarray(X)) * W))(jmf)
    torch.sum(got * torch.tensor(W)).backward()
    wants = {gft.interop.port_name(n): np.asarray(p.unconstrained) for n, p in jax_parameters(jg)}
    assert set(wants) == {n for n, _ in gft.params.parameters(tmf)}
    for n, p in gft.params.parameters(tmf):
        np.testing.assert_allclose(p.unconstrained.grad.numpy(), wants[n], rtol=GRAD_RTOL, err_msg=n)


def test_switched_mean_function():
    """tests/test_models.py's case: X's last column selects the group's mean."""
    rng = np.random.RandomState(3)
    Xd = rng.randn(9, 2)
    groups = np.array([0, 1, 0, 1, 1, 0, 1, 0, 0])
    X = torch.tensor(np.concatenate([Xd, groups[:, None].astype(float)], axis=1))
    M = gft.mean_functions
    m0, m1 = M.Constant(2.5).double(), M.Linear(A=np.array([[1.0], [-1.0]]), b=np.array([0.5])).double()
    out = M.SwitchedMeanFunction([m0, m1])(X)
    exp0, exp1 = m0(torch.tensor(Xd)), m1(torch.tensor(Xd))
    for n in range(9):
        np.testing.assert_allclose(out[n].detach().numpy(), (exp0 if groups[n] == 0 else exp1)[n].detach().numpy(),
                                   atol=1e-12)
