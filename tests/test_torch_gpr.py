"""Parity of the port's exact-GPR slice (gpflow_slim_tpu_torch) with the JAX
package, on the CPU in float64: transforms, priors, Params, the objective
and its gradient, Adam training, and the weight interop.

Both models are built from the same numpy arrays and the port loads the
JAX model's unconstrained values through ``interop.load_unconstrained``.
The port's kernel route (operand + fused factor/solve/logdet, the route
CUDA float32 tensors take) is exercised here through its plain versions by
forcing the route on.
"""

import jax
import numpy as np
import pytest
import torch

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu_torch.ops import linalg as port_linalg

torch.set_num_threads(2)

VALUE_RTOL = 1e-10  # f64 objective: the same formula, different BLAS
GRAD_RTOL = 1e-8    # f64 gradients through a Cholesky backward
# Matern12 and Exponential use r = sqrt(d^2 + 1e-12), whose slope 1/(2r) is
# 5e5 at d = 0: it amplifies the rounding of the distance expansion's
# diagonal (a sum that cancels to 0) differently in the two packages
NONSMOOTH_RTOL = 1e-6
NONSMOOTH_ATOL = 1e-8


def _data(N=60, D=1, seed=0, P=1):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0, 1, (N, D))
    Y = np.sin(12 * X[:, :1]) + 0.66 * np.cos(25 * X[:, :1]) + 0.1 * rng.randn(N, P)
    return X, Y


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


def _pair(kern_name, prior=False, mean=None, D=1, N=60, P=1):
    """The same GPR in both packages, at the same unconstrained point."""
    X, Y = _data(N, D, P=P)
    ard = D > 1
    ls = np.linspace(0.2, 0.4, D) if ard else 0.2
    jk = getattr(gfs.kernels, kern_name)(D, variance=1.3, lengthscales=ls, ARD=ard)
    tk = getattr(gft.kernels, kern_name)(D, variance=1.3, lengthscales=ls, ARD=ard)
    if prior:
        jk.lengthscales.prior = gfs.priors.LogNormal(0.0, 1.0)
        tk.lengthscales.prior = gft.priors.LogNormal(0.0, 1.0)
    jmean = tmean = None
    if mean == "linear":
        A, b = 0.3 * np.ones((D, 1)), np.array([0.1])
        jmean, tmean = gfs.mean_functions.Linear(A, b), gft.mean_functions.Linear(A, b)
    jm = gfs.models.GPR(X, Y, kern=jk, mean_function=jmean)
    tm = gft.models.GPR(X, Y, kern=tk, mean_function=tmean, device="cpu", dtype=torch.float64)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    return jm, tm


@pytest.fixture(params=["plain", "kernel_route"])
def route(request, monkeypatch):
    if request.param == "kernel_route":
        calls = []

        def forced(t):
            calls.append(t.dtype)
            return True

        monkeypatch.setattr(port_linalg, "kernels_active", forced)
        yield request.param
        assert calls, "the kernel route was not taken"
    else:
        yield request.param


@pytest.mark.parametrize("kern_name", ["RBF", "Matern52"])
@pytest.mark.parametrize("prior", [False, True])
def test_gpr_objective_and_grad_match_jax(kern_name, prior, route):
    jm, tm = _pair(kern_name, prior=prior)
    jloss, jgrads = jax.value_and_grad(lambda m: m.objective())(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=VALUE_RTOL)
    want = dict(jax_parameters(jgrads))
    for n, p in gft.params.parameters(tm):
        np.testing.assert_allclose(
            p.unconstrained.grad.numpy(), np.asarray(want[n].unconstrained), rtol=GRAD_RTOL, err_msg=n)


# wide_y: 11 columns of Y, wider than the fused kernel's 8-column chunk
@pytest.mark.parametrize("case", ["linear_mean", "ard_d3", "cosine", "exponential", "wide_y"])
def test_gpr_variants_match_jax(case, route):
    kern, mean, D, P = {"linear_mean": ("RBF", "linear", 1, 1), "ard_d3": ("Matern32", None, 3, 1),
                        "cosine": ("Cosine", None, 1, 1), "exponential": ("Exponential", None, 1, 1),
                        "wide_y": ("RBF", None, 1, 11)}[case]
    grad_rtol = NONSMOOTH_RTOL if kern == "Exponential" else GRAD_RTOL
    jm, tm = _pair(kern, mean=mean, D=D, P=P)
    jloss, jgrads = jax.value_and_grad(lambda m: m.objective())(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=VALUE_RTOL)
    want = dict(jax_parameters(jgrads))
    for n, p in gft.params.parameters(tm):
        np.testing.assert_allclose(
            p.unconstrained.grad.numpy(), np.asarray(want[n].unconstrained), rtol=grad_rtol, err_msg=n)


def test_log_posterior_and_prior_match_jax():
    jm, tm = _pair("RBF", prior=True)
    np.testing.assert_allclose(tm.log_prior().item(), float(jm.log_prior()), rtol=1e-12)
    np.testing.assert_allclose(tm.log_posterior().item(), float(jm.log_posterior()), rtol=VALUE_RTOL)
    np.testing.assert_allclose(tm.log_posterior().item(), -tm.objective().item(), rtol=1e-15)


def test_fit_matches_jax_adam():
    jm, tm = _pair("RBF", N=40)
    jm2, jlosses = gfs.training.fit(jm, num_steps=5, learning_rate=0.01)
    tm2, losses = gft.training.fit(tm, num_steps=5, learning_rate=0.01)
    assert tm2 is tm and losses.shape == (5,)
    # the same Adam arithmetic in f64; optax and torch round differently
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8)
    got = {n: p.unconstrained.detach().numpy() for n, p in gft.params.parameters(tm2)}
    for n, want in _unconstrained(jm2).items():
        np.testing.assert_allclose(got[n], want, rtol=1e-8, err_msg=n)


def test_fit_skips_untrainable_params():
    _, tm = _pair("RBF", N=30)
    tm.likelihood.variance.trainable = False
    assert not tm.likelihood.variance.unconstrained.requires_grad
    before = float(tm.likelihood.variance.value)
    _, losses = gft.training.fit(tm, num_steps=3, learning_rate=0.05)
    assert float(tm.likelihood.variance.value) == before
    assert losses[-1] < losses[0]


def test_parameter_names_match_jax():
    jm, tm = _pair("RBF", mean="linear")
    assert [n for n, _ in gft.params.parameters(tm)] == [n for n, _ in jax_parameters(jm)]


def test_interop_round_trip_and_mismatch():
    _, tm = _pair("Matern52", mean="linear", D=3)
    arrays = {n: p.unconstrained.detach().numpy().copy() for n, p in gft.params.parameters(tm)}
    fresh = gft.models.GPR(*_data(60, 3), kern=gft.kernels.Matern52(3, ARD=True),
                           mean_function=gft.mean_functions.Linear(np.zeros((3, 1))),
                           device="cpu", dtype=torch.float64)
    gft.interop.load_unconstrained(fresh, arrays)
    for n, p in gft.params.parameters(fresh):
        assert np.array_equal(p.unconstrained.detach().numpy(), arrays[n]), n
    assert fresh.objective().item() == tm.objective().item()
    with pytest.raises(KeyError, match="kern.variance"):
        gft.interop.load_unconstrained(fresh, {k: v for k, v in arrays.items() if k != "kern.variance"})
    bad = dict(arrays, **{"kern.lengthscales": np.zeros(2)})
    with pytest.raises(ValueError, match="kern.lengthscales"):
        gft.interop.load_unconstrained(fresh, bad)


def test_model_placement_and_checks():
    X, Y = _data(20)
    m32 = gft.models.GPR(X.astype(np.float32), Y.astype(np.float32), kern=gft.kernels.RBF(1),
                         device="cpu")
    assert m32.X.dtype == torch.float32
    assert all(p.dtype == torch.float32 for _, p in gft.params.parameters(m32))
    assert "X" in dict(m32.named_buffers()) and "X" not in dict(m32.named_parameters())
    m64 = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1), device="cpu")
    assert m64.X.dtype == torch.float64 and m64.X.device.type == "cpu"
    with pytest.raises(ValueError, match="rank-2"):
        gft.models.GPR(X[:, 0], Y, kern=gft.kernels.RBF(1), device="cpu")
    with pytest.raises(ValueError, match="agree on N"):
        gft.models.GPR(X, Y[:10], kern=gft.kernels.RBF(1), device="cpu")


def test_config_settings():
    s = gft.config.settings()
    assert (s.jitter, s.jitter_f32, s.positive_minimum, s.num_gauss_hermite_points) == (
        1e-6, 1e-4, 1e-6, 20)
    assert s.use_kernels
    with gft.config.temp_settings(use_kernels=False, jitter=1e-5) as t:
        assert not gft.config.settings().use_kernels and t.jitter == 1e-5
        assert gft.config.default_jitter(torch.float64) == 1e-5
    assert gft.config.settings() is s
    assert gft.config.default_jitter(torch.float64) == 1e-6
    assert gft.config.default_jitter(torch.float32) == 1e-4


@pytest.mark.parametrize("name", ["Identity", "Exp", "Log1pe", "Logistic", "Chain"])
def test_transforms_match_jax(name):
    def make(mod):
        if name == "Logistic":
            return mod.Logistic(-1.0, 3.0)
        if name == "Chain":
            return mod.Chain(mod.Exp(), mod.Log1pe())
        return getattr(mod, name)()

    jt, tt = make(gfs.transforms), make(gft.transforms)
    x = np.linspace(-30, 30, 41)  # both tails of softplus
    np.testing.assert_allclose(tt.forward(torch.tensor(x)).numpy(), np.asarray(jt.forward(x)),
                               rtol=1e-13)
    # a sum over +-30 that cancels to O(1e-5) for Exp: an absolute floor
    np.testing.assert_allclose(float(tt.log_jacobian(torch.tensor(x))), float(jt.log_jacobian(x)),
                               rtol=1e-13, atol=1e-12)
    y = np.asarray(jt.forward(np.linspace(-5, 5, 11)))
    np.testing.assert_allclose(tt.backward(torch.tensor(y)).numpy(), np.asarray(jt.backward(y)),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,args", [
    ("Gaussian", (0.3, 2.0)), ("LogNormal", (0.1, 0.5)), ("Gamma", (2.0, 1.5)),
    ("Laplace", (0.2, 0.7)), ("Beta", (2.0, 3.0)), ("Uniform", (0.0, 4.0)),
])
def test_priors_match_jax(name, args):
    x = np.linspace(0.05, 0.95, 7)
    want = np.asarray(getattr(gfs.priors, name)(*args).logp(x))
    got = getattr(gft.priors, name)(*args).logp(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_param_prior_logp_adds_jacobian_only_with_prior():
    p = gft.Param(0.5, transform=gft.transforms.positive())
    assert p.prior_logp().item() == 0.0
    p.prior = gft.priors.Gamma(2.0, 1.0)
    jp = gfs.Param(0.5, transform=gfs.transforms.positive(), prior=gfs.priors.Gamma(2.0, 1.0))
    np.testing.assert_allclose(p.prior_logp().item(), float(jp.prior_logp()), rtol=1e-13)
    np.testing.assert_allclose(p.value.item(), 0.5, rtol=1e-14)


def test_gaussian_likelihood_matches_jax():
    rng = np.random.RandomState(3)
    F, Fv, Y = rng.randn(5, 2), rng.uniform(0.1, 1, (5, 2)), rng.randn(5, 2)
    jl, tl = gfs.likelihoods.Gaussian(variance=0.4), gft.likelihoods.Gaussian(variance=0.4)
    T = lambda a: torch.tensor(a)  # noqa: E731
    pairs = [
        (tl.logp(T(F), T(Y)), jl.logp(F, Y)),
        (tl.predict_density(T(F), T(Fv), T(Y)), jl.predict_density(F, Fv, Y)),
        (tl.variational_expectations(T(F), T(Fv), T(Y)), jl.variational_expectations(F, Fv, Y)),
        (tl.predict_mean_and_var(T(F), T(Fv))[1], jl.predict_mean_and_var(F, Fv)[1]),
        (tl.conditional_variance(T(F)), jl.conditional_variance(F)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12)


def test_mean_functions_match_jax():
    X = np.random.RandomState(4).randn(6, 2)
    cases = [
        (gfs.mean_functions.Zero(2), gft.mean_functions.Zero(2)),
        (gfs.mean_functions.Constant([0.5, -1.0]), gft.mean_functions.Constant([0.5, -1.0])),
        (gfs.mean_functions.Linear(np.ones((2, 3)), np.arange(3.0)),
         gft.mean_functions.Linear(np.ones((2, 3)), np.arange(3.0))),
    ]
    for jmf, tmf in cases:
        np.testing.assert_allclose(tmf(torch.tensor(X)).detach().numpy(), np.asarray(jmf(X)),
                                   rtol=1e-14)


def test_kernel_K_and_Kdiag_match_jax():
    X = np.random.RandomState(5).uniform(0, 1, (25, 3))
    for name in ["RBF", "Matern12", "Matern32", "Matern52", "Exponential", "Cosine"]:
        jk = getattr(gfs.kernels, name)(2, variance=0.8, lengthscales=[0.3, 0.5], active_dims=[0, 2])
        tk = getattr(gft.kernels, name)(2, variance=0.8, lengthscales=[0.3, 0.5], active_dims=[0, 2])
        atol = NONSMOOTH_ATOL if name in ("Matern12", "Exponential") else 1e-12
        np.testing.assert_allclose(tk.K(torch.tensor(X)).detach().numpy(), np.asarray(jk.K(X)),
                                   rtol=1e-12, atol=atol, err_msg=name)
        np.testing.assert_allclose(tk.Kdiag(torch.tensor(X)).detach().numpy(),
                                   np.asarray(jk.Kdiag(X)), rtol=1e-14)
    # distances of the lengthscale-scaled inputs, with and without X2
    X2 = X[:7, :2] + 0.1
    Xa = X[:, [0, 2]]
    tk, jk = gft.kernels.RBF(2, lengthscales=[0.3, 0.5]), gfs.kernels.RBF(2, lengthscales=[0.3, 0.5])
    for a, b in ((Xa, None), (Xa, X2)):
        tb = None if b is None else torch.tensor(b)
        np.testing.assert_allclose(tk.square_dist(torch.tensor(a), tb).detach().numpy(),
                                   np.asarray(jk.square_dist(a, b)), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tk.euclid_dist(torch.tensor(a), tb).detach().numpy(),
                                   np.asarray(jk.euclid_dist(a, b)), rtol=1e-12, atol=NONSMOOTH_ATOL)
