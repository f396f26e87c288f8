"""Parity of the port's latent-variable slice with the JAX package, on the
CPU in float64: ``pca_reduce`` (up to sign), ``GPLVM`` and
``BayesianGPLVM`` (objective, every gradient, predictions, on both of the
port's routes), the psi-statistics (the RBF closed forms with diagonal and
full input covariances, the Gauss-Hermite quadrature of any other kernel),
``uncertain_conditional``, ``features.Multiscale``'s Kuu/Kuf and
``densities.multivariate_normal``, at 1e-10 (gradients 1e-8); and the JAX
package's own cases (tests/test_gplvm.py, tests/test_uncertain_conditional.py)
on the port where they apply. Both packages take the same numpy arrays, and
the port loads the JAX model's unconstrained values through
``interop.load_unconstrained``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import route  # noqa: F401  (a fixture)

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu import conditionals as jcond
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu_torch import conditionals as tcond

torch.set_num_threads(2)

ATOL = 1e-10
GRAD_RTOL = 1e-8

# the JAX references, each compiled once for a model's structure (eager
# dispatch compiles every primitive at every new shape: 4-5x slower here)
_jax_value_and_grad = jax.jit(jax.value_and_grad(lambda m: m.objective()))
_jax_predict = jax.jit(lambda m, x, full_cov: m.build_predict(x, full_cov=full_cov), static_argnames="full_cov")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _make_Y(N=20, P=5, Q=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, Q)
    W = rng.randn(Q, P)
    return X, X @ W + 0.05 * rng.randn(N, P), rng


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


def _value_and_grads_match(jm, tm, rtol=1e-10, grad_rtol=GRAD_RTOL):
    jloss, jg = _jax_value_and_grad(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol)
    want = gft.interop.port_arrays(tm, _unconstrained(jg))  # raises unless the names are the same
    for n, t in gft.params.trainable_leaves(tm):
        np.testing.assert_allclose(t.grad.numpy(), want[n], rtol=grad_rtol, atol=1e-10, err_msg=n)


def test_pca_reduce_matches_jax():
    _, Y, _ = _make_Y()
    got = gft.models.pca_reduce(Y, 2)
    want = gfs.models.pca_reduce(Y, 2)
    assert got.shape == (20, 2)
    v = got.var(axis=0)
    assert v[0] >= v[1]
    for q in range(2):  # up to the sign of each component
        s = np.sign(got[:, q] @ want[:, q])
        np.testing.assert_allclose(s * got[:, q], want[:, q], atol=ATOL)
    with pytest.raises(ValueError):
        gft.models.pca_reduce(Y, 6)


def _gplvm_pair(kern_name="rbf_ard", X_mean=None):
    _, Y, _ = _make_Y()
    jk = gfs.kernels.RBF(2, variance=1.3, lengthscales=[0.8, 1.1], ARD=True) if kern_name == "rbf_ard" \
        else gfs.kernels.Matern52(2, variance=1.3, lengthscales=0.9)
    tk = gft.kernels.RBF(2, variance=1.3, lengthscales=[0.8, 1.1], ARD=True) if kern_name == "rbf_ard" \
        else gft.kernels.Matern52(2, variance=1.3, lengthscales=0.9)
    jm = gfs.models.GPLVM(Y, 2, X_mean=X_mean, kern=jk)
    tm = gft.models.GPLVM(Y, 2, X_mean=X_mean, kern=tk, device="cpu")
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    return jm, tm


@pytest.mark.parametrize("kern_name", ["rbf_ard", "matern52"])
def test_gplvm_objective_grads_and_predictions_match_jax(kern_name, route):
    jm, tm = _gplvm_pair(kern_name)
    _value_and_grads_match(jm, tm)
    assert np.any(tm.X.unconstrained.grad.numpy() != 0.0)
    Xnew = np.random.RandomState(3).randn(7, 2)
    jmu, jv = _jax_predict(jm, jnp.asarray(Xnew), full_cov=False)
    with torch.no_grad():
        mu, v = tm.predict_f(Xnew)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)
    jmu, jv = _jax_predict(jm, jnp.asarray(Xnew), full_cov=True)
    with torch.no_grad():
        mu, v = tm.predict_f_full_cov(Xnew)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)


def test_gplvm_matches_gpr_at_same_inputs():
    # tests/test_gplvm.py's identity on the port
    X, Y, _ = _make_Y()
    m_lvm = gft.models.GPLVM(Y, 2, X_mean=X, kern=gft.kernels.RBF(2, variance=1.3, lengthscales=0.8), device="cpu")
    m_gpr = gft.models.GPR(X, Y, kern=gft.kernels.RBF(2, variance=1.3, lengthscales=0.8), device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(m_lvm.build_likelihood().item(), m_gpr.build_likelihood().item(), rtol=1e-10)
        Xnew = np.random.RandomState(1).randn(7, 2)
        for a, b in zip(m_lvm.predict_f(Xnew), m_gpr.predict_f(Xnew)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10)


def test_gplvm_trains():
    _, Y, _ = _make_Y(N=15)
    m = gft.models.GPLVM(Y, 2, device="cpu")
    _, losses = gft.training.fit(m, num_steps=30, learning_rate=1e-2)
    assert float(losses[-1]) < float(losses[0])


def _bgplvm_pair(kern_name, N=14, P=3, M=5, Z=None):
    X, Y, rng = _make_Y(N=N, P=P)
    Xvar = 0.05 + 0.1 * rng.rand(*X.shape)
    mk = {"rbf": lambda k: k.RBF(2, variance=1.2, lengthscales=[0.9, 1.3], ARD=True),
          "matern32": lambda k: k.Matern32(2, variance=1.1, lengthscales=1.2)}[kern_name]
    jm = gfs.models.BayesianGPLVM(X, Xvar, Y, mk(gfs.kernels), M=M, Z=Z)
    tm = gft.models.BayesianGPLVM(X, Xvar, Y, mk(gft.kernels), M=M, Z=Z, device="cpu")
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    return jm, tm


@pytest.mark.parametrize("kern_name", ["rbf", "matern32"])
def test_bgplvm_objective_grads_and_predictions_match_jax(kern_name, route):
    jm, tm = _bgplvm_pair(kern_name)
    _value_and_grads_match(jm, tm)
    Xnew = np.random.RandomState(5).randn(4, 2)
    for full_cov in (False, True):
        jmu, jv = _jax_predict(jm, jnp.asarray(Xnew), full_cov=full_cov)
        with torch.no_grad():
            mu, v = tm.build_predict(Xnew, full_cov=full_cov)
        assert tuple(v.shape) == ((3, 4, 4) if full_cov else (4, 3))
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)


def test_bgplvm_reduces_to_sgpr_as_xvar_vanishes():
    X, Y, _ = _make_Y(N=18)
    Z = X[:6].copy()
    m = gft.models.BayesianGPLVM(X, np.full_like(X, 1e-5), Y, gft.kernels.RBF(2, variance=1.2, lengthscales=0.9),
                                 Z=Z, device="cpu")
    sgpr = gft.models.SGPR(X, Y, kern=gft.kernels.RBF(2, variance=1.2, lengthscales=0.9), Z=Z, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose((m.build_likelihood() + m.kl_latents()).item(), sgpr.build_likelihood().item(),
                                   rtol=1e-3)


def test_bgplvm_trains():
    jm, tm = _bgplvm_pair("rbf", M=6)
    _, losses = gft.training.fit(tm, num_steps=30, learning_rate=1e-2)
    assert float(losses[-1]) < float(losses[0])


# -- psi-statistics, uncertain_conditional, Multiscale, multivariate_normal --

def _psi_inputs(full, N=5, M=6, D=2, seed=0):
    rng = np.random.RandomState(seed)
    Z, Xmu = rng.randn(M, D), 0.5 * rng.randn(N, D)
    if full:
        A = 0.2 * rng.randn(N, D, D)
        Xvar = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(D)
    else:
        Xvar = 0.05 + 0.15 * rng.rand(N, D)
    return Z, Xmu, Xvar


@pytest.mark.parametrize("full", [False, True])
def test_rbf_psi_stats_match_jax(full):
    Z, Xmu, Xvar = _psi_inputs(full)
    jk = gfs.kernels.RBF(2, variance=1.2, lengthscales=[0.8, 1.1], ARD=True)
    tk = gft.kernels.RBF(2, variance=1.2, lengthscales=[0.8, 1.1], ARD=True)
    want = jax.jit(jcond._rbf_psi_stats)(jk, jnp.asarray(Z), jnp.asarray(Xmu), jnp.asarray(Xvar))
    got = tcond._rbf_psi_stats(tk, _t(Z), _t(Xmu), _t(Xvar))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL, rtol=1e-10)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("kern_name", ["matern32", "rbf"])
def test_quadrature_psi_stats_match_jax(kern_name, full):
    Z, Xmu, Xvar = _psi_inputs(full, N=3, M=4)
    mk = {"matern32": lambda k: k.Matern32(2, variance=1.1, lengthscales=1.2),
          "rbf": lambda k: k.RBF(2, variance=1.2, lengthscales=0.9)}[kern_name]
    want = jax.jit(jcond._quadrature_psi_stats, static_argnames="H")(mk(gfs.kernels), jnp.asarray(Z),
                                                                     jnp.asarray(Xmu), jnp.asarray(Xvar), H=12)
    got = tcond._quadrature_psi_stats(mk(gft.kernels), _t(Z), _t(Xmu), _t(Xvar), H=12)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL, rtol=1e-10)
    if kern_name == "rbf":  # the quadrature reaches the closed form
        exact = tcond._rbf_psi_stats(mk(gft.kernels), _t(Z), _t(Xmu), _t(Xvar))
        got = tcond._quadrature_psi_stats(mk(gft.kernels), _t(Z), _t(Xmu), _t(Xvar), H=30)
        for g, w in zip(got, exact):
            np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=1e-6)


def test_default_psi_gh_points_match_jax():
    for D in (1, 2, 3, 5, 11):
        assert tcond._default_psi_gh_points(D) == jcond._default_psi_gh_points(D)
    with pytest.raises(NotImplementedError):
        tcond._default_psi_gh_points(12)


def _q(M, P, q_diag, rng):
    q_mu = 0.5 * rng.randn(M, P)
    if q_diag:
        return q_mu, 0.2 + 0.3 * rng.rand(M, P)
    return q_mu, np.tril(0.1 * rng.randn(P, M, M)) + 0.3 * np.eye(M)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("case", ["rbf_diag", "rbf_full", "rbf_qdiag", "matern32_diag", "matern32_full"])
def test_uncertain_conditional_matches_jax(case, white):
    kern_name, cov = case.split("_")
    Z, Xmu, Xvar = _psi_inputs(cov == "full", N=4, M=5)
    rng = np.random.RandomState(9)
    q_mu, q_sqrt = _q(5, 2, cov == "qdiag", rng)
    mk = {"matern32": lambda k: k.Matern32(2, variance=1.1, lengthscales=1.2),
          "rbf": lambda k: k.RBF(2, variance=1.2, lengthscales=0.9)}[kern_name]
    kw = dict(white=white, num_gauss_hermite_points=10 if kern_name == "matern32" else None)
    jm, jv = jax.jit(functools.partial(jcond.uncertain_conditional, **kw))(
        jnp.asarray(Xmu), jnp.asarray(Xvar), gfs.features.InducingPoints(Z), mk(gfs.kernels), jnp.asarray(q_mu),
        jnp.asarray(q_sqrt))
    with torch.no_grad():
        tm, tv = tcond.uncertain_conditional(_t(Xmu), _t(Xvar), gft.features.InducingPoints(Z), mk(gft.kernels),
                                             _t(q_mu), _t(q_sqrt), **kw)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=1e-10)


def test_uncertain_conditional_zero_variance_reduces_to_conditional():
    # tests/test_uncertain_conditional.py's identity on the port
    Z, Xmu, _ = _psi_inputs(False, N=4, M=6)
    rng = np.random.RandomState(2)
    q_mu, q_sqrt = _q(6, 2, False, rng)
    kern = gft.kernels.RBF(2, variance=1.2, lengthscales=0.9)
    feat = gft.features.InducingPoints(Z)
    with torch.no_grad():
        m1, v1 = tcond.uncertain_conditional(_t(Xmu), torch.full((4, 2), 1e-12, dtype=torch.float64), feat, kern,
                                             _t(q_mu), _t(q_sqrt))
        m2, v2 = tcond.feature_conditional(_t(Xmu), feat, kern, _t(q_mu), q_sqrt=_t(q_sqrt))
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=1e-5)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-4)


def test_uncertain_conditional_rejects_what_jax_rejects():
    Z, Xmu, Xvar = _psi_inputs(False, N=2, M=3)
    kern = gft.kernels.RBF(2)
    q_mu, q_sqrt = _t(np.zeros((3, 1))), _t(np.ones((3, 1)))
    with pytest.raises(NotImplementedError):
        tcond.uncertain_conditional(_t(Xmu), _t(Xvar), gft.features.InducingPoints(Z), kern, q_mu, q_sqrt,
                                    mean_function=gft.mean_functions.Zero())


def test_multiscale_kuu_kuf_match_jax():
    rng = np.random.RandomState(4)
    Z, X, scales = rng.randn(5, 2), rng.randn(7, 2), 0.2 + rng.rand(5, 2)
    jf, tf = gfs.features.Multiscale(Z, scales), gft.features.Multiscale(Z, scales)
    jk = gfs.kernels.RBF(2, variance=1.3, lengthscales=[0.7, 1.2], ARD=True)
    tk = gft.kernels.RBF(2, variance=1.3, lengthscales=[0.7, 1.2], ARD=True)
    np.testing.assert_allclose(tf.Kuu(tk, jitter=1e-6).detach().numpy(), np.asarray(jf.Kuu(jk, jitter=1e-6)),
                               atol=ATOL, rtol=1e-10)
    np.testing.assert_allclose(gft.features.Kuf(tf, tk, _t(X)).detach().numpy(),
                               np.asarray(gfs.features.Kuf(jf, jk, jnp.asarray(X))), atol=ATOL, rtol=1e-10)
    with pytest.raises(NotImplementedError):
        tf.Kuu(gft.kernels.Matern32(2))
    # an SGPR on multiscale features: objective and gradients, scales included
    Y = np.sin(X[:, :1])
    jm = gfs.models.SGPR(X, Y, kern=jk, feat=jf)
    tm = gft.models.SGPR(X, Y, kern=tk, feat=tf, device="cpu")
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    _value_and_grads_match(jm, tm)


@pytest.mark.parametrize("P", [None, 3])
def test_multivariate_normal_matches_jax(P):
    from gpflow_slim_tpu import densities as jd

    rng = np.random.RandomState(6)
    A = rng.randn(8, 8)
    L = np.linalg.cholesky(A @ A.T + 8 * np.eye(8))
    shape = (8,) if P is None else (8, P)
    x, mu = rng.randn(*shape), rng.randn(*shape)
    want = jd.multivariate_normal(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(L))
    got = gft.densities.multivariate_normal(_t(x), _t(mu), _t(L))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
