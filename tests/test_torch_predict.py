"""Parity of the port's exact-GPR serving path (gpflow_slim_tpu_torch) with
the JAX package, on the CPU in float64: ``GPR.posterior()`` and its
``predict_*``, the uncached ``build_predict`` and the predictive API of
``GPModel``, with their gradients.

Both models are built from the same numpy arrays at the same unconstrained
point (``test_torch_gpr._pair``). Every case runs on both of the port's
routes (the ``route`` fixture): the plain composite, and the kernel route
that CUDA float32 tensors take (lower-tile Gram, padded factor-only
Cholesky, cross Gram, wide TRSM), here through the kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import _pair, route  # noqa: F401  (route is a fixture)

import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.params import parameters as jax_parameters

torch.set_num_threads(2)

ATOL = 1e-10  # tests/test_posterior.py's tolerance for the same predictions
CASES = {  # kernel, mean function, D, columns of Y
    "rbf": ("RBF", None, 1, 1),
    "matern52": ("Matern52", None, 1, 1),
    "linear_mean": ("RBF", "linear", 1, 1),
    "ard_d3": ("Matern32", None, 3, 1),
    "two_column_y": ("RBF", None, 1, 2),
}


def _xnew(D, n=13, seed=11):
    return np.random.RandomState(seed).uniform(-0.1, 1.1, (n, D))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_predictions_match_jax(case, route):
    kern, mean, D, P = CASES[case]
    jm, tm = _pair(kern, mean=mean, D=D, P=P)
    Xt = _xnew(D)
    Yt = np.random.RandomState(12).randn(len(Xt), P)
    with torch.no_grad():
        post = tm.posterior()
        jpost = jm.posterior()
        for got, want in [
            (tm.predict_f(Xt), jm.predict_f(Xt)),
            (tm.predict_f_full_cov(Xt), jm.predict_f_full_cov(Xt)),
            (tm.predict_y(Xt), jm.predict_y(Xt)),
            (post.predict_f(Xt), jpost.predict_f(Xt)),
            (post.predict_f(Xt, full_cov=True), jpost.predict_f(Xt, full_cov=True)),
            (post.predict_y(Xt), jpost.predict_y(Xt)),
            (tm.build_predict(Xt, full_cov=True), jm.build_predict(Xt, full_cov=True)),
        ]:
            for g, w in zip(got, want):
                assert g.shape == np.shape(w)
                _close(g, w)
        _close(tm.predict_density(Xt, Yt), jm.predict_density(Xt, Yt))
        _close(post.predict_density(Xt, Yt), jpost.predict_density(Xt, Yt))
        # the cached factors themselves
        _close(post.L, jpost.L)
        _close(post.alpha, jpost.alpha)
        assert post.predict_f(Xt, full_cov=True)[1].shape == (P, len(Xt), len(Xt))


@pytest.mark.parametrize("case", ["rbf", "linear_mean"])
def test_prediction_gradients_match_jax(case, route):
    # the backwards of the serving path (Gram VJPs, Cholesky VJP, TRSM VJP,
    # and the noise added to the diagonal in place) against JAX's autodiff
    kern, mean, D, P = CASES[case]
    jm, tm = _pair(kern, mean=mean, D=D, P=P)
    Xt = _xnew(D)

    def jloss(m):
        post = m.posterior()
        mu, var = post.predict_f(Xt)
        mu2, var2 = m.predict_f(Xt)
        return jnp.sum(mu) + jnp.sum(var) + jnp.sum(jnp.sin(mu2)) + jnp.sum(var2 ** 2)

    jgrads = dict(jax_parameters(jax.grad(jloss)(jm)))
    mu, var = tm.posterior().predict_f(Xt)
    mu2, var2 = tm.predict_f(Xt)
    (mu.sum() + var.sum() + torch.sin(mu2).sum() + (var2 ** 2).sum()).backward()
    for n, p in gft.params.parameters(tm):
        np.testing.assert_allclose(p.unconstrained.grad.numpy(), np.asarray(jgrads[n].unconstrained),
                                   rtol=1e-8, atol=1e-10, err_msg=n)


def test_predict_f_samples_moments(route):
    # tests/test_gpr.py::test_predict_f_samples_moments on the port, with a
    # seeded torch.Generator in place of the JAX key
    jm, tm = _pair("RBF", N=30)
    Xt = np.linspace(0, 1, 9)[:, None]
    with torch.no_grad():
        samples = tm.predict_f_samples(Xt, 4000, generator=torch.Generator().manual_seed(0))
        again = tm.predict_f_samples(Xt, 4000, generator=torch.Generator().manual_seed(0))
        fmean, fvar = tm.predict_f(Xt)
    assert samples.shape == (4000, 9, 1)
    np.testing.assert_allclose(samples.mean(0).numpy(), fmean.numpy(), atol=0.1)
    np.testing.assert_allclose(samples.var(0).numpy(), fvar.numpy(), atol=0.1)
    assert torch.equal(samples, again)  # the same seed gives the same samples
    _close(fmean, jm.predict_f(Xt)[0])


def test_model_aliases_and_stub():
    jm, tm = _pair("RBF", prior=True)
    np.testing.assert_allclose(tm.compute_log_likelihood().item(), float(jm.compute_log_likelihood()),
                               rtol=1e-10)
    np.testing.assert_allclose(tm.compute_log_prior().item(), float(jm.compute_log_prior()),
                               rtol=1e-12)
    bare = gft.models.GPModel(np.zeros((3, 1)), np.zeros((3, 1)), gft.kernels.RBF(1),
                              gft.likelihoods.Gaussian(), device="cpu")
    with pytest.raises(NotImplementedError):
        bare.predict_f(np.zeros((2, 1)))


def test_posterior_is_a_module_with_buffers():
    _, tm = _pair("RBF", N=20)
    with torch.no_grad():
        post = tm.posterior()
    assert isinstance(post, gft.models.GPRPosterior)
    assert {"X", "L", "alpha"} <= dict(post.named_buffers()).keys()
    assert post.L.shape == (20, 20) and post.alpha.shape == (20, 1)
