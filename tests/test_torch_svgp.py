"""Parity of the port's SVGP natural-gradient training path
(gpflow_slim_tpu_torch) with the JAX package, on the CPU in float64:
``gauss_kl``, the SVGP ELBO and its gradients, the predictions, one
``natgrad_step`` (also one that halves gamma and one where every attempt
fails and q is kept), the conjugate one-step oracle, a full-batch
``fit_svgp_natgrad`` trajectory and the interop of a JAX SVGP.

Both models are built from the same numpy arrays; the port loads the JAX
model's unconstrained values (the packed ``q_sqrt`` included) through
``interop.load_unconstrained``. Model cases run on both of the port's
routes (the ``route`` fixture): the plain composite, and the kernel route
that CUDA float32 tensors take (cross Gram, padded factor-only Cholesky,
wide TRSM, batched TRSM), here through the kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import GRAD_RTOL, VALUE_RTOL, route  # noqa: F401  (route is a fixture)

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu.training import natgrad as jax_natgrad
from gpflow_slim_tpu_torch.ops import linalg as port_linalg

torch.set_num_threads(2)

ATOL = 1e-10  # predictions: tests/test_posterior.py's tolerance


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _random_q(M, P, q_diag, rng):
    """A q away from its identity initialisation, as unconstrained values."""
    q_mu = rng.randn(M, P)
    if q_diag:
        return q_mu, np.asarray(gfs.transforms.positive().backward(rng.uniform(0.5, 1.5, (M, P))))
    L = np.tril(0.2 * rng.randn(P, M, M), -1) + np.stack(
        [np.diag(rng.uniform(0.5, 1.5, M)) for _ in range(P)])
    return q_mu, np.asarray(gfs.transforms.LowerTriangular(M, num_matrices=P).backward(L))


def _svgp_pair(lik, whiten, q_diag, N=40, M=8, seed=0):
    """The same SVGP in both packages, at the same random unconstrained
    point. Gaussian: two outputs; Bernoulli: one."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0, 1, (N, 1))
    if lik == "gaussian":
        Y = np.sin(6 * X) + 0.1 * rng.randn(N, 2)
    else:
        Y = (np.sin(8 * X) > 0).astype(float)
    Z = np.linspace(0, 1, M)[:, None] + 0.01 * rng.randn(M, 1)

    def make(pkg, **kw):
        like = pkg.likelihoods.Gaussian(variance=0.3) if lik == "gaussian" else pkg.likelihoods.Bernoulli()
        return pkg.models.SVGP(X, Y, kern=pkg.kernels.RBF(1, variance=1.2, lengthscales=0.3),
                               likelihood=like, Z=Z, q_diag=q_diag, whiten=whiten, **kw)

    jm = make(gfs)
    tm = make(gft, device="cpu", dtype=torch.float64)
    arrays = {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}
    arrays["q_mu"], arrays["q_sqrt"] = _random_q(M, Y.shape[1], q_diag, rng)
    jm = gfs.params.unpack_trainable(jm, jnp.concatenate(
        [jnp.ravel(arrays[n]) for n, p in jax_parameters(jm) if p.trainable]))
    gft.interop.load_unconstrained(tm, arrays)
    return jm, tm, X, Y


def _assert_params_close(tm, jm, rtol, what):
    # each array relative to its largest entry: entries near 0 carry no digits
    want = {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}
    for n, p in gft.params.parameters(tm):
        got = (p.unconstrained.grad if what == "grad" else p.unconstrained).detach().numpy()
        np.testing.assert_allclose(got, want[n], rtol=rtol, atol=rtol * np.abs(want[n]).max(),
                                   err_msg=f"{what} {n}")


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("q_diag", [False, True])
@pytest.mark.parametrize("whiten", [True, False])
def test_gauss_kl_matches_jax(whiten, q_diag, P, monkeypatch):
    rng = np.random.RandomState(1)
    M = 9
    q_mu, u = _random_q(M, P, q_diag, rng)
    tr = gfs.transforms.positive() if q_diag else gfs.transforms.LowerTriangular(M, num_matrices=P)
    q_sqrt = np.asarray(tr.forward(u))
    K = None
    if not whiten:
        A = rng.randn(M, M)
        K = A @ A.T + M * np.eye(M)
    want = float(gfs.kullback_leiblers.gauss_kl(q_mu, q_sqrt, K))
    got = gft.kullback_leiblers.gauss_kl(_t(q_mu), _t(q_sqrt), None if K is None else _t(K))
    np.testing.assert_allclose(got.item(), want, rtol=VALUE_RTOL)
    # the kernel route (only the unwhitened full q_sqrt reaches the batched
    # TRSM), through the plain version of the batched kernel
    monkeypatch.setattr(port_linalg, "kernels_active", lambda t: True)
    got = gft.kullback_leiblers.gauss_kl(_t(q_mu), _t(q_sqrt), None if K is None else _t(K))
    np.testing.assert_allclose(got.item(), want, rtol=VALUE_RTOL)


@pytest.mark.parametrize("lik", ["gaussian", "bernoulli"])
@pytest.mark.parametrize("q_diag", [False, True])
@pytest.mark.parametrize("whiten", [True, False])
def test_svgp_elbo_and_grads_match_jax(whiten, q_diag, lik, route):
    jm, tm, _, _ = _svgp_pair(lik, whiten, q_diag)
    jloss, jgrads = jax.value_and_grad(lambda m: m.objective())(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=VALUE_RTOL)
    _assert_params_close(tm, jgrads, GRAD_RTOL, "grad")


@pytest.mark.parametrize("q_diag", [False, True])
@pytest.mark.parametrize("whiten", [True, False])
def test_svgp_predictions_match_jax(whiten, q_diag, route):
    jm, tm, _, _ = _svgp_pair("bernoulli", whiten, q_diag)
    Xt = np.random.RandomState(11).uniform(-0.1, 1.1, (13, 1))
    Yt = (np.random.RandomState(12).rand(13, 1) > 0.5).astype(float)
    with torch.no_grad():
        for got, want in [(tm.predict_f(Xt), jm.predict_f(Xt)),
                          (tm.predict_f_full_cov(Xt), jm.predict_f_full_cov(Xt)),
                          (tm.predict_y(Xt), jm.predict_y(Xt)),
                          ((tm.predict_density(Xt, Yt),), (jm.predict_density(Xt, Yt),))]:
            for g, w in zip(got, want):
                assert g.shape == np.shape(w)
                # the unwhitened mean goes through Kmm^-1 (condition number
                # ~1e6 with the f64 jitter): relative digits as well
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=VALUE_RTOL, atol=ATOL)
        np.testing.assert_allclose(tm.q_sqrt_array().numpy(), np.asarray(jm.q_sqrt_array()), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("white", [False, True])
def test_conditionals_match_jax(white, full_cov, route):
    # conditional (values at X) and feature_conditional (through
    # InducingPoints), with a full q_sqrt over two outputs
    rng = np.random.RandomState(5)
    X, Xnew, f = rng.uniform(0, 1, (9, 1)), rng.uniform(-0.1, 1.1, (7, 1)), rng.randn(9, 2)
    _, u = _random_q(9, 2, False, rng)
    L = np.asarray(gfs.transforms.LowerTriangular(9, num_matrices=2).forward(u))
    # lengthscale 0.1: Kmm of 9 points on [0, 1] stays well conditioned
    jk, tk = gfs.kernels.RBF(1, lengthscales=0.1), gft.kernels.RBF(1, lengthscales=0.1)
    kw = dict(full_cov=full_cov, q_sqrt=L, white=white)
    jf = gfs.features.InducingPoints(X)
    tf = gft.features.InducingPoints(X).to(torch.float64)
    pairs = [(gft.conditionals.conditional(_t(Xnew), _t(X), tk, _t(f), **dict(kw, q_sqrt=_t(L))),
              gfs.conditionals.conditional(Xnew, X, jk, f, **kw)),
             (gft.conditionals.feature_conditional(_t(Xnew), tf, tk, _t(f), **dict(kw, q_sqrt=_t(L))),
              gfs.conditionals.feature_conditional(Xnew, jf, jk, f, **kw))]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.shape == np.shape(w)
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=VALUE_RTOL, atol=ATOL)


@pytest.mark.parametrize("q_diag", [False, True])
@pytest.mark.parametrize("whiten", [True, False])
def test_natgrad_step_matches_jax(whiten, q_diag, route):
    jm, tm, X, Y = _svgp_pair("bernoulli", whiten, q_diag)
    idx = np.random.RandomState(3).permutation(len(X))[:16]
    Xb, Yb = X[idx], Y[idx]
    jm1 = jax_natgrad.natgrad_step(
        jm, lambda mm: -(mm.build_likelihood_batch(jnp.asarray(Xb), jnp.asarray(Yb)) + mm.log_prior()),
        gamma=0.5)
    tm1 = gft.training.natgrad_step(
        tm, lambda mm: -(mm.build_likelihood_batch(Xb, Yb) + mm.log_prior()), gamma=0.5)
    assert tm1 is tm
    _assert_params_close(tm, jm1, 1e-8, "value")


def _counters():
    ng = gft.training.natgrad_step
    return np.array([int(ng.backtracked), int(ng.halvings), int(ng.kept)])


@pytest.mark.parametrize("q_diag", [False, True])
def test_natgrad_step_halves_gamma_as_jax(q_diag, route):
    # a non-conjugate step whose gamma makes the first attempts' precision
    # indefinite: the port takes the first finite attempt of its batched
    # pass, JAX's lax.while_loop halves until one is finite; the same q
    jm, tm, _, _ = _svgp_pair("bernoulli", True, q_diag)
    before = _counters()
    jm1 = jax_natgrad.natgrad_step(jm, lambda mm: -(mm.build_likelihood() + mm.log_prior()), gamma=20.0)
    gft.training.natgrad_step(tm, lambda mm: -(mm.build_likelihood() + mm.log_prior()), gamma=20.0)
    backtracked, halvings, kept = _counters() - before
    assert backtracked == 1 and 0 < halvings < gft.training.natgrad.MAX_HALVINGS and kept == 0
    _assert_params_close(tm, jm1, 1e-8, "value")


def test_natgrad_step_keeps_q_when_every_attempt_fails(route):
    # gamma so large that even gamma / 2^8 gives an indefinite precision:
    # q is kept exactly, in both packages, and `kept` counts the step
    jm, tm, _, _ = _svgp_pair("bernoulli", True, False)
    q0 = {n: p.unconstrained.detach().clone() for n, p in gft.params.parameters(tm)}
    before = _counters()
    jm1 = jax_natgrad.natgrad_step(jm, lambda mm: -(mm.build_likelihood() + mm.log_prior()), gamma=1e3)
    gft.training.natgrad_step(tm, lambda mm: -(mm.build_likelihood() + mm.log_prior()), gamma=1e3)
    assert list(_counters() - before) == [1, gft.training.natgrad.MAX_HALVINGS, 1]
    for n, p in gft.params.parameters(tm):
        assert torch.equal(p.unconstrained, q0[n]), n
    _assert_params_close(tm, jm1, 0.0, "value")
    _assert_params_close(tm, jm, 0.0, "value")


@pytest.mark.parametrize("whiten", [True, False])
def test_one_natgrad_step_solves_conjugate_svgp(whiten, route):
    # tests/test_natgrad.py's oracle on the port: with Z = X and fixed
    # hyperparameters, one gamma = 1 step lands on the optimal q, whose ELBO
    # is the port's own GPR log marginal likelihood (up to the jitter)
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (24, 1))
    Y = np.sin(6 * X) + 0.1 * rng.randn(24, 1)
    m = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.4),
                        likelihood=gft.likelihoods.Gaussian(variance=0.05), Z=X.copy(),
                        whiten=whiten, device="cpu")
    gpr = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.4), device="cpu")
    with torch.no_grad():
        gpr.likelihood.variance.unconstrained.copy_(gft.transforms.positive().backward(_t(0.05)))
        lml = gpr.build_likelihood().item()
        before = m.build_likelihood().item()
    gft.training.natgrad_step(m, lambda mm: -mm.build_likelihood(), gamma=1.0)
    with torch.no_grad():
        after = m.build_likelihood().item()
    assert after > before
    assert abs(after - lml) < 1e-3
    gft.training.natgrad_step(m, lambda mm: -mm.build_likelihood(), gamma=1.0)
    with torch.no_grad():
        assert abs(m.build_likelihood().item() - after) < 1e-6


@pytest.mark.parametrize("whiten", [True, False])
def test_fit_svgp_natgrad_trajectory_matches_jax(whiten):
    # full batch: the minibatch is a permutation of all N points, so the loss
    # does not depend on the two packages' different random numbers
    jm, tm, _, _ = _svgp_pair("bernoulli", whiten, False, N=30, M=6)
    jm2, jlosses = jax_natgrad.fit_svgp_natgrad(jm, 5, jax.random.PRNGKey(0), gamma=0.1,
                                                learning_rate=0.01)
    tm2, losses = gft.training.fit_svgp_natgrad(tm, 5, torch.Generator().manual_seed(0), gamma=0.1,
                                                learning_rate=0.01)
    assert tm2 is tm and losses.shape == (5,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8)
    _assert_params_close(tm, jm2, 1e-8, "value")


def test_fit_svgp_natgrad_with_an_optimizer_matches_jax():
    # the hyperparameters' optimizer given: optax.sgd in the JAX package,
    # torch.optim.SGD in the port (the same update, p -= lr g)
    import optax

    jm, tm, _, _ = _svgp_pair("bernoulli", False, False, N=30, M=6)
    jm2, jlosses = jax_natgrad.fit_svgp_natgrad(jm, 4, jax.random.PRNGKey(0), gamma=0.1,
                                                optimizer=optax.sgd(0.05))
    _, losses = gft.training.fit_svgp_natgrad(tm, 4, torch.Generator().manual_seed(0), gamma=0.1,
                                              optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8)
    _assert_params_close(tm, jm2, 1e-8, "value")


def test_fit_svgp_natgrad_trains_a_deep_kernels_warp_as_jax():
    # the hyperparameters' optimizer takes every trainable leaf that is not
    # q, a DeepKernel's warp too, as the JAX package's mask does
    from gpflow_slim_tpu.kernels_deep import DeepKernel as JDeep
    from gpflow_slim_tpu.kernels_deep import mlp_warp as jmlp

    rng = np.random.RandomState(3)
    X = rng.uniform(-1, 1, (30, 1))
    Y = (np.sin(3 * X) > 0).astype(float)
    Z = np.linspace(-1, 1, 6)[:, None]
    fn, params = jmlp(jax.random.PRNGKey(0), [1, 3, 1])
    jm = gfs.models.SVGP(X, Y, kern=JDeep(1, gfs.kernels.RBF(1, lengthscales=0.5), fn, params),
                         likelihood=gfs.likelihoods.Bernoulli(), Z=Z)
    jm.q_mu = gfs.params.Param(0.3 * rng.randn(6, 1), name="q_mu")  # the warp's gradient is 0 at q's start
    tk = gft.kernels_deep.DeepKernel(1, gft.kernels.RBF(1, lengthscales=0.5), gft.kernels_deep.mlp_warp([1, 3, 1]))
    tm = gft.models.SVGP(X, Y, kern=tk, likelihood=gft.likelihoods.Bernoulli(), Z=Z, device="cpu",
                         dtype=torch.float64)
    gft.interop.load_unconstrained(tm, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)})
    w0 = tm.kern.warp.layers[0].weight.detach().clone()
    jm2, jlosses = jax_natgrad.fit_svgp_natgrad(jm, 5, jax.random.PRNGKey(0), gamma=0.1, learning_rate=0.05)
    _, losses = gft.training.fit_svgp_natgrad(tm, 5, torch.Generator().manual_seed(0), gamma=0.1, learning_rate=0.05)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8)
    assert (tm.kern.warp.layers[0].weight - w0).abs().max() > 1e-3
    want = gft.interop.port_arrays(tm, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm2)})
    for n, t in gft.params.trainable_leaves(tm):
        if n == "kern.warp.layers.1.bias":
            # the RBF cannot see a shift of every warped input: its gradient
            # is rounding in both packages, which Adam divides by its eps
            assert abs(t.item()) < 1e-5 and abs(want[n].item()) < 1e-5
            continue
        np.testing.assert_allclose(t.detach().numpy(), want[n], rtol=1e-7, atol=1e-9, err_msg=n)


def test_interop_of_a_jax_svgp():
    jm, tm, _, _ = _svgp_pair("gaussian", False, False, M=7)
    names = [n for n, _ in gft.params.parameters(tm)]
    assert names == [n for n, _ in jax_parameters(jm)]
    assert names == ["feature.Z", "kern.lengthscales", "kern.variance", "likelihood.variance",
                     "q_mu", "q_sqrt"]
    # the packed q_sqrt: P M (M + 1) / 2 values, np.tril_indices order
    assert tm.q_sqrt.unconstrained.shape == (2 * 7 * 8 // 2,)
    np.testing.assert_array_equal(tm.q_sqrt.value.detach().numpy(), np.asarray(jm.q_sqrt.value))
    np.testing.assert_allclose(tm.objective().item(), float(jm.objective()), rtol=VALUE_RTOL)


def test_svgp_param_sizes_at_the_benchmark_width():
    m = gft.models.SVGP(np.zeros((3, 1)), np.zeros((3, 1)), kern=gft.kernels.RBF(1),
                        likelihood=gft.likelihoods.Bernoulli(), Z=np.linspace(0, 1, 256)[:, None],
                        whiten=False, device="cpu", dtype=torch.float32)
    assert m.q_sqrt.unconstrained.shape == (32896,)  # 256 * 257 / 2
    assert torch.equal(m.q_sqrt_array()[0], torch.eye(256))
    assert all(p.dtype == torch.float32 for _, p in gft.params.parameters(m))


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: device=None places the model there")
    X, Y = np.zeros((3, 1)), np.zeros((3, 1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gft.models.GPR(X, Y, kern=gft.kernels.RBF(1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gft.models.SVGP(X, Y, kern=gft.kernels.RBF(1), likelihood=gft.likelihoods.Bernoulli(), Z=X)
