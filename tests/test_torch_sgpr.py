"""Parity of the port's sparse regression slice (gpflow_slim_tpu_torch) with
the JAX package, on the CPU in float64: SGPR (objective, every gradient,
``compute_upper_bound``, predictions diagonal and full-covariance,
``posterior()``), GPRFITC (objective, gradients, predictions), a GPR on
BASELINE config #2's composite kernel (Matern32 + Periodic), Adam training,
``SVGP.posterior()``, and, on the port alone, the classic identities
(SGPR and FITC with Z = X are GPR; ELBO <= log Z <= upper bound), the
padded exact-GPR route of a kernel without a fused map (``pad_system`` and
``chol_logdet_quad``) and ``robust_cholesky``.

Both models are built from the same numpy arrays, and the port loads the
JAX model's unconstrained values (list-index names included) through
``interop.load_unconstrained``. Model cases run on both of the port's
routes (the ``route`` fixture): the plain composite, and the kernel route
that CUDA float32 tensors take (cross Gram, padded factor-only Cholesky,
wide TRSM, the padded fused factor/solve/logdet), here through the
kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import GRAD_RTOL, VALUE_RTOL, route  # noqa: F401  (route is a fixture)
from test_torch_svgp import _svgp_pair

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.ops import linalg as jax_linalg
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu_torch.ops import cholesky as port_cholesky
from gpflow_slim_tpu_torch.ops import linalg as port_linalg

torch.set_num_threads(2)

ATOL = 1e-10  # predictions: tests/test_posterior.py's tolerance
# the identities: SGPR and FITC with Z = X equal GPR up to the jitter's
# effect (tests/test_models.py's 1e-4)
IDENTITY_ATOL = 1e-4


def _data(N=40, D=1, P=1, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0, 1, (N, D))
    Y = np.sin(12 * X[:, :1]) + 0.3 * np.sin(40 * X[:, :1]) + 0.1 * rng.randn(N, P)
    return X, Y


def _kern(pkg, name, D=1):
    if name == "config2":  # benchmarks/bench_svgp_nuts.py bench_sgpr's kernel
        return pkg.kernels.Matern32(1, lengthscales=0.2) + pkg.kernels.Periodic(1, period=0.16, lengthscales=0.5)
    if name == "rbf_ard":
        return pkg.kernels.RBF(D, variance=1.3, lengthscales=np.linspace(0.3, 0.5, D), ARD=True)
    return pkg.kernels.RBF(D, variance=1.3, lengthscales=0.3)


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


def _pair(model, kern="config2", N=40, M=9, D=1, P=1, mean=None, Z=None):
    """The same sparse model (``"SGPR"``, ``"GPRFITC"`` or ``"GPR"``) in
    both packages, at the same unconstrained point."""
    X, Y = _data(N, D, P)
    if Z is None:
        Z = np.linspace(0, 1, M)[:, None] + 0.01 * np.random.RandomState(5).randn(M, D)
    means = {None: (None, None)}
    if mean == "linear":
        A, b = 0.3 * np.ones((D, P)), 0.1 * np.ones(P)
        means[mean] = (gfs.mean_functions.Linear(A, b), gft.mean_functions.Linear(A, b))
    jmean, tmean = means[mean]
    kw = {} if model == "GPR" else {"Z": Z}
    jm = getattr(gfs.models, model)(X, Y, kern=_kern(gfs, kern, D), mean_function=jmean, **kw)
    tm = getattr(gft.models, model)(X, Y, kern=_kern(gft, kern, D), mean_function=tmean, device="cpu",
                                    dtype=torch.float64, **kw)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    return jm, tm


def _assert_grads(tm, jgrads, rtol=GRAD_RTOL):
    want = {gft.interop.port_name(n): np.asarray(p.unconstrained) for n, p in jax_parameters(jgrads)}
    assert [n for n, _ in gft.params.parameters(tm)] == list(want)
    for n, p in gft.params.parameters(tm):
        np.testing.assert_allclose(p.unconstrained.grad.numpy(), want[n], rtol=rtol,
                                   atol=rtol * np.abs(want[n]).max(), err_msg=n)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


CASES = {  # model, kernel, D, columns of Y, mean function
    "sgpr_config2": ("SGPR", "config2", 1, 1, None),
    "sgpr_rbf_ard_two_outputs": ("SGPR", "rbf_ard", 2, 2, "linear"),
    "fitc_config2": ("GPRFITC", "config2", 1, 1, None),
    "fitc_rbf_ard_two_outputs": ("GPRFITC", "rbf_ard", 2, 2, "linear"),
    "gpr_config2": ("GPR", "config2", 1, 1, None),
    "gpr_config2_linear_mean": ("GPR", "config2", 1, 1, "linear"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_objective_and_grads_match_jax(case, route):
    model, kern, D, P, mean = CASES[case]
    jm, tm = _pair(model, kern, D=D, P=P, mean=mean)
    jloss, jgrads = jax.value_and_grad(lambda m: m.objective())(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=VALUE_RTOL)
    _assert_grads(tm, jgrads)


@pytest.mark.parametrize("case", [c for c in CASES if not c.startswith("gpr")])
def test_predictions_match_jax(case, route):
    model, kern, D, P, mean = CASES[case]
    jm, tm = _pair(model, kern, D=D, P=P, mean=mean)
    Xt = np.random.RandomState(11).uniform(-0.1, 1.1, (13, D))
    with torch.no_grad():
        for got, want in [(tm.predict_f(Xt), jm.predict_f(Xt)),
                          (tm.predict_f_full_cov(Xt), jm.predict_f_full_cov(Xt)),
                          (tm.predict_y(Xt), jm.predict_y(Xt))]:
            for g, w in zip(got, want):
                assert tuple(g.shape) == tuple(np.shape(w))
                _close(g, w)


@pytest.mark.parametrize("kern", ["config2", "rbf"])
def test_upper_bound_matches_jax(kern, route):
    jm, tm = _pair("SGPR", kern)
    jub, jgrads = jax.value_and_grad(lambda m: m.compute_upper_bound())(jm)
    ub = tm.compute_upper_bound()
    ub.backward()
    np.testing.assert_allclose(ub.item(), float(jub), rtol=VALUE_RTOL)
    _assert_grads(tm, jgrads)


@pytest.mark.parametrize("P", [1, 2])
def test_sgpr_posterior_matches_jax_and_the_model(P, route):
    jm, tm = _pair("SGPR", "config2", P=P)
    Xt = np.random.RandomState(12).uniform(0, 1, (17, 1))
    with torch.no_grad():
        post, jpost = tm.posterior(), jm.posterior()
        assert post.L.device == tm.X.device and post.c.shape == (9, P)
        for full_cov in (False, True):
            got = post.predict_f(Xt, full_cov=full_cov)
            for g, m, w in zip(got, tm.build_predict(Xt, full_cov=full_cov),
                               jpost.predict_f(Xt, full_cov=full_cov)):
                _close(g, w)
                _close(g, m.numpy())
        for g, w in zip(post.predict_y(Xt), jpost.predict_y(Xt)):
            _close(g, w)


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("q_diag", [False, True])
def test_svgp_posterior_matches_jax_and_the_model(whiten, q_diag, route):
    jm, tm, _, _ = _svgp_pair("gaussian", whiten, q_diag)
    Xt = np.random.RandomState(13).uniform(0, 1, (11, 1))
    with torch.no_grad():
        post, jpost = tm.posterior(), jm.posterior()
        assert post.q_sqrt.shape == (2, 8, 8) and post.Luu.device == tm.X.device
        for full_cov in (False, True):
            got = post.predict_f(Xt, full_cov=full_cov)
            for g, m, w in zip(got, tm.build_predict(Xt, full_cov=full_cov),
                               jpost.predict_f(Xt, full_cov=full_cov)):
                _close(g, w)
                _close(g, m.numpy())
        for g, w in zip(post.predict_y(Xt), jpost.predict_y(Xt)):
            _close(g, w)


def test_sgpr_fit_matches_jax_adam():
    jm, tm = _pair("SGPR", "config2", N=30, M=6)
    jm2, jlosses = gfs.training.fit(jm, num_steps=5, learning_rate=0.01)
    _, losses = gft.training.fit(tm, num_steps=5, learning_rate=0.01)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8)
    got = {n: p.unconstrained.detach().numpy() for n, p in gft.params.parameters(tm)}
    for n, want in _unconstrained(jm2).items():
        np.testing.assert_allclose(got[gft.interop.port_name(n)], want, rtol=1e-8, err_msg=n)


def test_sgpr_parameter_names_are_jax_names():
    jm, tm = _pair("SGPR", "config2")
    names = [n for n, _ in jax_parameters(jm)]
    assert names == ["feature.Z", "kern.kernels[0].lengthscales", "kern.kernels[0].variance",
                     "kern.kernels[1].lengthscales", "kern.kernels[1].period", "kern.kernels[1].variance",
                     "likelihood.variance"]
    assert [n for n, _ in gft.params.parameters(tm)] == [gft.interop.port_name(n) for n in names]


# -- the classic identities (tests/test_models.py), on the port ------------

def _identity_kern(kind):
    if kind == "composite":
        return gft.kernels.RBF(2, variance=1.3, lengthscales=0.8) + gft.kernels.Periodic(
            2, period=1.7, lengthscales=0.9)
    return gft.kernels.RBF(2, variance=1.3, lengthscales=0.8)


def _identity_data(N):
    X = np.random.RandomState(0).randn(N, 2)
    return X, np.sin(X[:, :1]) + 0.1 * np.random.RandomState(1).randn(N, 1)


@pytest.mark.parametrize("kern", ["rbf", "composite"])
@pytest.mark.parametrize("model", ["SGPR", "GPRFITC"])
def test_z_equal_x_matches_gpr(model, kern, route):
    X, Y = _identity_data(30)
    kw = dict(device="cpu", dtype=torch.float64)
    gpr = gft.models.GPR(X, Y, kern=_identity_kern(kern), **kw)
    sparse = getattr(gft.models, model)(X, Y, kern=_identity_kern(kern), Z=X.copy(), **kw)
    with torch.no_grad():
        assert abs(gpr.build_likelihood().item() - sparse.build_likelihood().item()) < IDENTITY_ATOL
        Xnew = np.random.RandomState(3).randn(7, 2)
        for a, b in zip(gpr.predict_f(Xnew), sparse.predict_f(Xnew)):
            _close(a, b.numpy(), atol=IDENTITY_ATOL)


@pytest.mark.parametrize("kern", ["rbf", "composite"])
def test_elbo_below_lml_below_upper_bound(kern, route):
    X, Y = _identity_data(40)
    kw = dict(device="cpu", dtype=torch.float64)
    gpr = gft.models.GPR(X, Y, kern=_identity_kern(kern), **kw)
    sgpr = gft.models.SGPR(X, Y, kern=_identity_kern(kern), Z=X[::4].copy(), **kw)
    with torch.no_grad():
        lml, elbo, upper = (gpr.build_likelihood().item(), sgpr.build_likelihood().item(),
                            sgpr.compute_upper_bound().item())
    assert elbo <= lml + 1e-6 and lml <= upper + 1e-6
    assert upper - elbo > 1e-3  # Z = X[::4]: the bounds are not tight


# -- the padded route of a kernel without a fused map ----------------------

@pytest.mark.parametrize("N,P", [(1, 1), (60, 1), (64, 3), (130, 2)])
def test_pad_system_is_exact(N, P):
    rng = np.random.RandomState(N)
    A = rng.randn(N, N)
    K = torch.tensor(A @ A.T / N + np.eye(N))
    D = torch.tensor(rng.randn(N, P))
    Kp, Dp = port_linalg.pad_system(K, D)
    Np = -(-N // port_cholesky.BLOCK) * port_cholesky.BLOCK
    assert Kp.shape == (Np, Np) and Dp.shape == (Np, P)
    assert torch.equal(Kp[:N, :N], K) and torch.equal(Dp[:N], D) and not bool(Dp[N:].any())
    assert torch.equal(Kp[N:, N:], torch.eye(Np - N, dtype=K.dtype)) and not bool(Kp[N:, :N].any())
    Lp, alpha, half_logdet = port_cholesky.cholesky_solve(Kp.clone(), Dp)
    # the padding invariants: pad rows of alpha exactly 0, pad log terms exactly log 1
    assert bool((alpha[N:] == 0).all()) and bool((torch.log(torch.diagonal(Lp)[N:]) == 0).all())
    want = port_linalg.chol_logdet_quad(K, D)  # the plain composite on the unpadded system
    np.testing.assert_allclose(half_logdet.item(), want[0].item(), rtol=1e-13)
    np.testing.assert_allclose(torch.sum(alpha ** 2).item(), want[1].item(), rtol=1e-13)


def test_composite_gpr_takes_the_padded_fused_route(route, monkeypatch):
    # a kernel without a fused map: K_lower(X) + noise I, padded, through the
    # fused factor/solve/logdet (kernel route), never through the operand
    calls = []
    fused = port_cholesky.cholesky_solve_logdet

    def spy(Kp, Dp):
        calls.append((tuple(Kp.shape), tuple(Dp.shape)))
        return fused(Kp, Dp)

    monkeypatch.setattr(port_cholesky, "cholesky_solve_logdet", spy)
    jm, tm = _pair("GPR", "config2", N=70)
    assert getattr(tm.kern, "_gram_kind", None) is None and not hasattr(tm.kern, "gram_chol_operand")
    loss = tm.objective()
    np.testing.assert_allclose(loss.item(), float(jm.objective()), rtol=VALUE_RTOL)
    assert calls == ([((128, 128), (128, 1))] if route == "kernel_route" else [])


# -- robust_cholesky (tests/test_posterior.py) ------------------------------

def _spd_with_min_eig(lam_min, n=20, seed=0):
    Q, _ = np.linalg.qr(np.random.RandomState(seed).randn(n, n))
    lam = np.linspace(1.0, 3.0, n)
    lam[0] = lam_min
    return (Q * lam) @ Q.T


@pytest.mark.parametrize("case", ["singular", "healthy", "escalates", "never"])
def test_robust_cholesky_matches_jax(case, route):
    rng = np.random.RandomState(0)
    if case == "singular":  # rank 5, as tests/test_posterior.py
        A = rng.randn(20, 5)
        K = A @ A.T
    elif case == "healthy":
        A = rng.randn(15, 15)
        K = A @ A.T + 15 * np.eye(15)
    elif case == "escalates":  # needs 1e-3 relative: three escalations
        K = _spd_with_min_eig(-5e-4)
    else:  # no jitter of the five escalations suffices
        K = _spd_with_min_eig(-50.0)
    L, jit = gft.ops.linalg.robust_cholesky(torch.tensor(K))
    jL, jjit = jax_linalg.robust_cholesky(jnp.asarray(K))
    np.testing.assert_allclose(jit.item(), float(jjit), rtol=1e-14)
    scale = np.mean(np.diag(K))
    if case == "never":
        assert not bool(torch.isfinite(L).all()) and not bool(jnp.all(jnp.isfinite(jL)))
        np.testing.assert_allclose(jit.item(), 1e-6 * 1e5 * scale, rtol=1e-12)
        return
    assert bool(torch.isfinite(L).all())
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=0, atol=1e-10)
    resid = np.abs(L.numpy() @ L.numpy().T - K).max()
    assert resid < 10 * jit.item() + 1e-6
    if case == "healthy":
        assert jit.item() == pytest.approx(1e-6 * scale, rel=1e-14)
    if case == "escalates":
        assert jit.item() == pytest.approx(1e-3 * scale, rel=1e-12)
