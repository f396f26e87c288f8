"""Parity of the port's iterative slice (``ops.iterative``, ``models.GPRCG``)
with the JAX package, on the CPU in float64.

The solvers take the same systems and probe vectors in both packages:
batched CG with and without the pivoted-Cholesky/Woodbury preconditioner,
Lanczos, SLQ, the pivoted Cholesky itself and the Woodbury solve, at 1e-10.
GPRCG runs on the JAX package's probe matrices (its threefry draws from
``probe_keys``), put in place of the port's through
``ops.iterative.cg_probes``, the one function the port draws them from:
value and every gradient in both modes at 1e-8, and the predictions. The
port's own probes are held to their contract (the same for the same
parameters, new when one moves), and the JAX package's cases
(tests/test_iterative.py) run on the port where they apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.ops import iterative as jit_
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu_torch.models import cg_gpr
from gpflow_slim_tpu_torch.ops import iterative as it

torch.set_num_threads(2)

ATOL = 1e-10      # the solvers: the same steps on the same inputs
VALUE_RTOL = 1e-8  # GPRCG's value and gradients, on the JAX package's probes
GRAD_RTOL = 1e-8


def _system(N=80, noise=0.3, seed=0, ls=0.3):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0, 1, (N, 1))
    K = np.exp(-0.5 * (X - X.T) ** 2 / ls ** 2) + noise * np.eye(N)
    return K, rng


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("precond", [False, True])
def test_batched_cg_matches_jax(precond):
    # a system on which no column's residual ends a step within rounding of
    # the tolerance: there the two packages could stop it one step apart
    K, rng = _system(noise=1.0, ls=0.05)
    B = rng.randn(len(K), 3)
    jpre = tpre = None
    if precond:
        Kk = K - np.eye(len(K))
        jpre = jit_.woodbury_solve_fn(jit_.pivoted_cholesky(jnp.asarray(Kk), 8), 1.0)
        tpre = it.woodbury_solve_fn(it.pivoted_cholesky(_t(Kk), 8), 1.0)
    jX, jres = jit_.batched_cg(lambda v: jnp.asarray(K) @ v, jnp.asarray(B), max_iters=25, precond=jpre)
    Kt = _t(K)
    tX, tres = it.batched_cg(lambda v: Kt @ v, _t(B), max_iters=25, precond=tpre)
    assert float(tres.max()) < 1e-6  # converged: the masking has run too
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), atol=ATOL, rtol=1e-8)


def test_batched_cg_solves():
    # tests/test_iterative.py's case on the port
    K, rng = _system(N=200)
    B = _t(rng.randn(200, 4))
    Kt = _t(K)
    X, res = it.batched_cg(lambda v: Kt @ v, B, max_iters=300)
    assert float(res.max()) < 1e-6
    np.testing.assert_allclose((Kt @ X).numpy(), B.numpy(), atol=1e-5)


def test_preconditioned_cg_converges_faster():
    K, rng = _system(N=200, noise=0.05)
    Kt, B = _t(K), _t(rng.randn(200, 2))
    pre = it.woodbury_solve_fn(it.pivoted_cholesky(Kt - 0.05 * torch.eye(200, dtype=torch.float64), 40), 0.05)
    _, res_pre = it.batched_cg(lambda v: Kt @ v, B, max_iters=5, precond=pre)
    _, res_plain = it.batched_cg(lambda v: Kt @ v, B, max_iters=5)
    assert float(res_pre.max()) < 1e-8 < float(res_plain.max())


def _jax_probes(key, N, num):
    return np.stack([np.asarray(jax.random.rademacher(k, (N,), dtype=jnp.float64))
                     for k in jax.random.split(key, num)], 1)


def test_lanczos_and_slq_match_jax():
    # 20 steps on a system of more than 20 distinct significant
    # eigenvalues: Lanczos without reorthogonalization amplifies rounding
    # without bound once it has found the spectrum
    K, _ = _system(N=100, ls=0.02)
    Z = _jax_probes(jax.random.PRNGKey(3), 100, 5)
    Kj, Kt = jnp.asarray(K), _t(K)
    alphas, betas = it.lanczos_tridiag(lambda v: Kt @ v, _t(Z), 20)
    for p in range(5):
        ja, jb = jit_.lanczos_tridiag(lambda v: Kj @ v, jnp.asarray(Z[:, p]), 20)
        np.testing.assert_allclose(alphas[:, p].numpy(), np.asarray(ja), atol=ATOL, rtol=0)
        np.testing.assert_allclose(betas[:, p].numpy(), np.asarray(jb), atol=ATOL, rtol=0)
    want = jit_.slq_logdet(lambda v: Kj @ v, 100, jax.random.PRNGKey(3), num_probes=5, num_steps=20,
                           dtype=jnp.float64)
    got = it.slq_logdet(lambda v: Kt @ v, _t(Z), num_steps=20)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12, atol=ATOL)
    # and the estimate is the exact logdet within the Monte-Carlo error
    exact = np.linalg.slogdet(K)[1]
    assert abs(float(got) - exact) / abs(exact) < 0.1


def test_lanczos_quadrature_exact_per_probe():
    K, _ = _system(N=100)
    lam, U = np.linalg.eigh(K)
    logK = U @ np.diag(np.log(lam)) @ U.T
    z = _jax_probes(jax.random.PRNGKey(0), 100, 1)
    Kt = _t(K)
    est = float(it.slq_logdet(lambda v: Kt @ v, _t(z), num_steps=40))
    exact = float(z[:, 0] @ logK @ z[:, 0])
    assert abs(est - exact) / abs(exact) < 1e-6


@pytest.mark.parametrize("case", ["full_rank", "low_rank", "never_repick"])
def test_pivoted_cholesky_matches_jax(case):
    rng = np.random.RandomState(1)
    if case == "full_rank":
        K, rank = _system(N=60)[0], 10
    elif case == "low_rank":
        A = rng.randn(50, 6)
        K, rank = A @ A.T, 6
    else:  # rank 3, requested 8: a chosen pivot must not be picked again
        A = rng.randn(30, 3)
        K, rank = A @ A.T, 8
    L = it.pivoted_cholesky(_t(K), rank)
    # past K's rank the columns are rounding over a 1e-12 pivot: compare
    # the columns up to it
    n = 3 if case == "never_repick" else rank
    np.testing.assert_allclose(L[:, :n].numpy(), np.asarray(jit_.pivoted_cholesky(jnp.asarray(K), rank))[:, :n],
                               atol=ATOL, rtol=0)
    assert bool(torch.isfinite(L).all())
    if case != "full_rank":
        assert float((_t(K) - L @ L.T).abs().max()) < 1e-6
    if case == "never_repick":
        assert float(L[:, 3:].abs().max()) < 1e-3


def test_woodbury_solve_matches_jax():
    rng = np.random.RandomState(2)
    L, v = rng.randn(40, 7), rng.randn(40, 3)
    want = jit_.woodbury_solve_fn(jnp.asarray(L), 0.2)(jnp.asarray(v))
    got = it.woodbury_solve_fn(_t(L), 0.2)(_t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-10)
    exact = np.linalg.solve(L @ L.T + 0.2 * np.eye(40), v)
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-8)


# -- GPRCG -------------------------------------------------------------------

def _data(N=70, D=1, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (N, D))
    Y = np.sin(3 * X[:, :1]) + 0.1 * rng.randn(N, 1)
    return X, Y


def _kerns(name):
    if name == "rbf":
        return gfs.kernels.RBF(1, lengthscales=0.3), gft.kernels.RBF(1, lengthscales=0.3)
    if name == "matern32_ard":
        ls = np.array([0.4, 0.7])
        return (gfs.kernels.Matern32(2, lengthscales=ls, ARD=True),
                gft.kernels.Matern32(2, lengthscales=ls, ARD=True))
    # the deep kernel of config #5 (example 05), narrower
    from gpflow_slim_tpu.kernels_deep import DeepKernel as JDeep
    from gpflow_slim_tpu.kernels_deep import mlp_warp as jmlp

    fn, params = jmlp(jax.random.PRNGKey(0), [2, 4, 1])
    return (JDeep(2, gfs.kernels.RBF(1, lengthscales=0.5), fn, params),
            gft.kernels_deep.DeepKernel(2, gft.kernels.RBF(1, lengthscales=0.5), gft.kernels_deep.mlp_warp([2, 4, 1])))


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


def _cg_pair(kern, materialize, precond_rank=0, N=70, num_probes=4, cg_iters=10, slq_steps=12):
    D = 1 if kern == "rbf" else 2
    X, Y = _data(N, D)
    jk, tk = _kerns(kern)
    kw = dict(num_probes=num_probes, cg_iters=cg_iters, slq_steps=slq_steps, precond_rank=precond_rank,
              materialize_k=materialize)
    jm = gfs.models.GPRCG(X, Y, kern=jk, **kw)
    tm = gft.models.GPRCG(X, Y, kern=tk, device="cpu", **kw)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    return jm, tm


@pytest.fixture
def jax_probes(monkeypatch):
    """Puts the JAX package's probe matrices for ``jm`` in place of the
    port's (``ops.iterative.cg_probes``): the logdet probes from
    ``probe_keys``' first key, split per probe, the trace probes from the
    second, as ``_cg_mll_fwd`` draws them."""

    def use(jm):
        N = jm.X.shape[0]
        kl, kt = jit_.probe_keys(jm.kern, jnp.squeeze(jm.likelihood.variance.value))
        Zld = _t(_jax_probes(kl, N, jm.num_probes))
        Ztr = _t(jax.random.rademacher(kt, (N, jm.num_probes), dtype=jnp.float64))
        monkeypatch.setattr(it, "cg_probes", lambda params, n, p, dtype: (Zld, Ztr))

    return use


def _grads_match(jg, tm):
    # every trainable leaf, a deep kernel's warp included (W transposed)
    want = gft.interop.port_arrays(tm, _unconstrained(jg))
    for n, t in gft.params.trainable_leaves(tm):
        np.testing.assert_allclose(t.grad.numpy(), want[n], rtol=GRAD_RTOL, atol=1e-10, err_msg=n)


@pytest.mark.parametrize("kern,materialize,precond_rank", [
    ("rbf", True, 0), ("rbf", True, 10), ("rbf", False, 0), ("matern32_ard", True, 0),
    ("matern32_ard", False, 0), ("deep", False, 0), ("deep", True, 0)])
def test_gprcg_value_and_grads_match_jax(kern, materialize, precond_rank, jax_probes, monkeypatch):
    jm, tm = _cg_pair(kern, materialize, precond_rank)
    if not materialize:  # several panels, a ragged last one
        monkeypatch.setattr(cg_gpr, "STREAM_BLOCK", 32)
    jax_probes(jm)
    jloss, jg = jax.jit(jax.value_and_grad(lambda m: m.objective()))(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=VALUE_RTOL)
    _grads_match(jg, tm)


@pytest.mark.parametrize("materialize", [True, False])
def test_gprcg_predictions_match_jax(materialize, monkeypatch):
    jm, tm = _cg_pair("rbf", materialize)
    if not materialize:
        monkeypatch.setattr(cg_gpr, "STREAM_BLOCK", 32)
    Xs = np.random.RandomState(4).uniform(-1, 1, (9, 1))
    jmu, jvar = jax.jit(lambda m, x: m.predict_f(x))(jm, jnp.asarray(Xs))
    with torch.no_grad():
        mu, var = tm.predict_f(Xs)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=ATOL, rtol=1e-8)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=ATOL, rtol=1e-8)
    with pytest.raises(NotImplementedError):
        tm.predict_f_full_cov(Xs)


def test_gprcg_streaming_matches_materialized(monkeypatch):
    # tests/test_iterative.py's case on the port: the same probes, only the
    # matvec differs
    monkeypatch.setattr(cg_gpr, "STREAM_BLOCK", 64)
    ms = [_cg_pair("rbf", mat, N=150, num_probes=16, cg_iters=60, slq_steps=25)[1] for mat in (True, False)]
    vals, grads = [], []
    for m in ms:
        loss = m.objective()
        loss.backward()
        vals.append(loss.item())
        grads.append([p.unconstrained.grad.clone() for _, p in gft.params.parameters(m)])
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-10)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("kern", ["rbf", "deep"])
def test_gprcg_streaming_under_torch_func(kern, monkeypatch):
    """Fault m: ``mcmc.batched_value_and_grad`` (``vmap(grad_and_value)``)
    over a streaming GPRCG. Each row equals plain autograd's value and
    gradient at that row, and the materialized mode's row, on fixed probes;
    every leaf of the vector (a deep kernel's warp too) gets its gradient."""
    monkeypatch.setattr(cg_gpr, "STREAM_BLOCK", 32)  # three panels, the last ragged
    rng = np.random.RandomState(11)
    probes = (_t(np.sign(rng.randn(70, 4))), _t(np.sign(rng.randn(70, 4))))
    monkeypatch.setattr(it, "cg_probes", lambda params, n, p, dtype: probes)
    rows = {}
    for materialize in (False, True):
        _, tm = _cg_pair(kern, materialize)
        lp, x0, unpack = gft.mcmc.model_logprob(tm)
        vs = x0[None] + 0.05 * _t(np.random.RandomState(4).randn(3, x0.shape[0]))
        rows[materialize] = gft.mcmc.base.batched_value_and_grad(lp)(vs)
        if materialize:
            continue
        for c in range(vs.shape[0]):
            v = vs[c].clone().requires_grad_()
            want = lp(v)
            (want_g,) = torch.autograd.grad(want, v)
            np.testing.assert_allclose(rows[False][0][c].item(), want.item(), rtol=1e-12)
            # the batched products sum in another order, which CG's
            # iterations amplify to ~1e-10 of the largest gradient
            np.testing.assert_allclose(rows[False][1][c].numpy(), want_g.numpy(), rtol=1e-8,
                                       atol=1e-9 * want_g.abs().max().item())
        # every leaf gets a gradient, but the warp's last bias, which the
        # RBF cannot see (it shifts every warped input alike)
        sizes = {n: t.numel() for n, t in unpack(x0).items()}
        blind = list(sizes).index("kern.warp.layers.1.bias") if kern == "deep" else None
        scale = rows[False][1].abs().max()
        reached = [bool(g.abs().max() > 1e-8 * scale)
                   for g in torch.split(rows[False][1], list(sizes.values()), dim=1)]
        assert reached == [i != blind for i in range(len(sizes))]
    np.testing.assert_allclose(rows[False][0].numpy(), rows[True][0].numpy(), rtol=1e-10)
    np.testing.assert_allclose(rows[False][1].numpy(), rows[True][1].numpy(), rtol=1e-8,
                               atol=1e-10 * rows[True][1].abs().max().item())


def test_gprcg_against_exact_gpr():
    # tests/test_iterative.py's oracle: the estimate near the exact value,
    # the gradient's noise component near GPR's
    X, Y = _data(N=120)
    kw = dict(kern=gft.kernels.RBF(1, lengthscales=0.3), device="cpu")
    cg = gft.models.GPRCG(X, Y, num_probes=32, cg_iters=120, slq_steps=30, precond_rank=20, **kw)
    gpr = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.3), device="cpu")
    v_cg, v_gpr = cg.objective(), gpr.objective()
    assert abs(v_cg.item() - v_gpr.item()) / abs(v_gpr.item()) < 0.02
    v_cg.backward()
    v_gpr.backward()
    g_cg = cg.likelihood.variance.unconstrained.grad.item()
    g_gpr = gpr.likelihood.variance.unconstrained.grad.item()
    assert abs(g_cg - g_gpr) <= 0.1 * abs(g_gpr) + 1.0
    assert float(cg.last_cg_residuals.max()) < 1e-6


def test_port_probes_repeat_and_redraw():
    """The port's probes: a function of the parameters' bits, the same for
    the same parameters, new when one moves (by less than float32
    resolution too), the value and gradient of one evaluation on one draw."""
    X, Y = _data(N=40)
    m = gft.models.GPRCG(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.3), device="cpu", num_probes=8)
    noise = torch.squeeze(m.likelihood.variance.value)
    params = [*m.kern.parameters(), noise]
    Z1 = it.cg_probes(params, 40, 8, torch.float64)
    Z2 = it.cg_probes([p.clone() for p in params], 40, 8, torch.float64)
    for a, b in zip(Z1, Z2):
        assert torch.equal(a, b)
    assert not torch.equal(Z1[0], Z1[1])  # the two draws differ
    assert set(Z1[0].unique().tolist()) == {-1.0, 1.0}
    with torch.no_grad():
        m.kern.lengthscales.unconstrained.add_(1e-12)
    Z3 = it.cg_probes([*m.kern.parameters(), noise], 40, 8, torch.float64)
    assert not torch.equal(Z1[0], Z3[0]) and not torch.equal(Z1[1], Z3[1])
    # order-sensitive: the same values in another order give other probes
    Z4 = it.cg_probes(params[::-1], 40, 8, torch.float64)
    assert not torch.equal(Z1[0], Z4[0])
    # a value and its gradient: one draw (the objective twice is bit-equal)
    with torch.no_grad():
        v1 = m.objective().item()
    loss = m.objective()
    assert loss.item() == v1
    # the probes' mean is near 0 and their columns near orthogonal
    Z = it.cg_probes(params, 4000, 8, torch.float64)[0]
    assert abs(float(Z.mean())) < 0.05
    G = Z.T @ Z / 4000
    assert float((G - torch.eye(8, dtype=torch.float64)).abs().max()) < 0.1
