"""Parity of the port's distributed dense linear algebra with the JAX
package, on the CPU in float64: ``ops.blocked`` (factor, solves and their
adjoints), ``parallel.ring_gram`` (the Gram and the matvec), the
distributed GPR loss (``make_distributed_gpr_loss``: value and gradients,
with a mean function), ``distributed_cholesky`` and
``distributed_solve_lower`` (values and gradients) and ``cyclic_cholesky``
(both schedules, and its gradient).

The distributed cases run on gloo worlds of 1, 2 and 4 ranks
(``tests/_torch_dist_worker.py``, which imports no JAX), each started once
for the file and joined against a deadline (``tests/_torch_worlds.py``),
against the JAX package over its 8 virtual CPU devices
(tests/test_parallel.py's cases). Values to 1e-10 relative, gradients to
1e-7 absolute (tests/test_parallel.py's), factors and solves to 1e-10.
In the test process: ``ops.blocked`` against the JAX package's, a mesh of
one rank (no process group) as the identity, NUTS over the distributed
loss, and fault q (``initialize_distributed`` without a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from _torch_worlds import run_world
from gpflow_slim_tpu import parallel as jparallel
from gpflow_slim_tpu.ops import blocked as jblocked
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu_torch.ops import blocked

torch.set_num_threads(2)

WORLDS = (1, 2, 4)
RTOL = 1e-10   # values, factors and solves: the same f64 steps, summed over ranks in another order
GRAD_ATOL = 1e-7


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _spd(rng, N):
    A = rng.randn(N, N)
    return A @ A.T + N * np.eye(N)


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


def _gpr_data(seed, N, offset=0.0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0, 1, (N, 1))
    return X, offset + np.sin(6 * X) + 0.1 * rng.randn(N, 1)


@pytest.fixture(scope="module")
def jax_cases():
    """The arrays of tests/test_parallel.py's cases, and the JAX package's
    results for them over its 8 virtual devices."""
    mesh = jparallel.make_mesh({"data": 8})
    cases, want = {}, {}
    rng = np.random.RandomState(3)
    X = rng.randn(48, 2)
    cases["ring"] = {"X": X}
    want["ring"] = np.asarray(jax.jit(lambda k, x: jparallel.ring_gram(k, x, mesh, axis="data"))(
        gfs.kernels.RBF(2, variance=1.4, lengthscales=0.7), jnp.asarray(X)))
    rng = np.random.RandomState(4)
    X, v = rng.randn(40, 2), rng.randn(40, 2)
    cases["matvec"] = {"X": X, "v": v}
    want["matvec"] = np.asarray(jax.jit(lambda k, x, w: jparallel.ring_gram_matvec(k, x, w, mesh, axis="data",
                                                                                  noise=0.3))(
        gfs.kernels.Matern32(2), jnp.asarray(X), jnp.asarray(v)))
    for key, seed, N, mean in (("mll", 5, 64, False), ("grad", 6, 32, False), ("mean", 14, 32, True)):
        X, Y = _gpr_data(seed, N, 2.0 if mean else 0.0)
        kw = {"mean_function": gfs.mean_functions.Constant(c=[1.5])} if mean else {}
        jm = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.4), **kw)
        loss_fn = jparallel.make_distributed_gpr_loss(jm, mesh, axis="data", block_size=8)
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(jm)
        cases[key] = {"X": X, "Y": Y, "unconstrained": _unconstrained(jm)}
        want[key] = (float(loss), _unconstrained(g), float(jax.jit(lambda mm: mm.objective())(jm)))
    rng = np.random.RandomState(1)
    K, B, W = _spd(rng, 64), rng.randn(64, 3), rng.randn(64, 3)
    cases["factor"] = {"K": K, "B": B, "W": W}
    jK = jnp.asarray(K)
    L = jax.jit(lambda k: jparallel.distributed_cholesky(k, mesh, "data", block_size=16))(jK)
    want["factor/L"] = np.asarray(L)
    want["factor/X"] = np.asarray(jax.jit(lambda l, b: jparallel.distributed_solve_lower(
        l, b, mesh, "data", block_size=16))(L, jnp.asarray(B)))
    want["factor/grad"] = np.asarray(jax.jit(jax.grad(lambda k: jnp.sum(jnp.log(jnp.diagonal(
        jparallel.distributed_cholesky(k, mesh, "data", block_size=16))))))(jK))
    Lr = jnp.asarray(np.linalg.cholesky(K))
    want["solve/gL"], want["solve/gB"] = (np.asarray(a) for a in jax.jit(jax.grad(
        lambda l, b: jnp.sum(jparallel.distributed_solve_lower(l, b, mesh, "data", block_size=16) * W),
        argnums=(0, 1)))(Lr, jnp.asarray(B)))
    rng = np.random.RandomState(12)
    K = _spd(rng, 128)
    cases["cyclic"] = {"K": K}
    want["cyclic"] = {look: np.asarray(jax.jit(lambda k, look=look: jparallel.cyclic_cholesky(
        k, mesh, "data", block_size=16, lookahead=look))(jnp.asarray(K))) for look in (True, False)}
    rng = np.random.RandomState(13)
    K = _spd(rng, 64)
    cases["cyclic_grad"] = {"K": K}
    want["cyclic_grad"] = np.asarray(jax.jit(jax.grad(lambda k: jnp.sum(jnp.log(jnp.diagonal(
        jparallel.cyclic_cholesky(k, mesh, "data", block_size=8))))))(jnp.asarray(K)))
    return cases, want


@pytest.fixture(scope="module")
def world(jax_cases, tmp_path_factory):
    done = {}

    def run(n):
        if n not in done:
            done[n] = run_world("linalg", n, jax_cases[0], tmp_path_factory.mktemp(f"linalg{n}"))
        return done[n]

    return run


def _sym(g):
    return 0.5 * (g + g.T)


@pytest.mark.parametrize("n", WORLDS)
def test_ring_gram_matches_jax(n, world, jax_cases):
    np.testing.assert_allclose(world(n)["ring"], jax_cases[1]["ring"], rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("n", WORLDS)
def test_ring_gram_matvec_matches_jax(n, world, jax_cases):
    np.testing.assert_allclose(world(n)["matvec"], jax_cases[1]["matvec"], rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("key", ["mll", "grad", "mean"])
@pytest.mark.parametrize("n", WORLDS)
def test_distributed_gpr_loss_and_grad_match_jax(n, key, world, jax_cases):
    res = world(n)
    jloss, jgrads, jobjective = jax_cases[1][key]
    np.testing.assert_allclose(res[f"{key}/loss"], jloss, rtol=RTOL)
    np.testing.assert_allclose(res[f"{key}/loss"], jobjective, rtol=RTOL)  # the single device's objective
    got = {k.split("/", 2)[2]: v for k, v in res.items() if k.startswith(f"{key}/grad/")}
    want = {gft.interop.port_name(k): v for k, v in jgrads.items() if gft.interop.port_name(k) in got}
    assert sorted(got) == sorted(want) and got
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=GRAD_ATOL, err_msg=name)
    if key == "mean":  # the mean function's parameter gets a gradient through the distributed path
        assert abs(float(got["mean_function.c"][0])) > 1e-3


@pytest.mark.parametrize("n", WORLDS)
def test_distributed_factor_and_solve_match_jax(n, world, jax_cases):
    res, want = world(n), jax_cases[1]
    K, B = jax_cases[0]["factor"]["K"], jax_cases[0]["factor"]["B"]
    np.testing.assert_allclose(res["factor/L"], want["factor/L"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(res["factor/L"], np.linalg.cholesky(K), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(res["factor/X"], want["factor/X"], rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(res["factor/x"], want["factor/X"][:, 0], rtol=RTOL, atol=1e-13)
    # the factor's gradient: its symmetric part is JAX's and 1/2 K^-1
    np.testing.assert_allclose(_sym(res["factor/grad"]), _sym(want["factor/grad"]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_sym(res["factor/grad"]), 0.5 * np.linalg.inv(K), rtol=0, atol=1e-12)
    np.testing.assert_allclose(res["solve/gL"], want["solve/gL"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(res["solve/gB"], want["solve/gB"], rtol=RTOL, atol=1e-12)
    assert np.abs(np.triu(res["solve/gL"], 1)).max() == 0.0 and np.abs(res["solve/gB"]).max() > 0


@pytest.mark.parametrize("n", WORLDS)
def test_cyclic_cholesky_matches_jax(n, world, jax_cases):
    res, want = world(n), jax_cases[1]
    Lref = np.linalg.cholesky(jax_cases[0]["cyclic"]["K"])
    for look in (True, False):  # lookahead reorders, must not change math
        np.testing.assert_allclose(res[f"cyclic/{look}"], want["cyclic"][look], rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(res[f"cyclic/{look}"], Lref, atol=1e-10)
    K = jax_cases[0]["cyclic_grad"]["K"]
    np.testing.assert_allclose(_sym(res["cyclic_grad"]), _sym(want["cyclic_grad"]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_sym(res["cyclic_grad"]), 0.5 * np.linalg.inv(K), atol=1e-9)


# -- in the test process -------------------------------------------------------

def test_blocked_cholesky_matches_jax():
    rng = np.random.RandomState(0)
    K = _spd(rng, 96)
    L = blocked.blocked_cholesky(_t(K), block_size=32).numpy()
    np.testing.assert_allclose(L, np.asarray(jblocked.blocked_cholesky(jnp.asarray(K), 32)), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(L, np.linalg.cholesky(K), atol=1e-8)


@pytest.mark.parametrize("vector", [False, True])
def test_blocked_solves_match_jax(vector):
    rng = np.random.RandomState(1)
    L = np.linalg.cholesky(_spd(rng, 64))
    B = rng.randn(64, 3)
    if vector:
        B = B[:, 0]
    X1 = blocked.blocked_solve_lower(_t(L), _t(B), block_size=16).numpy()
    np.testing.assert_allclose(X1, np.asarray(jblocked.blocked_solve_lower(jnp.asarray(L), jnp.asarray(B), 16)),
                               rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(X1, np.linalg.solve(L, B), atol=1e-8)
    X2 = blocked.blocked_solve_upper(_t(L.T), _t(B), block_size=16).numpy()
    np.testing.assert_allclose(X2, np.asarray(jblocked.blocked_solve_upper(jnp.asarray(L.T), jnp.asarray(B), 16)),
                               rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(X2, np.linalg.solve(L.T, B), atol=1e-8)


def test_blocked_adjoints_match_jax():
    # tests/test_parallel.py's gradient check, and each solve's adjoint
    # against the JAX package's custom VJPs
    rng = np.random.RandomState(2)
    K = _spd(rng, 32)
    Kt = _t(K).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(torch.log(torch.diagonal(blocked.blocked_cholesky(Kt, 8)))), Kt)
    jg = np.asarray(jax.grad(lambda k: jnp.sum(jnp.log(jnp.diagonal(jblocked.blocked_cholesky(k, 8)))))(
        jnp.asarray(K)))
    np.testing.assert_allclose(_sym(g.numpy()), _sym(jg), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_sym(g.numpy()), 0.5 * np.linalg.inv(K), atol=1e-10)
    L, B, W = np.linalg.cholesky(K), rng.randn(32, 2), rng.randn(32, 2)
    for solve, jsolve, T in ((blocked.blocked_solve_lower, jblocked.blocked_solve_lower, L),
                             (blocked.blocked_solve_upper, jblocked.blocked_solve_upper, L.T)):
        Tt, Bt = _t(T).requires_grad_(), _t(B).requires_grad_()
        got = torch.autograd.grad(torch.sum(solve(Tt, Bt, 8) * _t(W)), (Tt, Bt))
        want = jax.grad(lambda t, b: jnp.sum(jsolve(t, b, 8) * W), argnums=(0, 1))(jnp.asarray(T), jnp.asarray(B))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-12)


def test_blocked_through_torch_func():
    # grad and vmap go through the Functions (vmap: one call per entry)
    rng = np.random.RandomState(3)
    Ks = torch.stack([_t(_spd(rng, 32)) for _ in range(2)])
    L = torch.func.vmap(lambda k: blocked.blocked_cholesky(k, 8))(Ks)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(Ks.numpy()), atol=1e-10)
    logdet = lambda k: torch.sum(torch.log(torch.diagonal(blocked.blocked_cholesky(k, 8))))  # noqa: E731
    g = torch.func.vmap(torch.func.grad(logdet))(Ks)
    for gi, K in zip(g.numpy(), Ks.numpy()):
        np.testing.assert_allclose(_sym(gi), 0.5 * np.linalg.inv(K), atol=1e-10)


def test_blocked_errors_and_pad():
    with pytest.raises(ValueError, match="not divisible"):
        blocked.blocked_cholesky(torch.eye(10, dtype=torch.float64), block_size=4)
    K = _t(_spd(np.random.RandomState(4), 10))
    Kp, N = blocked.pad_to_block(K, 4)
    assert N == 10 and Kp.shape == (12, 12)
    L = blocked.blocked_cholesky(Kp, 4)
    np.testing.assert_allclose(L[:10, :10].numpy(), np.linalg.cholesky(K.numpy()), atol=1e-10)
    np.testing.assert_allclose(L[10:, 10:].numpy(), np.eye(2), atol=0)
    assert blocked.pad_to_block(K, 5)[0] is K


def test_blocked_route_calls_the_kernels_wrappers(monkeypatch):
    # on the kernel route a diagonal block goes to the factor-only
    # Cholesky's Function and the panel and the diagonal solves to the
    # TRSM's; on the CPU those run their plain versions
    calls = {"cholesky": 0, "trsm": 0}
    chol, solve = gft.ops.cholesky.cholesky, gft.ops.trsm._Trsm.apply

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(gft.ops.linalg, "kernels_active", lambda t: True)
    monkeypatch.setattr(gft.ops.cholesky, "cholesky", count("cholesky", chol))
    monkeypatch.setattr(gft.ops.trsm._Trsm, "apply", count("trsm", solve))
    K = _t(_spd(np.random.RandomState(5), 32))
    L = blocked.blocked_cholesky(K, 8)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K.numpy()), atol=1e-10)
    assert calls == {"cholesky": 4, "trsm": 3}
    blocked.blocked_solve_lower(L, _t(np.ones((32, 2))), 8)
    assert calls["trsm"] == 3 + 4


def test_distributed_gpr_on_one_rank_is_the_gpr():
    # a mesh of one rank (no process group) runs the single-device identity
    X, Y = _gpr_data(6, 32)
    m = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.4), device="cpu")
    mesh = gft.parallel.make_mesh({"rows": 1})
    loss = gft.parallel.make_distributed_gpr_loss(m, mesh, axis="rows", block_size=8)(m)
    loss.backward()
    got = {n: t.grad.clone() for n, t in gft.params.trainable_leaves(m)}
    m.zero_grad()
    want = m.objective()
    want.backward()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-12)
    for n, t in gft.params.trainable_leaves(m):
        np.testing.assert_allclose(got[n].numpy(), t.grad.numpy(), rtol=1e-10, atol=1e-13, err_msg=n)
    X4 = torch.tensor(X[:8])
    np.testing.assert_allclose(gft.parallel.ring_gram(m.kern, X4, mesh, "rows").detach().numpy(),
                               m.kern.K(X4).detach().numpy(), rtol=1e-14)
    with pytest.raises(ValueError, match="not divisible"):
        gft.parallel.make_distributed_gpr_loss(m, mesh, axis="rows", block_size=12)(m)


def test_nuts_over_distributed_gpr_logprob():
    # tests/test_parallel.py's NUTS over the distributed marginal
    # likelihood, on a mesh of one rank: the sampler's batched gradient
    # (torch.func.vmap of grad) goes through the blocked Functions
    X, Y = _gpr_data(9, 32)
    k = gft.kernels.RBF(1, lengthscales=0.3)
    k.variance = gft.params.Param(1.0, transform=gft.transforms.positive(), prior=gft.priors.LogNormal(0.0, 1.0),
                                  name="v")
    m = gft.models.GPR(X, Y, kern=k, device="cpu")
    loss_fn = gft.parallel.make_distributed_gpr_loss(m, gft.parallel.make_mesh({"data": 1}), axis="data",
                                                     block_size=8)
    v0, unpack = gft.params.pack_trainable(m)
    call = gft.mcmc.base._LogPosterior(m)
    call.forward = lambda: -loss_fn(call.model)
    lp = lambda v: torch.func.functional_call(call, {f"model.{n}": t for n, t in unpack(v).items()}, ())  # noqa: E731
    want_lp, _, _ = gft.mcmc.model_logprob(m)
    np.testing.assert_allclose(lp(v0).item(), want_lp(v0).item(), rtol=1e-12)
    samples, _ = gft.mcmc.nuts(lp, v0, torch.Generator().manual_seed(0), num_samples=30, num_warmup=30, max_depth=6)
    s = samples.numpy()
    assert np.isfinite(s).all() and np.std(s[:, 0]) > 1e-3


def test_initialize_distributed_needs_a_card():
    # fault q: without a card the default backend (nccl) raises and names
    # the way to ask for the CPU; the worlds above ask for gloo by name
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        gft.parallel.initialize_distributed("localhost:1", 1, 0)
    assert not torch.distributed.is_initialized()
