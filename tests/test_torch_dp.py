"""Parity of the port's data-parallel SVGP trainer and rank meshes
(``gpflow_slim_tpu_torch.parallel.dp`` and ``.mesh``) with the JAX package,
on the CPU in float64.

``dp_value_and_grad`` runs on gloo worlds of 1, 2 and 4 ranks, each rank a
process of its own (``tests/_torch_dp_worker.py``, which imports no JAX),
and equals the JAX package's over meshes of 1, 2 and 4 of the 8 virtual CPU
devices (tests/test_parallel.py's two cases). ``fit_svgp`` from one seed
gives the same losses and parameters on 1, 2 and 4 ranks. Each world is
started once for the file, on a free port of its own, and joined against a
deadline (``DEADLINE_S``): a hung collective kills its ranks and fails, it
never holds the suite. In the test process (no process group): one
``make_svgp_step`` on an injected batch equals the JAX package's Adam step,
a mesh of one rank is the identity, the errors, and JAX's training check.
"""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu import parallel as jparallel
from gpflow_slim_tpu.params import parameters as jax_parameters

torch.set_num_threads(2)

WORLDS = (1, 2, 4)
DEADLINE_S = 90.0   # a world's start, work and exit
RTOL = 1e-10        # the same f64 sums, split over ranks in another order


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


def _jax_cases():
    """The JAX models of tests/test_parallel.py's dp cases (a q away from
    its initialisation, so every gradient is live) and of its training
    check, with the arrays the ranks build the port's from."""
    rng = np.random.RandomState(7)
    X = rng.uniform(0, 1, (64, 2))
    Y = (np.sin(4 * X[:, :1]) > 0).astype(float)
    jb = gfs.models.SVGP(X, Y, kern=gfs.kernels.RBF(2), likelihood=gfs.likelihoods.Bernoulli(), Z=X[:8].copy())
    jb.q_mu = gfs.params.Param(0.3 * rng.randn(8, 1), name="q_mu")
    rng = np.random.RandomState(11)
    X2 = rng.uniform(0, 1, (32, 1))
    Y2 = np.sin(4 * X2) + 0.1 * rng.randn(32, 1)
    k = gfs.kernels.RBF(1)
    k.variance = gfs.params.Param(1.0, transform=gfs.transforms.positive(), prior=gfs.priors.LogNormal(0.0, 1.0),
                                  name="variance")
    jp = gfs.models.SVGP(X2, Y2, kern=k, likelihood=gfs.likelihoods.Gaussian(), Z=X2[:4].copy())
    rng = np.random.RandomState(8)
    X3 = rng.uniform(0, 1, (256, 1))
    Y3 = (np.sin(8 * X3) > 0).astype(float)
    models = {"bernoulli": (jb, X, Y, 32), "priors": (jp, X2, Y2, 32)}
    cases = {c: {"X": X_, "Y": Y_, "B": B, "unconstrained": _unconstrained(jm)}
             for c, (jm, X_, Y_, B) in models.items()}
    cases["fit"] = {"X": X3, "Y": Y3}
    return models, cases


@pytest.fixture(scope="module")
def jax_cases():
    return _jax_cases()


@pytest.fixture(scope="module")
def world(jax_cases, tmp_path_factory):
    """``world(n)``: the results of the rank program on a gloo world of n
    ranks, run once for the file."""
    import _torch_dp_worker as worker

    done = {}

    def run(n):
        if n not in done:
            out = tmp_path_factory.mktemp(f"world{n}") / "rank0.npz"
            ctx = mp.start_processes(worker.run, args=(n, _free_port(), jax_cases[1], str(out)), nprocs=n,
                                     join=False, start_method="spawn")
            deadline = time.monotonic() + DEADLINE_S
            try:
                while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                    if time.monotonic() >= deadline:
                        raise TimeoutError(f"the {n}-rank world did not finish in {DEADLINE_S:.0f} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join(5)
            done[n] = dict(np.load(out))
        return done[n]

    return run


def _jax_dp(jm, X, Y, B, n):
    mesh = jparallel.make_mesh({"data": n}, devices=jax.devices()[:n])
    loss, g = jax.jit(lambda mm, xb, yb: jparallel.dp_value_and_grad(mm, xb, yb, mesh, axis="data"))(
        jm, jnp.asarray(X[:B]), jnp.asarray(Y[:B]))
    return float(loss), _unconstrained(g)


@pytest.mark.parametrize("case", ["bernoulli", "priors"])
@pytest.mark.parametrize("n", WORLDS)
def test_dp_value_and_grad_matches_jax(n, case, world, jax_cases):
    res = world(n)
    jm, X, Y, B = jax_cases[0][case]
    jloss, jgrads = _jax_dp(jm, X, Y, B, n)
    np.testing.assert_allclose(res[f"{case}/loss"], jloss, rtol=RTOL)
    want = {gft.interop.port_name(k): v for k, v in jgrads.items()}
    got = {k.split("/", 2)[2]: v for k, v in res.items() if k.startswith(f"{case}/grad/")}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=1e-9, atol=1e-12 * np.abs(want[name]).max(), err_msg=name)


def test_fit_svgp_same_losses_on_1_2_4_ranks(world):
    ref = world(1)
    assert np.isfinite(ref["fit/losses"]).all() and ref["fit/losses"].shape == (5,)
    for n in WORLDS[1:]:
        res = world(n)
        np.testing.assert_allclose(res["fit/losses"], ref["fit/losses"], rtol=RTOL)
        for k in (k for k in ref if k.startswith("fit/param/")):
            np.testing.assert_allclose(res[k], ref[k], rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_dp_batch_not_divisible_raises(n, world):
    # 31 rows: no world of more than one rank divides them
    assert bool(world(n)["raised"]) == (n > 1)


def test_mesh_named_axes_on_4_ranks(world):
    res = world(4)
    np.testing.assert_array_equal(res["mesh2/shape"], [2, 2])
    np.testing.assert_array_equal(res["mesh2/cols_sum"], [1, 1, 5, 5])  # ranks (0, 1) and (2, 3) per row


def test_mesh_of_one_rank_is_the_identity(jax_cases):
    jm, X, Y, B = jax_cases[0]["bernoulli"]
    tm = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(2), likelihood=gft.likelihoods.Bernoulli(), Z=X[:8].copy(),
                         device="cpu", dtype=torch.float64)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    mesh = gft.parallel.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.group("data") is None
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(gft.parallel.shard_rows(mesh, "data")(x), x)
    assert gft.parallel.replicated(mesh)(x) is x
    loss, grads = gft.parallel.dp_value_and_grad(tm, X[:B], Y[:B], mesh)
    want = -(tm.build_likelihood_batch(X[:B], Y[:B]) + tm.log_prior())
    want_g = torch.autograd.grad(want, [t for _, t in gft.params.trainable_leaves(tm)])
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-12)
    for g, w in zip(grads.values(), want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-13)


def test_make_mesh_sizes():
    assert gft.parallel.make_mesh({"data": -1}).shape == {"data": 1}
    assert gft.parallel.make_mesh({"a": 2, "b": -1}, devices=[0, 1, 2, 3]).shape == {"a": 2, "b": 2}
    with pytest.raises(ValueError, match="devices"):
        gft.parallel.make_mesh({"data": 2})
    with pytest.raises(ValueError, match="devices"):
        gft.parallel.make_mesh({"a": 3, "b": 2}, devices=[0, 1, 2, 3])


def test_make_svgp_step_on_an_injected_batch_matches_jax_adam(jax_cases):
    # one step on a given minibatch: the JAX step of tests/test_io.py
    jm, X, Y, _ = jax_cases[0]["bernoulli"]
    xb, yb = X[10:42], Y[10:42]
    opt = optax.adam(0.05)
    mask = gfs.params.trainable_leaf_mask(jm)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jloss, jg = jax.value_and_grad(lambda z: -(z.build_likelihood_batch(jnp.asarray(xb), jnp.asarray(yb))
                                               + z.log_prior()))(jm)
    g = [gr * t for gr, t in zip(jax.tree_util.tree_leaves(jg), mask)]
    upd, _ = opt.update(g, opt.init(leaves), leaves)
    upd = [u * t for u, t in zip(upd, mask)]
    jm2 = jax.tree_util.tree_unflatten(treedef, [lf + u for lf, u in zip(leaves, upd)])
    tm = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(2), likelihood=gft.likelihoods.Bernoulli(), Z=X[:8].copy(),
                         device="cpu", dtype=torch.float64)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    step, _ = gft.parallel.make_svgp_step(tm, lambda ps: torch.optim.Adam(ps, lr=0.05))
    loss = step(batch=(xb, yb))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    want = gft.interop.port_arrays(tm, _unconstrained(jm2))
    for n, t in gft.params.trainable_leaves(tm):
        np.testing.assert_allclose(t.detach().numpy(), want[n], rtol=RTOL, atol=1e-12, err_msg=n)


def test_make_svgp_step_errors(jax_cases):
    jm, X, Y, _ = jax_cases[0]["bernoulli"]
    tm = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(2), likelihood=gft.likelihoods.Bernoulli(), Z=X[:8].copy(),
                         device="cpu", dtype=torch.float64)
    step, _ = gft.parallel.make_svgp_step(tm, lambda ps: torch.optim.Adam(ps, lr=0.05), batch_size=16)
    with pytest.raises(ValueError, match="generator or a batch"):
        step()
    with pytest.raises(ValueError, match="generator or a batch"):
        step(torch.Generator(), batch=(X[:4], Y[:4]))
    assert bool(torch.isfinite(step(torch.Generator().manual_seed(3))))


def test_fit_svgp_trains():
    # tests/test_parallel.py's test_fit_svgp_sharded_trains, on one process
    rng = np.random.RandomState(8)
    X = rng.uniform(0, 1, (256, 1))
    Y = (np.sin(8 * X) > 0).astype(float)
    m = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.3), likelihood=gft.likelihoods.Bernoulli(),
                        Z=np.linspace(0, 1, 16)[:, None], device="cpu", dtype=torch.float64)
    with torch.no_grad():
        before = m.objective().item()
    m2, losses = gft.parallel.fit_svgp(m, num_steps=200, generator=torch.Generator().manual_seed(0),
                                       learning_rate=0.05, batch_size=64, mesh=gft.parallel.make_mesh())
    with torch.no_grad():
        after = m2.objective().item()
    assert losses.shape == (200,) and after < before - 5.0

