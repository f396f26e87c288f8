"""Parity of the port's 2-D block-cyclic distributed GPR
(``parallel.grid_gpr``, ``parallel.grid_cholesky``) with the JAX package, on
the CPU in float64.

One gloo world of 4 ranks (``tests/_torch_dist_worker.py``, no JAX; started
once for the file, joined against a deadline) lays its ranks on the meshes
2 x 2, 4 x 1 and 1 x 4 in turn and runs tests/test_grid_gpr.py's cases on
each: the tiled Gram against the dense one, the in-layout factor, the
logdet and the thin solves, the identity's tiles, the wide grid TRSM
(L^-1) and the SUMMA K^-1, the loss and its gradients, the shape guard, and
tests/test_parallel.py's grid Cholesky cases. The JAX package's results are
over its 2 x 4 and 4 x 2 meshes of 8 virtual devices (the results do not
depend on the mesh). Values to 1e-10 relative, gradients and factors as
the JAX package's own tests hold its grid to the single device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from _torch_worlds import run_world
from gpflow_slim_tpu import parallel as jparallel
from gpflow_slim_tpu.params import parameters as jax_parameters

torch.set_num_threads(2)

MESHES = ("2x2", "4x1", "1x4")
RTOL = 1e-10


def _mesh(shape):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape), ("rows", "cols"))


def _spd(rng, N):
    A = rng.randn(N, N)
    return A @ A.T / N + 2.0 * np.eye(N)


def _perm(M, lo):
    return jnp.asarray(M)[lo.row_perm()][:, lo.col_perm()]


def _unperm(Mp, lo):
    return np.asarray(Mp)[np.argsort(lo.row_perm())][:, np.argsort(lo.col_perm())]


@pytest.fixture(scope="module")
def jax_cases():
    rng = np.random.RandomState(0)
    cases, want = {}, {}
    X = rng.uniform(0, 1, (128, 2))
    cases["gram"] = {"X": X}
    K = _spd(rng, 128)
    cases["tiles"] = {"K": K}
    K96 = _spd(rng, 96)
    L96 = np.linalg.cholesky(K96)
    cases["thin"] = {"L": np.tril(L96), "rhs": rng.randn(96, 3), "K": K96}
    Xl = rng.uniform(0, 1, (128, 2))
    F = np.sin(3 * Xl[:, :1]) + np.cos(2 * Xl[:, 1:])
    cases["loss"] = {"X": Xl, "Y": np.concatenate([F, 0.5 * F + 0.1], axis=1)}
    for N in (64, 128):
        A = rng.randn(N, N)
        cases[f"chol{N}"] = {"K": A @ A.T + N * np.eye(N)}
    for shape in ((2, 4), (4, 2)):
        key = f"{shape[0]}x{shape[1]}"
        mesh = _mesh(shape)
        lo = jparallel.GridLayout(128, mesh, block_size=16)
        Kp = jax.jit(lambda x: jparallel.grid_gram(gfs.kernels.Matern32(2, lengthscales=0.7), x, lo, diag_add=0.25))(
            jnp.asarray(X))
        want[f"{key}/gram"] = _unperm(Kp, lo)
        want[f"{key}/tiles"] = _unperm(jax.jit(lambda k: jparallel.grid_cholesky_tiles(k, lo))(_perm(K, lo)), lo)
        lo = jparallel.GridLayout(96, mesh, block_size=8)
        Lp = _perm(np.tril(L96), lo)
        rhs = jnp.asarray(cases["thin"]["rhs"])
        want[f"{key}/logdet"] = float(jax.jit(lambda l: jparallel.grid_gpr.grid_logdet(l, lo))(Lp))
        want[f"{key}/alpha"] = np.asarray(jax.jit(lambda l, r: jparallel.grid_solve_lower_thin(l, r, lo))(Lp, rhs))
        want[f"{key}/beta"] = np.asarray(jax.jit(lambda l, r: jparallel.grid_solve_upper_thin(l, r, lo))(Lp, rhs))
        Wp = jax.jit(lambda l: jparallel.grid_solve_lower_wide(l, jparallel.grid_gpr._grid_identity(lo, l.dtype),
                                                               lo))(Lp)
        want[f"{key}/inv_L"] = _unperm(Wp, lo)
        want[f"{key}/inv_K"] = _unperm(jax.jit(lambda w: jparallel.grid_gpr._grid_ata(w, lo))(Wp), lo)
        jm = gfs.models.GPR(Xl, cases["loss"]["Y"], kern=gfs.kernels.RBF(2, lengthscales=[0.4, 0.6], variance=1.3))
        loss, g = jax.jit(jax.value_and_grad(jparallel.make_grid_gpr_loss(jm, mesh, block_size=16)))(jm)
        want[f"{key}/loss"] = (float(loss), {n: np.asarray(p.unconstrained) for n, p in jax_parameters(g)},
                               float(jax.jit(lambda mm: mm.objective())(jm)))
    mesh = jparallel.make_mesh({"rows": 4, "cols": 2})
    want["chol64"] = np.asarray(jax.jit(lambda k: jparallel.grid_cholesky(k, mesh, ("rows", "cols"), block_size=8))(
        jnp.asarray(cases["chol64"]["K"])))
    mesh = jparallel.make_mesh({"rows": 2, "cols": 4})
    want["chol128"] = np.asarray(jax.jit(lambda k: jparallel.grid_cholesky(k, mesh, ("rows", "cols"), block_size=8))(
        jnp.asarray(cases["chol128"]["K"])))
    return cases, want


@pytest.fixture(scope="module")
def world(jax_cases, tmp_path_factory):
    return run_world("grid", 4, jax_cases[0], tmp_path_factory.mktemp("grid4"))


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_gram_matches_jax(mesh, world, jax_cases):
    X = jax_cases[0]["gram"]["X"]
    dense = np.asarray(gfs.kernels.Matern32(2, lengthscales=0.7).K(jnp.asarray(X))) + 0.25 * np.eye(128)
    for jmesh in ("2x4", "4x2"):
        np.testing.assert_allclose(world[f"{mesh}/gram"], jax_cases[1][f"{jmesh}/gram"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(world[f"{mesh}/gram"], dense, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_cholesky_tiles_match_jax(mesh, world, jax_cases):
    K = jax_cases[0]["tiles"]["K"]
    for jmesh in ("2x4", "4x2"):
        np.testing.assert_allclose(world[f"{mesh}/tiles"], jax_cases[1][f"{jmesh}/tiles"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(world[f"{mesh}/tiles"], np.linalg.cholesky(K), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_logdet_and_thin_solves_match_jax(mesh, world, jax_cases):
    c, want = jax_cases[0]["thin"], jax_cases[1]
    L = c["L"]
    np.testing.assert_allclose(world[f"{mesh}/logdet"], want["2x4/logdet"], rtol=1e-12)
    np.testing.assert_allclose(world[f"{mesh}/logdet"], np.sum(np.log(np.diag(L))), rtol=1e-12)
    np.testing.assert_allclose(world[f"{mesh}/alpha"], want["2x4/alpha"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(world[f"{mesh}/alpha"], np.linalg.solve(L, c["rhs"]), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(world[f"{mesh}/beta"], want["2x4/beta"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(world[f"{mesh}/beta"], np.linalg.solve(L.T, c["rhs"]), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_wide_trsm_and_inverse_match_jax(mesh, world, jax_cases):
    c, want = jax_cases[0]["thin"], jax_cases[1]
    np.testing.assert_array_equal(world[f"{mesh}/identity"], np.eye(96))
    for jmesh in ("2x4", "4x2"):
        np.testing.assert_allclose(world[f"{mesh}/inv_L"], want[f"{jmesh}/inv_L"], rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(world[f"{mesh}/inv_K"], want[f"{jmesh}/inv_K"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(world[f"{mesh}/inv_L"], np.linalg.inv(c["L"]), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(world[f"{mesh}/inv_K"], np.linalg.inv(c["K"]), rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_gpr_loss_and_grad_match_jax(mesh, world, jax_cases):
    # the headline equality: the grid loss is the single device's objective,
    # value and gradient, with two outputs; and it is JAX's on both its meshes
    got = {k.split("/", 3)[3]: v for k, v in world.items() if k.startswith(f"{mesh}/loss/grad/")}
    assert got
    for jmesh in ("2x4", "4x2"):
        jloss, jgrads, jobjective = jax_cases[1][f"{jmesh}/loss"]
        np.testing.assert_allclose(world[f"{mesh}/loss/loss"], jloss, rtol=RTOL)
        np.testing.assert_allclose(world[f"{mesh}/loss/loss"], jobjective, rtol=RTOL)
        want = {gft.interop.port_name(k): v for k, v in jgrads.items()}
        assert set(got) <= set(want)
        for name, g in got.items():
            np.testing.assert_allclose(g, want[name], rtol=1e-8, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_shape_guard(mesh, world):
    assert bool(world[f"{mesh}/guard"])


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_cholesky_matches_jax(mesh, world, jax_cases):
    for N in (64, 128):
        K = jax_cases[0][f"chol{N}"]["K"]
        np.testing.assert_allclose(world[f"{mesh}/chol{N}"], jax_cases[1][f"chol{N}"], rtol=RTOL, atol=1e-10)
        np.testing.assert_allclose(world[f"{mesh}/chol{N}"], np.linalg.cholesky(K), atol=1e-10)


def test_grid_on_one_rank_is_the_gpr():
    # a 1 x 1 mesh (no process group): the grid loss is the single-device
    # objective, value and gradient; the layout's errors
    rng = np.random.RandomState(1)
    X = rng.uniform(0, 1, (64, 1))
    m = gft.models.GPR(X, np.sin(6 * X), kern=gft.kernels.RBF(1, lengthscales=0.3), device="cpu")
    mesh = gft.parallel.make_mesh({"rows": 1, "cols": 1})
    loss = gft.parallel.make_grid_gpr_loss(m, mesh, block_size=16)(m)
    loss.backward()
    got = {n: t.grad.clone() for n, t in gft.params.trainable_leaves(m)}
    m.zero_grad()
    want = m.objective()
    want.backward()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-12)
    for n, t in gft.params.trainable_leaves(m):
        np.testing.assert_allclose(got[n].numpy(), t.grad.numpy(), rtol=1e-9, atol=1e-12, err_msg=n)
    K = torch.tensor(rng.randn(64, 64), dtype=torch.float64)
    K = K @ K.T + 64 * torch.eye(64, dtype=torch.float64)
    np.testing.assert_allclose(gft.parallel.grid_cholesky(K, mesh, block_size=16).numpy(),
                               np.linalg.cholesky(K.numpy()), atol=1e-10)
    with pytest.raises(ValueError, match="divisible"):
        gft.parallel.GridLayout(60, mesh, block_size=16)
    with pytest.raises(ValueError, match="must divide"):
        gft.parallel.GridLayout(48, gft.parallel.make_mesh({"rows": 4, "cols": 2}, devices=list(range(8))),
                                block_size=16)
