"""Parity of the port's ``io`` (the GFSB format, ``BinaryDataset`` on the
port's own native loader and on numpy's memmap) with the JAX package, on
the CPU: tests/test_io.py's cases on the port, files written by either
package read by the other, and SVGP training from disk through
``parallel.make_svgp_step``, step for step against the JAX package's Adam
step on the same batches in float64.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu import io as jio
from gpflow_slim_tpu_torch import io as tio
from gpflow_slim_tpu_torch.io import dataset as tdataset

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def dataset_file(tmp_path):
    rng = np.random.RandomState(0)
    data = rng.randn(500, 3).astype(np.float32)
    path = str(tmp_path / "data.gfsb")
    tio.write_gfsb(path, data)
    return path, data


def test_roundtrip_and_gather_native(dataset_file):
    path, data = dataset_file
    ds = tio.BinaryDataset(path)
    assert ds.native and (ds.rows, ds.cols) == (500, 3)
    idx = np.array([0, 7, 499, 3, 3])
    got = ds.gather(idx)
    assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(data[idx]))
    assert torch.equal(ds.gather(torch.tensor(idx)), got)
    with pytest.raises(IOError):
        ds.gather([500])  # out of range
    ds.close()
    ds.close()  # twice is harmless


def test_gather_fallback_matches_native(dataset_file):
    path, data = dataset_file
    ds_py = tio.BinaryDataset(path, use_native=False)
    ds_c = tio.BinaryDataset(path)
    assert not ds_py.native and (ds_py.rows, ds_py.cols) == (500, 3)
    idx = np.random.RandomState(1).randint(0, 500, 64)
    assert torch.equal(ds_py.gather(idx), torch.from_numpy(data[idx]))
    assert torch.equal(ds_py.gather(idx), ds_c.gather(idx))
    ds_c.close()


@pytest.mark.parametrize("native", [True, False])
def test_prefetch_pipeline_equivalence(dataset_file, native):
    path, data = dataset_file
    ds = tio.BinaryDataset(path, use_native=native)
    batches = list(ds.minibatches(torch.Generator().manual_seed(0), batch_size=32, num_batches=5))
    assert len(batches) == 5
    # replay the same draws synchronously and compare
    g = torch.Generator().manual_seed(0)
    for b in batches:
        idx = torch.randint(0, ds.rows, (32,), generator=g)
        assert torch.equal(b, ds.gather(idx)) and torch.equal(b, torch.from_numpy(data[idx.numpy()]))
    assert list(ds.minibatches(torch.Generator(), 8, 0)) == []
    for b in ds.minibatches(torch.Generator(), 8, 3):  # left after one batch: the pending read is dropped
        break
    ds.close()


def test_native_loader_compiled_under_build(dataset_file):
    path, _ = dataset_file
    ds = tio.BinaryDataset(path)
    assert ds.native, "native loader failed to build/load"
    so = tdataset.library_path()
    assert so.exists() and so.parent == REPO / "build" / "loader"
    assert tdataset.SOURCE == REPO / "gpflow_slim_tpu_torch" / "io" / "native" / "loader.c"
    # never under the JAX package's native directory
    assert REPO / "gpflow_slim_tpu" not in so.parents
    ds.close()


def test_native_loader_needs_a_compiler(dataset_file, tmp_path, monkeypatch):
    path, _ = dataset_file
    monkeypatch.setattr(tdataset, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tdataset, "COMPILERS", ("no-such-cc",))
    tdataset.load_native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no C compiler"):
            tio.BinaryDataset(path)
        assert not tio.BinaryDataset(path, use_native=False).native  # asked for, the memmap still reads
    finally:
        tdataset.load_native.cache_clear()


@pytest.mark.parametrize("native", [True, False])
def test_bad_magic_rejected(tmp_path, native):
    p = str(tmp_path / "junk.gfsb")
    with open(p, "wb") as f:
        f.write(b"NOPE" + b"\0" * 32)
    with pytest.raises(ValueError, match="not a GFSB file"):
        tio.BinaryDataset(p, use_native=native)
    with pytest.raises(ValueError, match="rank-2"):
        tio.write_gfsb(p, np.zeros(3))


def test_files_cross_packages(tmp_path):
    rng = np.random.RandomState(4)
    a, b = rng.randn(40, 5).astype(np.float32), rng.randn(33, 2).astype(np.float32)
    pt, pj = str(tmp_path / "port.gfsb"), str(tmp_path / "jax.gfsb")
    tio.write_gfsb(pt, torch.from_numpy(a))
    jio.write_gfsb(pj, b)
    assert open(pt, "rb").read() == open(jio.write_gfsb(str(tmp_path / "same.gfsb"), a), "rb").read()
    idx = np.array([0, 39, 5, 5])
    for native in (True, False):
        jds = jio.BinaryDataset(pt, use_native=native)
        np.testing.assert_array_equal(jds.gather(idx), a[idx])
        tds = tio.BinaryDataset(pj, use_native=native)
        assert (tds.rows, tds.cols) == (33, 2)
        assert torch.equal(tds.gather(idx[:3] % 33), torch.from_numpy(b[idx[:3] % 33]))
        for ds in (jds, tds):
            ds.close()


def test_svgp_training_from_disk(tmp_path):
    """tests/test_io.py's end-to-end case on the port: minibatches streamed
    from disk into ``make_svgp_step``; its first steps against the JAX
    package's Adam step on the same batches, then 60 steps lower the
    objective."""
    rng = np.random.RandomState(2)
    X = rng.uniform(0, 1, (500, 1)).astype(np.float32)
    Y = (np.sin(8 * X) > 0).astype(np.float32)
    path = str(tmp_path / "xy.gfsb")
    tio.write_gfsb(path, np.hstack([X, Y]))
    Z = np.linspace(0, 1, 8)[:, None]
    jm = gfs.models.SVGP(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.3), likelihood=gfs.likelihoods.Bernoulli(), Z=Z)
    m = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.3), likelihood=gft.likelihoods.Bernoulli(), Z=Z,
                        device="cpu", dtype=torch.float64)
    with torch.no_grad():
        before = m.objective().item()
    opt = optax.adam(0.05)
    mask = gfs.params.trainable_leaf_mask(jm)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    opt_state = opt.init(leaves)

    @jax.jit
    def jstep(leaves, opt_state, xb, yb):
        mm = jax.tree_util.tree_unflatten(treedef, leaves)
        loss, grads = jax.value_and_grad(lambda z: -(z.build_likelihood_batch(xb, yb) + z.log_prior()))(mm)
        g = [gr * t for gr, t in zip(jax.tree_util.tree_leaves(grads), mask)]
        upd, opt_state = opt.update(g, opt_state, leaves)
        upd = [u * t for u, t in zip(upd, mask)]
        return [lf + u for lf, u in zip(leaves, upd)], opt_state, loss

    step, _ = gft.parallel.make_svgp_step(m, lambda ps: torch.optim.Adam(ps, lr=0.05))
    ds = tio.BinaryDataset(path)
    for t, batch in enumerate(ds.minibatches(torch.Generator().manual_seed(0), batch_size=128, num_batches=60)):
        xb, yb = batch[:, :1], batch[:, 1:]
        loss = step(batch=(xb, yb))
        if t < 5:
            leaves, opt_state, jloss = jstep(leaves, opt_state, jnp.asarray(xb.numpy(), jnp.float64),
                                             jnp.asarray(yb.numpy(), jnp.float64))
            # at the whitened start Z's and the lengthscale's gradients are
            # 0 here and rounding (~1e-17) there, which Adam divides by its
            # eps of 1e-8: the trajectories part by ~1e-10 from step 1
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-8 if t else 1e-12)
    ds.close()
    with torch.no_grad():
        assert m.objective().item() < before - 10
