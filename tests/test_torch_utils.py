"""Parity of the port's ``utils`` (checkpoints, metrics logging, the
determinism check, ``print_summary``, ``debug_nans``, ``named_scope``) and
``likelihoods.inv_probit`` with the JAX package, on the CPU in float64:
tests/test_utils_deep.py's cases on the port, each result beside the JAX
package's on the same numpy inputs. Checkpoints carry modules (models and
``posterior()`` caches), ``torch.optim`` state, ``torch.Generator``s,
tensors and plain numbers; a resumed Adam run equals an uninterrupted one
bit for bit.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu import utils as jutils
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu_torch import utils

torch.set_num_threads(2)


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


def _gpr_data(n=20, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 1), rng.randn(n, 1)


def _gpr(X, Y, **kw):
    return gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, **kw), device="cpu", dtype=torch.float64)


def test_checkpoint_roundtrip_model(tmp_path):
    X, Y = _gpr_data()
    jm1, _ = gfs.training.fit(gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1)), num_steps=30, learning_rate=0.05)
    m1, _ = gft.training.fit(_gpr(X, Y), num_steps=30, learning_rate=0.05)
    path = utils.save_checkpoint(str(tmp_path / "ckpt"), m1, step=30)
    assert path.endswith("-30") and not os.path.exists(path + ".tmp")
    m2 = utils.load_checkpoint(path, _gpr(X, Y, lengthscales=3.0))  # the template: an untrained model
    with torch.no_grad():
        assert m2.objective().item() == m1.objective().item()
        np.testing.assert_allclose(m2.objective().item(), float(jm1.objective()), rtol=1e-10)
    assert utils.latest_checkpoint(str(tmp_path / "ckpt")) == path


def _posterior_pair(kind):
    """A trained-looking model in both packages and a model of the same
    shapes at another point (the template's source)."""
    rng = np.random.RandomState(1)
    X = rng.uniform(0, 1, (30, 1))
    Y = np.sin(8 * X) + 0.1 * rng.randn(30, 1)
    Z = np.linspace(0, 1, 6)[:, None]

    def make(pkg, ls, **kw):
        kern = pkg.kernels.RBF(1, lengthscales=ls)
        if kind == "gpr":
            return pkg.models.GPR(X, Y, kern=kern, **kw)
        if kind == "sgpr":
            return pkg.models.SGPR(X, Y, kern=kern, Z=Z, **kw)
        return pkg.models.SVGP(X, Y, kern=kern, likelihood=pkg.likelihoods.Gaussian(), Z=Z, **kw)

    jm = make(gfs, 0.2)
    if kind == "svgp":  # a q away from its initialisation
        jm.q_mu = gfs.params.Param(rng.randn(6, 1), name="q_mu")
    kw = dict(device="cpu", dtype=torch.float64)
    tm = make(gft, 0.2, **kw)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    return jm, tm, make(gft, 1.0, **kw)


@pytest.mark.parametrize("kind", ["gpr", "sgpr", "svgp"])
def test_checkpoint_roundtrip_posterior(kind, tmp_path):
    # example 07's flow: posterior() -> save -> load into a template
    # posterior of a fresh model of the same shapes -> serve
    jm, tm, fresh = _posterior_pair(kind)
    Xq = np.linspace(-0.1, 1.1, 17)[:, None]
    with torch.no_grad():
        post = tm.posterior()
        path = utils.save_checkpoint(str(tmp_path / "post"), post)
        template = fresh.posterior()
        restored = utils.load_checkpoint(path, template)
        assert restored is template
        for full_cov in (False, True):
            want = post.predict_f(Xq, full_cov=full_cov)
            got = restored.predict_f(Xq, full_cov=full_cov)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    jmu, jvar = jm.posterior().predict_f(jnp.asarray(Xq))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jmu), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(torch.diagonal(got[1], dim1=-2, dim2=-1).T.numpy(), np.asarray(jvar), rtol=1e-9,
                               atol=1e-10)


def test_checkpoint_opt_state_and_rng(tmp_path):
    X, Y = _gpr_data(15)
    m = _gpr(X, Y)
    step, opt = gft.training.make_step_fn(m, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    step()
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    state = {"model": m, "opt": opt, "rng": gen, "step": 7, "lr": (1e-2, [0.9, 0.999]), "note": "adam",
             "t": torch.arange(3.0)}
    p = utils.save_checkpoint(str(tmp_path / "train_state"), state)
    m2 = _gpr(X, Y, lengthscales=2.0)
    _, opt2 = gft.training.make_step_fn(m2, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    gen2 = torch.Generator().manual_seed(99)
    t2 = torch.zeros(3)
    restored = utils.load_checkpoint(p, {"model": m2, "opt": opt2, "rng": gen2, "step": 0, "lr": (0.0, [0.0, 0.0]),
                                         "note": "", "t": t2})
    assert restored["step"] == 7 and restored["note"] == "adam" and restored["lr"] == (1e-2, [0.9, 0.999])
    assert restored["model"] is m2 and restored["rng"] is gen2 and restored["t"] is t2
    assert torch.equal(t2, torch.arange(3.0))
    for (_, a), (_, b) in zip(gft.params.trainable_leaves(m), gft.params.trainable_leaves(m2)):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(5, generator=gen2), torch.rand(5, generator=gen))
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="keys"):
        utils.load_checkpoint(p, {"model": m2})


def test_training_resume_from_checkpoint_bit_identical(tmp_path):
    """tests/test_utils_deep.py's recovery story on the port: 40 steps
    straight against 20, a checkpoint of the model and Adam's state, a
    'restart' into fresh objects, and 20 more: identical bits; both equal
    the JAX package's 40 optax steps."""
    X, Y = _gpr_data(25)

    def adam(ps):
        return torch.optim.Adam(ps, lr=0.05)

    m1 = _gpr(X, Y)
    step1, _ = gft.training.make_step_fn(m1, adam)
    for _ in range(40):
        step1()
    m2 = _gpr(X, Y)
    step2, opt2 = gft.training.make_step_fn(m2, adam)
    for _ in range(20):
        step2()
    p = utils.save_checkpoint(str(tmp_path / "train"), {"model": m2, "opt": opt2}, step=20)
    m3 = _gpr(X, Y, lengthscales=5.0)
    step3, opt3 = gft.training.make_step_fn(m3, adam)
    utils.load_checkpoint(p, {"model": m3, "opt": opt3})
    for _ in range(20):
        step3()
    for (n, a), (_, b) in zip(gft.params.trainable_leaves(m1), gft.params.trainable_leaves(m3)):
        assert torch.equal(a, b), n
    jm = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1))
    step_fn, (leaves, treedef, opt_state) = gfs.training.optimize.make_step_fn(jm, optax.adam(0.05))
    step_jit = jax.jit(step_fn)
    for _ in range(40):
        leaves, opt_state, _ = step_jit(leaves, opt_state)
    want = gft.interop.port_arrays(m1, _unconstrained(jax.tree_util.tree_unflatten(treedef, leaves)))
    for n, t in gft.params.trainable_leaves(m3):
        np.testing.assert_allclose(t.detach().numpy(), want[n], rtol=1e-9, err_msg=n)


def test_latest_checkpoint(tmp_path):
    base = str(tmp_path / "run" / "ckpt")
    assert utils.latest_checkpoint(base) is None
    t = {"x": torch.ones(2)}
    utils.save_checkpoint(base, t)
    assert utils.latest_checkpoint(base) == jutils.latest_checkpoint(base) == base
    for step in (5, 40, 7):
        utils.save_checkpoint(base, t, step=step)
    open(base + "-99.tmp", "w").close()  # a torn write is never a checkpoint
    open(base + "-x", "w").close()
    assert utils.latest_checkpoint(base) == jutils.latest_checkpoint(base) == f"{base}-40"


@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
def test_metrics_logger(fmt, tmp_path):
    path = str(tmp_path / f"metrics.{fmt}")
    rows = [dict(loss=1.5, acc=np.float32(0.5)), dict(loss=torch.tensor(1.2, dtype=torch.float64), acc=0.6)]
    for i, (cls, mod) in enumerate(((utils.MetricsLogger, torch), (jutils.MetricsLogger, jnp))):
        with cls(path + str(i), fmt=fmt) as log:
            for step, r in enumerate(rows):
                log.log(step, **{k: (jnp.asarray(np.asarray(v)) if mod is jnp and isinstance(v, torch.Tensor)
                                     else v) for k, v in r.items()})
    with utils.MetricsLogger(path + "0", fmt=fmt) as log:  # appends, no second header
        log.log(2, loss=torch.tensor([1.0, 2.0]), acc=0.7)
    if fmt == "jsonl":
        got = [json.loads(line) for line in open(path + "0")]
        want = [json.loads(line) for line in open(path + "1")]
        assert got[0]["loss"] == 1.5 and got[1]["step"] == 1 and got[2]["loss"] == [1.0, 2.0]
    else:
        got = [line.split(",") for line in open(path + "0").read().splitlines()]
        want = [line.split(",") for line in open(path + "1").read().splitlines()]
        assert got[0] == ["step", "time", "loss", "acc"] and len(got) == 4
    for g, w in zip(got[:2], want[:2]):  # the same rows but for the clock
        if fmt == "jsonl":
            g.pop("time"), w.pop("time")
        else:
            g.pop(1), w.pop(1)
        assert g == w
    with pytest.raises(ValueError):
        utils.MetricsLogger(path, fmt="xml")


def test_determinism_check():
    X, Y = _gpr_data(12)
    m = _gpr(X, Y)
    jm = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1))
    with torch.no_grad():
        assert utils.check_determinism(lambda: m.objective())
        assert utils.check_determinism(lambda: (m.predict_f(X), {"o": m.objective(), "n": 3}), reps=3)
        assert not utils.check_determinism(lambda: torch.rand(3))
        calls = []
        assert not utils.check_determinism(lambda: calls.append(1) or len(calls))
        assert utils.check_determinism(lambda: torch.tensor(float("nan")))  # the same bits
    assert jutils.check_determinism(jax.jit(lambda mm: mm.objective()), jm)


def _summary_rows(text):
    """The table's rows as column lists, cut at the header's column starts."""
    lines = text.splitlines()
    starts = [lines[0].index(h) for h in ("name", "transform", "prior", "trainable", "shape", "value")]
    return [[line[a:b].strip() for a, b in zip(starts, starts[1:] + [None])] for line in lines[2:]]


@pytest.mark.parametrize("kind", ["sum_with_prior", "deep"])
def test_print_summary_matches_jax(kind, capsys):
    from gpflow_slim_tpu.kernels_deep import DeepKernel as JDeep
    from gpflow_slim_tpu.kernels_deep import mlp_warp as jmlp

    X, Y = _gpr_data(10)
    if kind == "deep":
        fn, params = jmlp(jax.random.PRNGKey(0), [1, 4, 1])
        jk = JDeep(1, gfs.kernels.RBF(1, lengthscales=0.5), fn, params)
        tk = gft.kernels_deep.DeepKernel(1, gft.kernels.RBF(1, lengthscales=0.5), gft.kernels_deep.mlp_warp([1, 4, 1]))
    else:
        jk, tk = (pkg.kernels.RBF(1, lengthscales=0.3) + pkg.kernels.Matern32(1, variance=0.7) for pkg in (gfs, gft))
        for pkg, k in ((gfs, jk), (gft, tk)):
            k.kernels[1].lengthscales = pkg.params.Param(
                0.2, transform=pkg.transforms.positive(), prior=pkg.priors.Gamma(2.0, 3.0), name="ls", trainable=False,
                **({} if pkg is gfs else {"dtype": torch.float64}))
    jm = gfs.models.GPR(X, Y, kern=jk)
    tm = gft.models.GPR(X, Y, kern=tk, device="cpu", dtype=torch.float64)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    got = _summary_rows(utils.print_summary(tm))
    want = _summary_rows(jutils.print_summary(jm))
    assert capsys.readouterr().out.count("transform") == 2  # each printed its table
    for row in want:
        row[0] = gft.interop.port_name(row[0])
    assert got == want


def test_debug_nans_and_named_scope():
    assert not torch.is_anomaly_enabled()
    x = torch.tensor([0.0], requires_grad=True)
    with utils.debug_nans():
        assert torch.is_anomaly_enabled()
        # the forward's traceback comes as a warning, then the backward raises
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(UserWarning, match="Error detected"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    assert not torch.is_anomaly_enabled()
    with utils.debug_nans(False):
        assert not torch.is_anomaly_enabled()
    # spans are recorded while the program's tracing is on, and only then
    for on in (False, True):
        with utils.trace.traced() if on else contextlib.nullcontext(), torch.profiler.profile() as prof:
            with utils.named_scope("gram_panel"):
                torch.ones(3) @ torch.ones(3)
        assert any(e.name == "gram_panel" for e in prof.events()) == on


def test_inv_probit_matches_jax():
    x = np.linspace(-6, 6, 41)
    got = gft.likelihoods.inv_probit(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(gfs.likelihoods.inv_probit(jnp.asarray(x))), rtol=1e-14)
    assert torch.equal(got, gft.likelihoods.probit(torch.tensor(x)))
    assert gft.likelihoods.inv_probit is not gft.likelihoods.probit  # Bernoulli takes its quadrature path
    # a Bernoulli on it predicts by quadrature, as JAX's does
    Fmu, Fvar = np.array([[0.3], [-1.0]]), np.array([[0.5], [2.0]])
    jl = gfs.likelihoods.Bernoulli(invlink=gfs.likelihoods.inv_probit)
    tl = gft.likelihoods.Bernoulli(invlink=gft.likelihoods.inv_probit)
    for a, b in zip(tl.predict_mean_and_var(torch.tensor(Fmu), torch.tensor(Fvar)),
                    jl.predict_mean_and_var(jnp.asarray(Fmu), jnp.asarray(Fvar))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
