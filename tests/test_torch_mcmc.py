"""Parity of the port's MCMC slice (gpflow_slim_tpu_torch.mcmc, .parallel,
models.GPMC and models.SGPMC) with the JAX package, on the CPU in float64.

The same numpy arrays go to both packages: the flat-vector layout of
``pack_trainable``; ``model_logprob``'s value and gradient on GPR (BASELINE
config #4's model at N=40), GPMC and SGPMC, and their predictions; dual
averaging, Welford, ``warmup_schedule``, ``_is_turning``, popcount and
trailing ones; the leapfrog and an HMC trajectory; ``_build_subtree``'s
deterministic fields in both directions at depths 0-5, a NaN leaf
included; the diagnostics. On the port alone: the batched evaluation
equals a loop of autograd calls, and a warmup window split into chunks
gives the draws of one call. The draws' random streams are the port's
own (a ``torch.Generator`` in place of the JAX key), so no test compares
them across the packages. Model cases run on both of the port's routes
(the ``route`` fixture), the kernel route through the kernels' plain
versions and each ``ops`` Function's ``vmap`` rule.
"""

import functools
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import route  # noqa: F401  (a fixture)

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.mcmc import base as jbase
from gpflow_slim_tpu.mcmc import diagnostics as jdiag
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu_torch.mcmc import base as tbase

# the packages' mcmc/__init__ export the functions hmc and nuts under the
# names of their modules
jnuts = importlib.import_module("gpflow_slim_tpu.mcmc.nuts")
thmc = importlib.import_module("gpflow_slim_tpu_torch.mcmc.hmc")
tnuts = importlib.import_module("gpflow_slim_tpu_torch.mcmc.nuts")

LOGPROB_RTOL = 1e-10    # the same f64 formula, different BLAS
TRAJECTORY_RTOL = 1e-12  # leapfrog arithmetic on a closed-form target


@pytest.fixture(autouse=True)
def one_thread():
    # the samplers issue many tiny ops, for which a thread pool only adds
    # its wake-up cost
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


def _config4(pkg, X, Y, **kw):
    """benchmarks/bench_svgp_nuts.py bench_nuts's model (BASELINE config #4)."""
    k = pkg.kernels.RBF(1, lengthscales=0.3)
    k.variance = pkg.params.Param(1.0, transform=pkg.transforms.positive(),
                                  prior=pkg.priors.LogNormal(0.0, 1.0), name="v", **kw)
    k.lengthscales = pkg.params.Param(0.3, transform=pkg.transforms.positive(),
                                      prior=pkg.priors.LogNormal(-1.0, 1.0), name="l", **kw)
    m = pkg.models.GPR(X, Y, kern=k, **({"device": "cpu", "dtype": torch.float64} if kw else {}))
    m.likelihood.variance = pkg.params.Param(0.05, transform=pkg.transforms.positive(),
                                             prior=pkg.priors.LogNormal(-2.0, 1.0), name="n", **kw)
    return m


def _model_pair(name):
    """The same model in both packages at the same unconstrained point."""
    rng = np.random.RandomState(7)
    if name == "gpr":
        X = rng.uniform(0, 1, (40, 1))
        Y = np.sin(6 * X) + 0.2 * rng.randn(40, 1)
        jm = _config4(gfs, X, Y)
        tm = _config4(gft, X, Y, dtype=torch.float64)
    else:
        N = 25 if name == "gpmc" else 30
        X = rng.uniform(-1, 1, (N, 1))
        Y = (np.sin(3 * X) > 0).astype(float)
        if name == "gpmc":
            jm = gfs.models.GPMC(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.5),
                                 likelihood=gfs.likelihoods.Bernoulli())
            tm = gft.models.GPMC(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.5),
                                 likelihood=gft.likelihoods.Bernoulli(), device="cpu", dtype=torch.float64)
        else:
            Z = np.linspace(-1, 1, 7)[:, None]
            jm = gfs.models.SGPMC(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.5),
                                  likelihood=gfs.likelihoods.Bernoulli(), Z=Z)
            tm = gft.models.SGPMC(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.5),
                                  likelihood=gft.likelihoods.Bernoulli(), Z=Z, device="cpu", dtype=torch.float64)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    return jm, tm


def test_pack_trainable_layout_matches_jax():
    # a Sum kernel (list-index names), a non-trainable Param left out
    X = np.random.RandomState(0).uniform(0, 1, (10, 1))
    Y = np.sin(6 * X)
    jk = gfs.kernels.RBF(1, lengthscales=0.3) + gfs.kernels.Matern32(1, variance=0.7, lengthscales=0.2)
    tk = gft.kernels.RBF(1, lengthscales=0.3) + gft.kernels.Matern32(1, variance=0.7, lengthscales=0.2)
    jm = gfs.models.GPR(X, Y, kern=jk)
    tm = gft.models.GPR(X, Y, kern=tk, device="cpu", dtype=torch.float64)
    jm.kern.kernels[1].variance.trainable = False
    tm.kern.kernels[1].variance.trainable = False
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    jvec, _ = gfs.params.pack_trainable(jm)
    tvec, unpack = gft.params.pack_trainable(tm)
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    names = [f"{gft.interop.port_name(n)}.unconstrained" for n, p in jax_parameters(jm) if p.trainable]
    assert list(unpack(tvec)) == names
    assert "kern.kernels.0.variance.unconstrained" in names
    assert "kern.kernels.1.variance.unconstrained" not in names
    assert all(torch.equal(t, tm.get_parameter(n)) for n, t in gft.params.unpack_trainable(tm, tvec).items())


@pytest.mark.parametrize("name", ["gpr", "gpmc", "sgpmc"])
def test_model_logprob_value_and_grad_match_jax(name, route):
    jm, tm = _model_pair(name)
    jlp, jx0, _ = gfs.mcmc.model_logprob(jm)
    tlp, tx0, _ = gft.mcmc.model_logprob(tm)
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))
    v = np.asarray(jx0) + 0.3 * np.random.RandomState(3).randn(jx0.shape[0])
    jval, jgrad = jax.value_and_grad(jlp)(jnp.asarray(v))
    lp, g = tbase.batched_value_and_grad(tlp)(_t(v)[None])
    np.testing.assert_allclose(lp.numpy()[0], float(jval), rtol=LOGPROB_RTOL)
    np.testing.assert_allclose(g.numpy()[0], np.asarray(jgrad), rtol=LOGPROB_RTOL,
                               atol=LOGPROB_RTOL * np.abs(np.asarray(jgrad)).max())
    # the model's own parameters are untouched
    np.testing.assert_array_equal(gft.params.pack_trainable(tm)[0].numpy(), np.asarray(jx0))


def _warped_pair(kind):
    """A GPR in both packages on a kernel with leaves beyond plain Params:
    ``DeepKernel(1, RBF, mlp_warp([1, 4, 1]))``, example 05's deep kernel
    (``mlp_warp([2, 16, 1])``, narrower data), or example 06's NKN."""
    from gpflow_slim_tpu.kernels_deep import DeepKernel as JDeep
    from gpflow_slim_tpu.kernels_deep import mlp_warp as jmlp
    from gpflow_slim_tpu.kernels_nkn import NKN as JNKN
    from gpflow_slim_tpu.kernels_nkn import NKNLinear as JLinear
    from gpflow_slim_tpu.kernels_nkn import NKNProduct as JProduct
    from gpflow_slim_tpu_torch.kernels_nkn import NKN, NKNLinear, NKNProduct

    rng = np.random.RandomState(5)
    if kind == "nkn":
        X = rng.uniform(0, 2, (24, 1))
        kerns = []
        for pkg, lin, prod, nkn in ((gfs, JLinear, JProduct, JNKN), (gft, NKNLinear, NKNProduct, NKN)):
            prims = [pkg.kernels.RBF(1, lengthscales=0.5, name="p_rbf"),
                     pkg.kernels.Periodic(1, period=0.7, name="p_per"), pkg.kernels.Linear(1, name="p_lin"),
                     pkg.kernels.Matern32(1, lengthscales=1.0, name="p_mat")]
            kerns.append(nkn(1, prims, [lin(4, 4, name="l0"), prod(4, 2, name="l1"), lin(2, 1, name="l2")]))
        jk, tk = kerns
    else:
        sizes = [1, 4, 1] if kind == "deep_1_4_1" else [2, 16, 1]
        X = rng.uniform(-1, 1, (24, sizes[0]))
        fn, params = jmlp(jax.random.PRNGKey(0), sizes)
        jk = JDeep(sizes[0], gfs.kernels.RBF(1, lengthscales=0.5), fn, params)
        tk = gft.kernels_deep.DeepKernel(sizes[0], gft.kernels.RBF(1, lengthscales=0.5),
                                         gft.kernels_deep.mlp_warp(sizes))
    Y = np.sin(3 * X[:, :1]) + 0.1 * rng.randn(len(X), 1)
    jm = gfs.models.GPR(X, Y, kern=jk)
    tm = gft.models.GPR(X, Y, kern=tk, device="cpu", dtype=torch.float64)
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    return jm, tm


@pytest.mark.parametrize("kind", ["deep_1_4_1", "deep_example05", "nkn"])
def test_model_logprob_packs_every_trainable_leaf(kind, route):
    # fault n: the vector holds every leaf JAX's pack_trainable packs (a
    # DeepKernel's warp, W as JAX lays it out), in its order, and nothing
    # but what the optimizers train
    jm, tm = _warped_pair(kind)
    jlp, jx0, _ = gfs.mcmc.model_logprob(jm)
    tlp, tx0, unpack = gft.mcmc.model_logprob(tm)
    if kind == "deep_1_4_1":
        assert tx0.shape == jx0.shape == (16,)
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))
    assert sorted(unpack(tx0)) == sorted(
        n if n.startswith("kern.warp.") else f"{n}.unconstrained" for n, _ in gft.params.trainable_leaves(tm))
    v = np.asarray(jx0) + 0.1 * np.random.RandomState(3).randn(jx0.shape[0])
    jval, jgrad = jax.value_and_grad(jlp)(jnp.asarray(v))
    lp, g = tbase.batched_value_and_grad(tlp)(_t(v)[None])
    assert not lp.requires_grad  # no leaf outside the vector reaches the value
    np.testing.assert_allclose(lp.numpy()[0], float(jval), rtol=LOGPROB_RTOL)
    np.testing.assert_allclose(g.numpy()[0], np.asarray(jgrad), rtol=1e-9,
                               atol=1e-10 * np.abs(np.asarray(jgrad)).max())
    # unpack round-trips the model's own tensors (a warp weight transposed
    # back), under vmap too
    for n, t in unpack(tx0).items():
        assert torch.equal(t, tm.get_parameter(n))
    rows = torch.func.vmap(lambda z: unpack(z)["kern.warp.layers.0.weight" if kind != "nkn"
                                                else "kern.layers.0.weights.unconstrained"])(
        torch.stack([tx0, 2 * tx0]))
    name = "kern.warp.layers.0.weight" if kind != "nkn" else "kern.layers.0.weights.unconstrained"
    assert torch.equal(rows[1], 2 * tm.get_parameter(name))


@pytest.mark.parametrize("name", ["gpr", "gpmc", "sgpmc"])
def test_batched_logprob_equals_autograd_loop(name, route):
    _, tm = _model_pair(name)
    lp, x0, unpack = gft.mcmc.model_logprob(tm)
    vs = x0[None] + 0.2 * _t(np.random.RandomState(4).randn(4, x0.shape[0]))
    got_lp, got_g = tbase.batched_value_and_grad(lp)(vs)
    for c in range(vs.shape[0]):
        with torch.no_grad():
            for n, t in unpack(vs[c]).items():
                tm.get_parameter(n).copy_(t)
        tm.zero_grad(set_to_none=True)
        want = tm.log_posterior()
        want.backward()
        want_g = torch.cat([tm.get_parameter(n).grad.reshape(-1) for n in unpack(vs[c])])
        np.testing.assert_allclose(got_lp[c].item(), want.item(), rtol=1e-12)
        np.testing.assert_allclose(got_g[c].numpy(), want_g.numpy(), rtol=1e-11,
                                   atol=1e-12 * want_g.abs().max().item())


@pytest.mark.parametrize("name", ["gpmc", "sgpmc"])
@pytest.mark.parametrize("full_cov", [False, True])
def test_mc_model_predictions_match_jax(name, full_cov, route):
    jm, tm = _model_pair(name)
    # latents away from zero, the same in both
    V = 0.5 * np.random.RandomState(5).randn(*np.shape(jm.V.value))
    jm = gfs.params.tree_at(lambda m: m.V, jm, gfs.params.Param(V, prior=jm.V.prior, name="V"))
    gft.interop.load_unconstrained(tm, _unconstrained(jm))
    Xq = np.linspace(-1.2, 1.2, 9)[:, None]
    jmu, jvar = jm.predict_f_full_cov(Xq) if full_cov else jm.predict_f(Xq)
    with torch.no_grad():
        mu, var = tm.predict_f_full_cov(Xq) if full_cov else tm.predict_f(Xq)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-10, atol=1e-10)


def test_dual_averaging_and_welford_match_jax():
    rng = np.random.RandomState(1)
    accepts = rng.uniform(0, 1, (40, 3))
    xs = rng.randn(40, 3, 2)
    jda = jax.vmap(jbase.da_init)(jnp.asarray([0.1, 0.5, 1e-3]))
    tda = tbase.da_init(_t([0.1, 0.5, 1e-3]))
    jw = jax.vmap(lambda _: jbase.welford_init(2, jnp.float64))(jnp.arange(3))
    tw = tbase.welford_init(torch.zeros(3, 2, dtype=torch.float64))
    jupd = jax.vmap(jbase.da_update)
    jwu = jax.vmap(jbase.welford_update)
    for a, x in zip(accepts, xs):
        jda, tda = jupd(jda, jnp.asarray(a)), tbase.da_update(tda, _t(a))
        jw, tw = jwu(jw, jnp.asarray(x)), tbase.welford_update(tw, _t(x))
        for f in jda._fields:
            np.testing.assert_allclose(getattr(tda, f).numpy(), np.asarray(getattr(jda, f)), rtol=1e-14, err_msg=f)
        for f in jw._fields:
            np.testing.assert_allclose(getattr(tw, f).numpy(), np.asarray(getattr(jw, f)), rtol=1e-14, err_msg=f)
    for reg in (True, False):
        np.testing.assert_allclose(tbase.welford_variance(tw, reg).numpy(),
                                   np.asarray(jax.vmap(lambda w: jbase.welford_variance(w, reg))(jw)), rtol=1e-14)


@pytest.mark.parametrize("num_warmup", [0, 10, 19, 20, 100, 150, 300, 1000])
def test_warmup_schedule_matches_jax(num_warmup):
    assert tnuts.warmup_schedule(num_warmup) == jnuts.warmup_schedule(num_warmup)


def test_popcount_trailing_ones_and_is_turning_match_jax():
    xs = np.arange(4096, dtype=np.int32)
    assert [tnuts._popcount(int(x)) for x in xs] == np.asarray(jnuts._popcount(jnp.asarray(xs))).tolist()
    assert [tnuts._trailing_ones(int(x)) for x in xs] == \
        np.asarray(jnuts._trailing_ones(jnp.asarray(xs))).tolist()
    rng = np.random.RandomState(2)
    a = [rng.randn(64, 3) for _ in range(5)]
    a[4] = np.abs(a[4]) + 0.1
    want = jax.vmap(jnuts._is_turning)(*map(jnp.asarray, a))
    got = tnuts._is_turning(*map(_t, a))
    assert got.numpy().tolist() == np.asarray(want).tolist()
    assert 0 < got.sum() < 64


# closed-form targets of one definition in both packages: a correlated
# Gaussian, and a standard normal behind a NaN wall at |x0| = 2 (an f32
# GP target gives NaN where a proposal does not factor)
_PREC = np.array([[1.3, 0.4, 0.0], [0.4, 0.9, -0.2], [0.0, -0.2, 2.0]])


def _gauss(xp, x):
    d = x - xp.asarray([0.5, -1.0, 2.0])
    return -0.5 * d @ xp.asarray(_PREC) @ d + 0.1 * xp.sin(x[0])


def _wall(xp, x):
    base = -0.5 * xp.sum(x ** 2)
    return xp.where(xp.abs(x[0]) < 2.0, base, xp.asarray(float("nan")))


_TARGETS = {"gauss": _gauss, "nan_wall": _wall}
_JVG = {k: jax.jit(jax.value_and_grad(functools.partial(f, jnp))) for k, f in _TARGETS.items()}


def _tvg(name):
    return tbase.batched_value_and_grad(functools.partial(_TARGETS[name], torch))


def test_leapfrog_and_hmc_trajectory_match_jax():
    rng = np.random.RandomState(6)
    z, r = rng.randn(4, 3), rng.randn(4, 3)
    inv_mass = rng.uniform(0.5, 2.0, (4, 3))
    eps = np.array([0.1, -0.2, 0.05, 0.3])
    tvg = _tvg("gauss")
    lp, g = tvg(_t(z))
    got = tbase.leapfrog(tvg, _t(z), _t(r), g, _t(eps)[:, None], _t(inv_mass))
    # an HMC trajectory: L leapfrogs of each chain (its own L) from (z, r)
    L = [3, 7, 1, 5]
    traj = thmc._integrate(tvg, _t(z), _t(r), lp, g, _t(eps), torch.tensor(L), _t(inv_mass))
    for c in range(4):
        jl, jg = _JVG["gauss"](jnp.asarray(z[c]))
        want = jbase.leapfrog(_JVG["gauss"], jnp.asarray(z[c]), jnp.asarray(r[c]), jg, eps[c],
                              jnp.asarray(inv_mass[c]))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[c].numpy(), np.asarray(b), rtol=TRAJECTORY_RTOL)
        state = (jnp.asarray(z[c]), jnp.asarray(r[c]), jl, jg)
        state = jax.lax.fori_loop(0, L[c], lambda i, s: jbase.leapfrog(_JVG["gauss"], s[0], s[1], s[3], eps[c],
                                                                       jnp.asarray(inv_mass[c])), state)
        for a, b in zip(traj, state):
            np.testing.assert_allclose(a[c].numpy(), np.asarray(b), rtol=TRAJECTORY_RTOL)


_jax_subtree = jax.jit(jnuts._build_subtree, static_argnums=(0, 10))


@pytest.mark.parametrize("target", ["gauss", "nan_wall"])
@pytest.mark.parametrize("depth", range(6))
def test_build_subtree_matches_jax(target, depth):
    # chains 0/1 forward/backward from one state; chains 2/3 from another
    # (nan_wall: chain 0 reaches the wall at its first leaf, chain 1 at
    # its fourth)
    rng = np.random.RandomState(depth)
    z0 = np.array([[1.2, 0.3, -0.5]] * 2 + [[0.4, -0.8, 1.5]] * 2)
    r0 = np.array([[2.5, -0.4, 0.2]] * 2 + list(rng.randn(2, 3)))
    direction = np.array([1.0, -1.0, 1.0, -1.0])
    eps = np.array([0.35, 0.35, 0.2, 0.25])
    inv_mass = np.array([[1.0, 0.8, 1.2]] * 4)
    tvg, jvg = _tvg(target), _JVG[target]
    lp0, g0 = tvg(_t(z0))
    H0 = lp0 - tbase.kinetic_energy(_t(r0), _t(inv_mass))
    got = tnuts._build_subtree(tvg, _t(z0), _t(r0), g0, depth, _t(direction), _t(eps), _t(inv_mass), H0,
                               torch.Generator().manual_seed(0))
    fields = ("z", "r", "grad", "log_weight", "turning", "diverging", "sum_accept", "leaves_done")
    for c in range(4):
        want = _jax_subtree(jvg, jnp.asarray(z0[c]), jnp.asarray(r0[c]), jnp.asarray(g0[c].numpy()),
                            jnp.int32(depth), direction[c], eps[c], jnp.asarray(inv_mass[c]),
                            jnp.asarray(H0[c].item()), jax.random.PRNGKey(c), 6)
        for f in fields:
            a, b = getattr(got, f)[c].numpy(), np.asarray(getattr(want, f))
            if a.dtype == bool or f == "leaves_done":
                assert a.tolist() == b.tolist(), (c, f, a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=TRAJECTORY_RTOL, atol=1e-14, err_msg=f"chain {c}: {f}")
    if target == "nan_wall":
        assert bool(got.diverging[0]), "the forward chain should have reached the NaN wall"


class _JaxDraws:
    """The port's ``torch.rand``/``torch.randn`` replaced by the uniforms and
    normals the JAX package's NUTS draws from its keys, so that both
    packages' samplers follow one random stream. ``key_of(c, t)`` is chain
    ``c``'s key of its ``t``-th transition; each call is told apart by its
    caller's frame: the momentum (``randn``) opens a transition, a draw in
    ``_build_subtree`` is leaf ``i``'s switch of doubling ``depth``, and in
    ``_nuts_transition`` the first draw of doubling ``d`` picks the
    direction, the second the subtree."""

    def __init__(self, key_of, chains, transitions, dim, max_depth):
        keys = jnp.stack([jnp.stack([key_of(c, t) for t in range(transitions)]) for c in range(chains)])
        table = jax.jit(jax.vmap(jax.vmap(functools.partial(self._table, dim=dim, max_depth=max_depth))))(keys)
        self.r0, self.fwd, self.take, self.leaf = (torch.from_numpy(np.array(a)) for a in table)
        self.t, self.calls = -1, {}

    @staticmethod
    def _table(key, dim, max_depth):
        k_mom, key = jax.random.split(key)
        r0 = jax.random.normal(k_mom, (dim,), jnp.float64)
        fwd, take, leaf = [], [], []
        for _ in range(max_depth):
            key, k_dir, k_sub, k_accept = jax.random.split(key, 4)
            fwd.append(jax.random.bernoulli(k_dir))
            take.append(jax.random.uniform(k_accept, (), jnp.float64))

            def step(k, _):
                k, k_acc = jax.random.split(k)
                return k, jax.random.uniform(k_acc, (), jnp.float64)

            leaf.append(jax.lax.scan(step, k_sub, None, length=1 << (max_depth - 1))[1])
        return r0, jnp.stack(fwd), jnp.stack(take), jnp.stack(leaf)

    def randn(self, shape, **kw):
        self.t += 1
        return self.r0[:, self.t].clone()

    def rand(self, n, **kw):
        f = sys._getframe(1)
        if f.f_code.co_name == "_build_subtree":
            return self.leaf[:, self.t, f.f_locals["depth"], f.f_locals["i"]].clone()
        d = f.f_locals["d"]
        k = self.calls[self.t, d] = self.calls.get((self.t, d), -1) + 1
        if k == 0:
            return torch.where(self.fwd[:, self.t, d], 0.25, 0.75).to(torch.float64)  # direction = u < 0.5
        return self.take[:, self.t, d].clone()

    def __getattr__(self, name):
        return getattr(torch, name)


def test_nuts_matches_jax_on_shared_draws(monkeypatch):
    # the whole sampler on one random stream: windowed warmup with shared
    # adaptation and its slow-window closes, then sampling; every draw, the
    # adapted step size and mass, the depths and accept statistics equal
    # JAX's (on a closed-form target, where both packages round alike)
    C, W, S, depth = 4, 200, 30, 6
    x0 = np.random.RandomState(9).randn(C, 3)
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    want_s, want = jax.jit(jax.vmap(
        lambda x, k: jnuts.nuts(functools.partial(_gauss, jnp), x, k, S, num_warmup=W, max_depth=depth,
                                adapt_axis="c"), axis_name="c"))(jnp.asarray(x0), keys)

    def key_of(c, t):
        keys_w = jax.random.split(keys[c], W + 1)
        return keys_w[1 + t] if t < W else jax.random.split(keys_w[0], S)[t - W]

    draws = _JaxDraws(key_of, C, W + S, 3, depth)
    monkeypatch.setattr(tnuts, "torch", draws)
    got_s, got = tnuts.nuts(functools.partial(_gauss, torch), _t(x0), None, S, num_warmup=W, max_depth=depth,
                            shared_adaptation=True)
    assert draws.t == W + S - 1
    np.testing.assert_allclose(got["step_size"].numpy(), np.asarray(want["step_size"]), rtol=1e-12)
    np.testing.assert_allclose(got["inv_mass"].numpy(), np.asarray(want["inv_mass"]), rtol=1e-12)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]), rtol=1e-12)
    np.testing.assert_allclose(got["accept_prob"].numpy(), np.asarray(want["accept_prob"]), rtol=1e-12,
                               atol=1e-14)
    assert got["depth"].tolist() == np.asarray(want["depth"]).tolist()
    assert got["diverging"].tolist() == np.asarray(want["diverging"]).tolist()
    assert 1 < float(got["depth"].double().mean()) < depth
    # so the mixing is JAX's: the same ESS per draw
    np.testing.assert_allclose(gft.mcmc.effective_sample_size(got_s.numpy()),
                               jdiag.effective_sample_size(np.asarray(want_s)), rtol=1e-9)


def test_nuts_transition_matches_jax_on_config4(monkeypatch):
    # config #4's GPR hyperposterior through model_logprob: transition after
    # transition from the same state on one random stream, at an adapted
    # step size and mass, the draw, its log posterior, the accept statistic,
    # the depth and the divergence flag equal JAX's. (Chained on its own,
    # each sampler's rounding, 1e-13 apart in the log posterior, grows
    # through dual averaging by about 2x in three warmup draws: a whole
    # warmup is compared on the closed-form target above.)
    C, T, depth = 4, 12, 6
    jm, tm = _model_pair("gpr")
    jlp, jx0, _ = gfs.mcmc.model_logprob(jm)
    tlp, _, _ = gft.mcmc.model_logprob(tm)
    keys = jax.random.split(jax.random.PRNGKey(12), C * T).reshape(C, T, -1)
    draws = _JaxDraws(lambda c, t: keys[c, t], C, T, 3, depth)
    monkeypatch.setattr(tnuts, "torch", draws)
    jtr = jax.jit(jax.vmap(lambda z, lp, g, k, eps, im: jnuts._nuts_transition(
        jax.value_and_grad(jlp), z, lp, g, k, eps, im, depth)))
    tvg = tbase.batched_value_and_grad(tlp)
    z = _t(np.asarray(jx0) + 0.1 * np.random.RandomState(9).randn(C, 3))
    eps = _t([0.5, 0.5, 0.7, 0.7])
    im = _t([[0.09, 1.7, 0.07]] * C)
    depths = []
    for t in range(T):
        lp, g = tvg(z)
        want = jtr(*(jnp.asarray(a.numpy()) for a in (z, lp, g)), keys[:, t], jnp.asarray(eps.numpy()),
                   jnp.asarray(im.numpy()))
        got = tnuts._nuts_transition(tvg, z, lp, g, None, eps, im, depth)
        for f, w in zip(("z", "logp", "grad", "accept_prob"), want[:4]):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(w), rtol=1e-11, atol=1e-12,
                                       err_msg=f"transition {t}: {f}")
        assert got.diverging.tolist() == np.asarray(want[4]).tolist(), t
        assert got.depth.tolist() == np.asarray(want[5]).tolist(), t
        depths += got.depth.tolist()
        z = torch.from_numpy(np.array(want[0]))
    assert max(depths) >= 3


def test_diagnostics_match_jax():
    rng = np.random.RandomState(8)
    s = np.cumsum(rng.randn(4, 301, 3), axis=1) * 0.1 + rng.randn(4, 301, 3)
    np.testing.assert_allclose(gft.mcmc.potential_scale_reduction(s), jdiag.potential_scale_reduction(s),
                               rtol=1e-12)
    np.testing.assert_allclose(gft.mcmc.effective_sample_size(s), jdiag.effective_sample_size(s), rtol=1e-12)


def test_warmup_window_chunking_bit_identical():
    # the adaptation state and the generator ride along, so a window split
    # into chunks draws exactly what one call draws
    def lp(x):
        return -0.5 * torch.sum(x ** 2) - 0.1 * x[0] * x[1]

    x0 = _t([[0.3, -0.2], [1.0, 0.5], [-0.4, 0.1]])
    da0, w0, im0 = gft.mcmc.nuts_warmup_init(x0, step_size=0.2)
    kw = dict(max_depth=6, shared_adaptation=True)
    z_a, da_a, w_a, im_a = gft.mcmc.nuts_warmup_window(lp, x0, torch.Generator().manual_seed(3), 12, da0, w0,
                                                       im0, **kw)
    gen = torch.Generator().manual_seed(3)
    z_b, da_b, w_b, im_b = x0, da0, w0, im0
    for n in (5, 4, 3):
        z_b, da_b, w_b, im_b = gft.mcmc.nuts_warmup_window(lp, z_b, gen, n, da_b, w_b, im_b, **kw)
    assert torch.equal(z_a, z_b) and torch.equal(w_a.m2, w_b.m2) and torch.equal(da_a.log_step, da_b.log_step)
    # shared: one step size for every chain
    assert torch.equal(da_a.log_step, da_a.log_step[:1].expand(3))
    da_c, im_c = gft.mcmc.nuts_slow_window_close(da_a, w_a, shared_adaptation=True)
    assert torch.isfinite(im_c).all() and im_c.shape == (3, 2) and torch.equal(im_c[0], im_c[2])
    assert torch.isfinite(da_c.log_step).all()


def test_sample_chains_arguments():
    lp = functools.partial(_gauss, torch)
    # chains split over a mesh axis must divide by its size (a mesh of two
    # ranks without a process group raises before any collective)
    with pytest.raises(ValueError, match="not divisible"):
        gft.parallel.sample_chains(lp, torch.zeros(3, 3, dtype=torch.float64), torch.Generator(), 2,
                                   mesh=gft.parallel.make_mesh({"chains": 2}, devices=[0, 1]))
    with pytest.raises(ValueError, match="unknown sampler"):
        gft.parallel.sample_chains(lp, torch.zeros(2, 3, dtype=torch.float64), torch.Generator(), 2,
                                   sampler="mala")
