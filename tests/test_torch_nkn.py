"""Parity of the port's NKN and deep kernels with the JAX package, on the CPU
in float64: ``NKN`` (RBF, Periodic, Linear and Matern32 primitives through
NKNLinear/NKNProduct layers, example 06's network) and ``DeepKernel`` on
``mlp_warp``, K and Kdiag at 1e-10 and a GPR's objective and every
gradient (the warp's weights and the NKN layers' included) at 1e-8 on both
of the port's routes; the JAX package's cases (tests/test_nkn.py,
tests/test_utils_deep.py) where they apply; and the weight carrier:
``interop.load_unconstrained`` takes a JAX model's arrays, warp leaves keyed
by their tree path with W transposed, and gives the same objective.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import route  # noqa: F401  (a fixture)

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.kernels_deep import DeepKernel as JDeep
from gpflow_slim_tpu.kernels_deep import mlp_warp as jmlp
from gpflow_slim_tpu.kernels_nkn import NKN as JNKN
from gpflow_slim_tpu.kernels_nkn import NKNLinear as JLinear
from gpflow_slim_tpu.kernels_nkn import NKNProduct as JProduct
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu_torch.kernels_deep import DeepKernel, mlp_warp
from gpflow_slim_tpu_torch.kernels_nkn import NKN, NKNLinear, NKNProduct
from gpflow_slim_tpu_torch.ops import linalg as port_linalg
from gpflow_slim_tpu_torch.ops import nkn as nkn_ops

torch.set_num_threads(2)

ATOL = 1e-10
GRAD_RTOL = 1e-8


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _nkn(pkg, linear, product, nkn, bias=False):
    # example 06's network (tests/test_nkn.py's make_nkn)
    prims = [pkg.kernels.RBF(1, lengthscales=0.3, name="p0"), pkg.kernels.Periodic(1, period=0.5, name="p1"),
             pkg.kernels.Linear(1, name="p2"), pkg.kernels.Matern32(1, lengthscales=0.8, name="p3")]
    layers = [linear(4, 4, use_bias=bias, name="l0"), product(4, 2, name="l1"), linear(2, 1, name="l2")]
    return nkn(1, prims, layers)


def _deep(sizes=(2, 4, 1), base="rbf"):
    fn, params = jmlp(jax.random.PRNGKey(0), list(sizes))
    d_out = sizes[-1]
    jb = gfs.kernels.RBF(d_out, lengthscales=0.5) if base == "rbf" else gfs.kernels.Matern32(d_out)
    tb = gft.kernels.RBF(d_out, lengthscales=0.5) if base == "rbf" else gft.kernels.Matern32(d_out)
    return JDeep(2, jb, fn, params), DeepKernel(2, tb, mlp_warp(list(sizes)))


def _pair(kind):
    rng = np.random.RandomState(0)
    if kind.startswith("nkn"):
        X = rng.randn(25, 1)
        jk = _nkn(gfs, JLinear, JProduct, JNKN, bias=kind == "nkn_bias")
        tk = _nkn(gft, NKNLinear, NKNProduct, NKN, bias=kind == "nkn_bias")
    else:
        X = rng.uniform(-1, 1, (25, 2))
        jk, tk = _deep(base="matern32" if kind == "deep_matern" else "rbf",
                       sizes=(2, 3, 2) if kind == "deep_matern" else (2, 4, 1))
    Y = np.sin(3 * X[:, :1]) + 0.1 * rng.randn(len(X), 1)
    jm = gfs.models.GPR(X, Y, kern=jk)
    tm = gft.models.GPR(X, Y, kern=tk, device="cpu", dtype=torch.float64)
    gft.interop.load_unconstrained(tm, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)})
    return jm, tm, X


KINDS = ["nkn", "nkn_bias", "deep", "deep_matern"]


@pytest.mark.parametrize("kind", KINDS)
def test_K_and_Kdiag_match_jax(kind):
    jm, tm, X = _pair(kind)
    X2 = np.random.RandomState(1).uniform(-1, 1, (6, X.shape[1]))
    with torch.no_grad():
        for args in ((X,), (X, X2)):
            np.testing.assert_allclose(tm.kern.K(*map(_t, args)).numpy(),
                                       np.asarray(jm.kern.K(*map(jnp.asarray, args))), atol=ATOL, rtol=1e-10)
        np.testing.assert_allclose(tm.kern.Kdiag(_t(X)).numpy(), np.asarray(jm.kern.Kdiag(jnp.asarray(X))),
                                   atol=ATOL, rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_gpr_objective_and_grads_match_jax(kind, route):
    jm, tm, _ = _pair(kind)
    jloss, jg = jax.jit(jax.value_and_grad(lambda m: m.objective()))(jm)
    loss = tm.objective()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-10)
    # every trainable leaf, the warp's included (W transposed)
    want = gft.interop.port_arrays(tm, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jg)})
    for n, t in gft.params.trainable_leaves(tm):
        np.testing.assert_allclose(t.grad.numpy(), want[n], rtol=GRAD_RTOL, atol=1e-10, err_msg=n)


def test_nkn_psd_and_symmetric():
    k = _nkn(gft, NKNLinear, NKNProduct, NKN).to(torch.float64)
    X = _t(np.random.RandomState(0).randn(20, 1))
    with torch.no_grad():
        G = k.K(X).numpy()
        d = k.Kdiag(X).numpy()
    np.testing.assert_allclose(G, G.T, atol=1e-10)
    assert np.linalg.eigvalsh(G).min() > -1e-8
    np.testing.assert_allclose(np.diag(G), d, atol=1e-5)


def test_nkn_manual_composition():
    prims = [gft.kernels.RBF(1), gft.kernels.Linear(1)]
    k = NKN(1, prims, [NKNLinear(2, 1, weights=np.array([[0.5, 2.0]]))])
    X = _t(np.random.RandomState(0).randn(10, 1))
    with torch.no_grad():
        np.testing.assert_allclose(k.K(X).numpy(), (0.5 * prims[0].K(X) + 2.0 * prims[1].K(X)).numpy(), atol=1e-12)


def test_nkn_product_of_negative_primitives():
    # a product of primitives that can be negative (Linear, Cosine) is a
    # product, not exp(sum log)
    prims = [gft.kernels.Linear(1), gft.kernels.Cosine(1, lengthscales=0.3)]
    k = NKN(1, prims, [NKNProduct(2, 2)])
    X = _t(np.random.RandomState(2).randn(9, 1))
    with torch.no_grad():
        want = prims[0].K(X) * prims[1].K(X)
        assert bool((want < 0).any())
        np.testing.assert_allclose(k.K(X).numpy(), want.numpy(), atol=1e-12)
    with pytest.raises(ValueError):
        NKNProduct(3, 2)


def test_nkn_grads_reach_all_layers():
    _, tm, _ = _pair("nkn")
    tm.objective().backward()
    assert tm.kern.layers[0].weights.unconstrained.grad.abs().max() > 0
    assert tm.kern.layers[2].weights.unconstrained.grad.abs().max() > 0
    assert tm.kern.primitives[0].lengthscales.unconstrained.grad.abs().max() > 0


def test_deep_kernel_joint_training():
    # tests/test_utils_deep.py's case on the port, shorter
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (80, 2))
    Y = np.sin(3 * (X[:, :1] + 0.5 * X[:, 1:2])) + 0.05 * rng.randn(80, 1)
    kern = DeepKernel(2, gft.kernels.RBF(1, lengthscales=0.5), mlp_warp([2, 8, 1], torch.Generator().manual_seed(0)))
    m = gft.models.GPR(X, Y, kern=kern, device="cpu")
    w0 = kern.warp.layers[0].weight.detach().clone()
    m, losses = gft.training.fit(m, num_steps=100, learning_rate=0.02)
    assert float(losses[-1]) < float(losses[0]) - 5.0
    assert float((kern.warp.layers[0].weight - w0).abs().max()) > 1e-3


def test_mlp_warp_init():
    g = torch.Generator().manual_seed(3)
    warp = mlp_warp([2, 16, 1], g)
    W = warp.layers[0].weight
    assert tuple(W.shape) == (16, 2) and W.dtype == torch.float64
    assert float(warp.layers[0].bias.abs().max()) == 0.0
    assert 0.4 < float(W.std()) * np.sqrt(2) < 1.6  # N(0, 1) / sqrt(d_in)
    H = warp(torch.zeros(5, 2, dtype=torch.float64))
    assert tuple(H.shape) == (5, 1)


@pytest.mark.parametrize("model", ["deep_gpr", "nkn_gpr", "gplvm", "bgplvm", "sgpr_multiscale", "gprcg_deep"])
def test_load_unconstrained_from_jax(model):
    """A JAX model's arrays, its warp's leaves keyed by tree path, load into
    the port and give the same objective; a missing name or a wrong shape
    raises before anything is copied."""
    rng = np.random.RandomState(3)
    if model in ("deep_gpr", "nkn_gpr"):
        jm, tm, _ = _pair("deep" if model == "deep_gpr" else "nkn")
    elif model in ("gplvm", "bgplvm"):
        Y = rng.randn(12, 4)
        X0 = gfs.models.pca_reduce(Y, 2)
        if model == "gplvm":
            jm = gfs.models.GPLVM(Y, 2, kern=gfs.kernels.RBF(2, ARD=True))
            tm = gft.models.GPLVM(Y, 2, kern=gft.kernels.RBF(2, ARD=True), device="cpu")
        else:
            jm = gfs.models.BayesianGPLVM(X0, np.full_like(X0, 0.1), Y, gfs.kernels.RBF(2, ARD=True), M=5)
            tm = gft.models.BayesianGPLVM(X0, np.full_like(X0, 0.1), Y, gft.kernels.RBF(2, ARD=True), M=5,
                                          device="cpu")
    elif model == "sgpr_multiscale":
        X, Z = rng.randn(15, 2), rng.randn(4, 2)
        Y = np.sin(X[:, :1])
        jm = gfs.models.SGPR(X, Y, kern=gfs.kernels.RBF(2), feat=gfs.features.Multiscale(Z))
        tm = gft.models.SGPR(X, Y, kern=gft.kernels.RBF(2), feat=gft.features.Multiscale(Z), device="cpu")
    else:
        X = rng.uniform(-1, 1, (30, 2))
        Y = np.sin(3 * X[:, :1])
        jk, tk = _deep()
        jm = gfs.models.GPRCG(X, Y, kern=jk)
        tm = gft.models.GPRCG(X, Y, kern=tk, device="cpu")
    # move every JAX parameter off its initial value, so the load is seen
    arrays = {n: np.asarray(p.unconstrained) + 0.05 * rng.randn(*np.shape(p.unconstrained))
              for n, p in jax_parameters(jm)}
    for n, p in jax_parameters(jm):
        p.unconstrained = jnp.asarray(arrays[n])
    if model == "gprcg_deep":  # equal objectives on one set of probes
        from gpflow_slim_tpu_torch.ops import iterative

        Z = iterative.rademacher(torch.tensor(7), 0, (30, 16), torch.float64)
        orig = iterative.cg_probes
        iterative.cg_probes = lambda params, n, p, dtype: (Z, Z)
        try:
            gft.interop.load_unconstrained(tm, arrays)
            ref = gft.models.GPRCG(np.asarray(jm.X), np.asarray(jm.Y), kern=_deep()[1], device="cpu")
            ref.kern.warp.load_state_dict(tm.kern.warp.state_dict())
            for (n, p), (_, q) in zip(gft.params.parameters(tm), gft.params.parameters(ref)):
                q.unconstrained.data.copy_(p.unconstrained.data)
            with torch.no_grad():
                assert tm.objective().item() == ref.objective().item()
        finally:
            iterative.cg_probes = orig
        for i, layer in enumerate(tm.kern.warp.layers):
            np.testing.assert_array_equal(layer.weight.detach().numpy().T, arrays[f"kern.warp_params[{i}]['W']"])
        return
    gft.interop.load_unconstrained(tm, arrays)
    with torch.no_grad():
        np.testing.assert_allclose(tm.objective().item(), float(jm.objective()), rtol=1e-10)
    bad = dict(arrays)
    name = next(iter(bad))
    bad.pop(name)
    with pytest.raises(KeyError):
        gft.interop.load_unconstrained(tm, bad)
    bad = {n: (np.zeros((9, 9)) if n == name else a) for n, a in arrays.items()}
    with pytest.raises(ValueError):
        gft.interop.load_unconstrained(tm, bad)
    with torch.no_grad():  # nothing was copied by the failed loads
        np.testing.assert_allclose(tm.objective().item(), float(jm.objective()), rtol=1e-10)


def test_port_name_maps_jax_names():
    assert gft.interop.port_name("kern.warp_params[1]['W']") == "kern.warp.layers.1.weight"
    assert gft.interop.port_name("kern.warp_params[0]['b']") == "kern.warp.layers.0.bias"
    assert gft.interop.port_name("kern.layers[2].weights") == "kern.layers.2.weights"
    assert gft.interop.port_name("kern.primitives[0].lengthscales") == "kern.primitives.0.lengthscales"


# -- the paper's time-series network on the one-pass operand (ops.nkn) --------

REF = Path(__file__).resolve().parents[1] / "port_bench" / "reference" / "gpr-nkn8-d1.py"
CONFIG = json.loads((REF.parents[1] / "configs" / "gpr-nkn8-d1.json").read_text())
# the program's leaves -> the reference's (port_bench/loops/nkn_fit.py's map)
PUBLISHED_LEAVES = {f"kern.primitives.{i}.{attr}": f"{p['name']}.{key}"
                    for i, p in enumerate(CONFIG["primitives"])
                    for key, attr in (("variance", "variance"), ("lengthscale", "lengthscales"), ("period", "period"),
                                      ("alpha", "alpha")) if key in p}
PUBLISHED_LEAVES.update({f"kern.layers.{i}.weights": f"layer{i}.weights" for i in (0, 2, 4)})
PUBLISHED_LEAVES["likelihood.variance"] = "noise_variance"


def _reference():
    spec = importlib.util.spec_from_file_location("reference_gpr_nkn8_d1", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _published(D, ard=False, bias=False, layers=None, prims=None):
    """The configuration's network (ARD: a lengthscale, period or variance
    for each of the D inputs)."""
    k = gft.kernels

    def w(x):
        return np.full(D, x) * (1 + 0.3 * np.arange(D)) if ard else x

    made = []
    for p in CONFIG["primitives"]:
        if p["kind"] == "Linear":
            made.append(k.Linear(D, variance=w(p["variance"])))
        elif p["kind"] == "Periodic":
            made.append(k.Periodic(D, period=w(p["period"]), variance=p["variance"], lengthscales=w(p["lengthscale"])))
        elif p["kind"] == "RBF":
            made.append(k.RBF(D, variance=p["variance"], lengthscales=w(p["lengthscale"])))
        else:
            made.append(k.RationalQuadratic(D, variance=p["variance"], lengthscales=w(p["lengthscale"]),
                                            alpha=p["alpha"]))
    if prims is not None:
        made = prims(made)
    layers = layers or [NKNLinear(8, 8, use_bias=bias), NKNProduct(8, 2), NKNLinear(4, 4), NKNProduct(4, 2),
                        NKNLinear(2, 1)]
    return NKN(D, made, layers)


def _published_gpr(D, N, seed, ard=False, dtype=torch.float64):
    """A GPR on the published network with every leaf moved to a seeded
    random value, and the configuration's data."""
    ref = _reference()
    X, Y = ref.data(CONFIG, N, seed)
    if D == 2:
        X = np.concatenate([X, np.random.RandomState(seed + 5).uniform(0, 1, (N, 1)).astype(np.float32)], axis=1)
    m = gft.models.GPR(X, Y, kern=_published(D, ard), device="cpu", dtype=dtype)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for _, t in gft.params.trainable_leaves(m):
            t.add_(torch.tensor(0.3 * rng.randn(*t.shape), dtype=t.dtype))
    return ref, m, X, Y


@pytest.mark.parametrize("D,ard,N", [(1, False, 150), (2, False, 64), (2, True, 97)])
def test_published_nkn_gpr_matches_the_plain_reference(D, ard, N, route):
    """The objective and the gradient of each of the 22 leaves against
    port_bench's plain reference, in float64, on both routes (the kernel
    route on the CPU runs the operand's plain version and its closed-form
    VJP). Tolerance 1e-9 relative: the two compute the same float64
    numbers in other orders (d as a difference in both; Cholesky in the
    program's blocks), which leaves ~1e-12; the float32 composite misses by
    ~1e-4 (its Gram's rounding through the factor's VJP)."""
    ref, m, X, Y = _published_gpr(D, N, seed=11 + D + N, ard=ard)
    loss = m.objective()
    loss.backward()
    leaves = dict(gft.params.trainable_leaves(m))
    assert set(leaves) == set(PUBLISHED_LEAVES) and len(leaves) == 22
    assert sum(t.numel() for t in leaves.values()) == (111 if ard else 101)  # ARD: 10 more, one a dimension
    u = {PUBLISHED_LEAVES[n]: t.detach().clone().requires_grad_() for n, t in leaves.items()}
    want = ref.objective(torch.tensor(X, dtype=torch.float64), torch.tensor(Y, dtype=torch.float64), u, CONFIG)
    grads = dict(zip(u, torch.autograd.grad(want, list(u.values()))))
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-9)
    for n, t in leaves.items():
        g = grads[PUBLISHED_LEAVES[n]]
        np.testing.assert_allclose(t.grad.numpy(), g.numpy(), rtol=1e-9, atol=1e-9 * float(g.abs().max()), err_msg=n)


def test_published_nkn_float32_misses_the_reference_tolerance():
    """What the tolerance above tells apart: the same GPR in float32 on the
    stock route is ~1e-5-1e-3 off float64 in some leaf's gradient."""
    ref, m32, X, Y = _published_gpr(1, 150, seed=162, dtype=torch.float32)
    _, m64, _, _ = _published_gpr(1, 150, seed=162)
    for m in (m32, m64):
        m.objective().backward()
    g32, g64 = dict(gft.params.trainable_leaves(m32)), dict(gft.params.trainable_leaves(m64))
    worst = max(float((g32[n].grad.double() - g64[n].grad).abs().max() / g64[n].grad.abs().max()) for n in g64)
    assert worst > 1e-6


@pytest.mark.parametrize("D", [1, 2])
def test_operand_plain_is_the_composite_plus_noise(D):
    """``nkn_operand_plain``: the composite's Gram + noise I in the leading
    block (the same float64 numbers to 1e-12), the pad exactly the
    identity."""
    _, m, _, _ = _published_gpr(D, 45, seed=3)
    X = m.X
    kinds = m.kern._operand_kinds(X)
    assert kinds is not None
    theta = m.kern._theta(D, X)
    with torch.no_grad():
        Kp = nkn_ops.nkn_operand_plain(X, theta, torch.tensor(0.37, dtype=torch.float64), kinds, 64)
        want = m.kern.K(X) + 0.37 * torch.eye(45, dtype=torch.float64)
    np.testing.assert_allclose(Kp[:45, :45].numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    assert torch.equal(Kp[45:, :], torch.eye(64, dtype=torch.float64)[45:, :])
    assert torch.equal(Kp[:45, 45:], torch.zeros(45, 19, dtype=torch.float64))


@pytest.mark.parametrize("D", [1, 2])
def test_vjp_plain_matches_autograd_of_the_composite(D):
    """``nkn_vjp_plain``'s closed form (the kernel's arithmetic in float64
    torch) against autograd through the composite K + noise I, for a
    symmetric cotangent and for a general one (the plain VJP reads the whole
    block), each gradient to 1e-10 of its largest entry; the lower triangle
    read with the off-diagonal doubled, as the kernel reads it, equals it
    for the symmetric one."""
    _, m, _, _ = _published_gpr(D, 40, seed=8, ard=D == 2)
    X = m.X
    kinds = m.kern._operand_kinds(X)
    theta = m.kern._theta(D, X).detach().requires_grad_()
    noise = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    rng = np.random.RandomState(4)
    A = torch.tensor(rng.randn(40, 40))
    for g in (A + A.T, A):
        K = nkn_ops.nkn_gram_plain(X, theta, kinds) + noise * torch.eye(40, dtype=torch.float64)
        want = torch.autograd.grad(K, [theta, noise], g)
        got = nkn_ops.nkn_vjp_plain(g, X, theta.detach(), kinds)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10 * float(b.abs().max()))
    S = A + A.T
    lower = torch.tril(S) + torch.tril(S, -1)
    got = nkn_ops.nkn_vjp_plain(S, X, theta.detach(), kinds)
    half = nkn_ops.nkn_vjp_plain(lower, X, theta.detach(), kinds)
    for a, b in zip(got, half):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10 * float(b.abs().max()))


@pytest.mark.parametrize("D,rows", [(1, 7), (2, 16), (1, 50)])
def test_plain_versions_by_row_blocks(D, rows):
    """``nkn_vjp_plain`` taken ``rows`` rows at a time (a last block short
    of it, or one block) equals it on the whole block to 1e-12 of each
    gradient's largest entry, for a general cotangent; ``nkn_gram_plain``'s
    cross Gram of a row block is that block of the square Gram."""
    _, m, _, _ = _published_gpr(D, 50, seed=21 + D, ard=D == 2)
    X = m.X
    kinds = m.kern._operand_kinds(X)
    with torch.no_grad():
        theta = m.kern._theta(D, X)
    g = torch.tensor(np.random.RandomState(5).randn(50, 50))
    whole = nkn_ops.nkn_vjp_plain(g, X, theta, kinds)
    blocked = nkn_ops.nkn_vjp_plain(g, X, theta, kinds, rows=rows)
    for a, b in zip(blocked, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12 * float(b.abs().max()))
    K = nkn_ops.nkn_gram_plain(X, theta, kinds)
    np.testing.assert_allclose(nkn_ops.nkn_gram_plain(X[10:10 + rows], theta, kinds, X).numpy(),
                               K[10:10 + rows].numpy(), rtol=1e-13, atol=1e-13)


def test_layout_names_the_network():
    """``layout()``, what ``gfs_nkn_layout`` must report: the primitives,
    the three kinds past ``ops.gram``'s stationary maps, and the Linear
    layers' (in, out) of ``NET`` in order; ``theta_size`` counts the
    primitives' slots and those layers' weights."""
    assert nkn_ops.layout() == (8, 6, 7, 8, 8, 8, 4, 4, 2, 1)
    assert [nkn_ops.theta_size(D) for D in (1, 2)] == [8 * 3 + 64 + 16 + 2, 8 * 5 + 64 + 16 + 2]


UNCOVERED = {
    "example06": lambda: _nkn(gft, NKNLinear, NKNProduct, NKN),
    "bias": lambda: _published(1, bias=True),
    "polynomial": lambda: _published(1, prims=lambda ps: [gft.kernels.Polynomial(1)] + ps[1:]),
    "white": lambda: _published(1, prims=lambda ps: ps[:7] + [gft.kernels.White(1, variance=0.1)]),
    "active_dims": lambda: _published(1, prims=lambda ps: [gft.kernels.RBF(2, active_dims=[1])] + ps[1:]),
}


@pytest.mark.parametrize("kind", list(UNCOVERED))
def test_uncovered_networks_keep_the_composite_route(kind, monkeypatch):
    """A network the operand does not cover (example 06's 4-primitive one, a
    biased layer, a Polynomial or White primitive, a primitive on other
    columns) gives no operand, and its GPR's objective on the forced kernel
    route equals the stock route's."""
    kern = UNCOVERED[kind]()
    X = np.random.RandomState(0).uniform(0, 1, (30, 2 if kind == "active_dims" else 1))
    Y = np.sin(6 * X[:, :1])
    m = gft.models.GPR(X, Y, kern=kern, device="cpu", dtype=torch.float64)
    assert kern.gram_chol_operand(m.X, 0.1, 64) is None
    stock = m.objective().item()
    monkeypatch.setattr(port_linalg, "kernels_active", lambda t: True)
    np.testing.assert_allclose(m.objective().item(), stock, rtol=1e-12)


def test_operand_takes_no_x_that_needs_a_gradient_nor_d3():
    k = _published(1)
    assert k.gram_chol_operand(torch.zeros(5, 1, dtype=torch.float64, requires_grad=True), 0.1, 64) is None
    k3 = _published(3)
    assert k3.gram_chol_operand(torch.zeros(5, 3, dtype=torch.float64), 0.1, 64) is None
    assert k.gram_chol_operand(torch.zeros(5, 1, dtype=torch.float64), 0.1, 64) is not None


class _Objective(torch.nn.Module):
    """``model.objective()`` as a module call, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self):
        return self.model.objective()


def test_published_nkn_objective_under_func_grad(monkeypatch):
    """``torch.func.grad`` of the objective through ``functional_call`` on
    the forced kernel route (the Function's forward and closed-form
    backward under a transform) equals autograd's, to 1e-12."""
    _, m, _, _ = _published_gpr(1, 50, seed=21)
    monkeypatch.setattr(port_linalg, "kernels_active", lambda t: True)
    params = {f"model.{n}.unconstrained": p.unconstrained.detach() for n, p in gft.params.parameters(m)}
    got = torch.func.grad(lambda ps: torch.func.functional_call(_Objective(m), ps, ()))(params)
    m.objective().backward()
    for n, p in gft.params.parameters(m):
        np.testing.assert_allclose(got[f"model.{n}.unconstrained"].numpy(), p.unconstrained.grad.numpy(), rtol=1e-12,
                                   atol=1e-15, err_msg=n)


def test_operand_under_vmap_is_a_loop():
    """``vmap`` of the operand over a batch of parameter vectors (the
    Function's rule: the Function on each entry) equals the calls one by
    one, and so do their gradients."""
    _, m, _, _ = _published_gpr(1, 30, seed=5)
    X = m.X
    kinds = m.kern._operand_kinds(X)
    theta = m.kern._theta(1, X).detach()
    thetas = torch.stack([theta, theta * 1.1])
    noise = torch.tensor(0.2, dtype=torch.float64)

    def f(t):
        return nkn_ops.nkn_chol_operand(X, t, noise, kinds, 32)

    got = torch.func.vmap(f)(thetas)
    assert torch.equal(got, torch.stack([f(t) for t in thetas]))
    grads = torch.func.vmap(torch.func.grad(lambda t: f(t).tril().square().sum()))(thetas)
    for t, g in zip(thetas, grads):
        np.testing.assert_allclose(g.numpy(), torch.func.grad(lambda t: f(t).tril().square().sum())(t).numpy(),
                                   rtol=1e-12)
