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
