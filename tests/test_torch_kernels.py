"""Parity of the port's kernel zoo (gpflow_slim_tpu_torch.kernels) with the
JAX package, on the CPU in float64: White, Constant/Bias,
RationalQuadratic, Linear, Polynomial, ArcCosine, Periodic, Coregion and
the Sum/Product algebra (``k1 + k2``, ``k1 * k2``, nested, with
``active_dims``): ``K``, ``Kdiag`` and the gradients with respect to every
unconstrained parameter; the combination's flattening rule, parameter
names and order (list children by position, also past ten); and
``interop.load_unconstrained`` with the JAX package's list-index names.

Each kernel is built in both packages with the same arguments, and the
port loads the JAX kernel's unconstrained values. Cases with a fused-map
child run on both of the port's routes (the ``route`` fixture), the kernel
route through the cross Gram's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import GRAD_RTOL, VALUE_RTOL, route  # noqa: F401  (route is a fixture)

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.params import parameters as jax_parameters

torch.set_num_threads(2)

ATOL = 1e-12  # K and Kdiag: the same closed forms in f64


def _arccos(pkg, order):
    return pkg.kernels.ArcCosine(3, order=order, variance=1.2, weight_variances=[0.5, 1.0, 1.5],
                                 bias_variance=0.7)


# name -> (a function making the kernel in either package, input columns)
KERNELS = {
    "white": (lambda pkg: pkg.kernels.White(2, variance=0.4), 2),
    "constant": (lambda pkg: pkg.kernels.Constant(2, variance=0.6), 2),
    "bias": (lambda pkg: pkg.kernels.Bias(2, variance=0.8), 2),
    "rq": (lambda pkg: pkg.kernels.RationalQuadratic(2, variance=1.3, lengthscales=0.4, alpha=0.7), 2),
    "rq_ard": (lambda pkg: pkg.kernels.RationalQuadratic(2, lengthscales=[0.3, 0.6], alpha=2.0, ARD=True), 2),
    "linear_ard": (lambda pkg: pkg.kernels.Linear(3, variance=[0.5, 1.0, 2.0], ARD=True), 3),
    "linear_active_dims": (lambda pkg: pkg.kernels.Linear(1, variance=0.7, active_dims=[2]), 3),
    "polynomial": (lambda pkg: pkg.kernels.Polynomial(2, degree=3.0, variance=0.5, offset=0.9), 2),
    "arccosine0": (lambda pkg: _arccos(pkg, 0), 3),
    "arccosine1": (lambda pkg: _arccos(pkg, 1), 3),
    "arccosine2": (lambda pkg: _arccos(pkg, 2), 3),
    "periodic": (lambda pkg: pkg.kernels.Periodic(1, period=0.16, variance=1.1, lengthscales=0.5), 1),
    "periodic_slice": (lambda pkg: pkg.kernels.Periodic(2, period=0.3, lengthscales=0.7,
                                                        active_dims=slice(1, 3)), 3),
    "coregion": (lambda pkg: pkg.kernels.Coregion(1, output_dim=3, rank=2, active_dims=[1],
                                                  W=np.array([[0.5, -0.2], [0.3, 0.8], [-0.6, 0.1]]),
                                                  kappa=np.array([0.4, 0.9, 1.3])), 2),
    # BASELINE config #2's kernel (benchmarks/bench_svgp_nuts.py bench_sgpr)
    "config2_sum": (lambda pkg: pkg.kernels.Matern32(1, lengthscales=0.2)
                    + pkg.kernels.Periodic(1, period=0.16, lengthscales=0.5), 1),
    "product": (lambda pkg: pkg.kernels.RBF(1, variance=1.4, lengthscales=0.3)
                * pkg.kernels.Linear(1, variance=0.6), 1),
    # tests/test_kernels.py::test_sum_with_active_dims_composition, and its
    # other bracketing
    "a_plus_b_times_c": (lambda pkg: pkg.kernels.RBF(1, active_dims=[0])
                         + pkg.kernels.Periodic(1, active_dims=[2]) * pkg.kernels.Matern32(1, active_dims=[1]),
                         3),
    "a_plus_b_all_times_c": (lambda pkg: (pkg.kernels.RBF(1, active_dims=[0], lengthscales=0.4)
                                          + pkg.kernels.Periodic(1, active_dims=[2], period=0.5))
                             * pkg.kernels.Matern52(1, active_dims=[1], variance=0.8), 3),
}
FUSED = {"config2_sum", "product", "a_plus_b_times_c", "a_plus_b_all_times_c"}


def _inputs(name, D, seed=0):
    rng = np.random.RandomState(seed)
    X, X2 = rng.uniform(0, 1, (9, D)), rng.uniform(0, 1, (7, D))
    if name == "coregion":  # the output index column
        X[:, 1], X2[:, 1] = rng.randint(0, 3, 9), rng.randint(0, 3, 7)
    return X, X2


def _pair(name):
    build, D = KERNELS[name]
    jk, tk = build(gfs), build(gft)
    gft.interop.load_unconstrained(tk, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jk)})
    return jk, tk, D


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _check(name):
    jk, tk, D = _pair(name)
    X, X2 = _inputs(name, D)
    rng = np.random.RandomState(1)
    G, g = rng.randn(len(X), len(X2)), rng.randn(len(X))

    for got, want in [(tk.K(_t(X)), jk.K(X)), (tk.K(_t(X), _t(X2)), jk.K(X, X2)),
                      (tk.Kdiag(_t(X)), jk.Kdiag(X))]:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=VALUE_RTOL, atol=ATOL)

    # the gradients through the cross K (no coincident points, where
    # ArcCosine's arccos is not differentiable) and Kdiag
    def jloss(k):
        return jnp.sum(k.K(X, X2) * G) + jnp.sum(k.Kdiag(X) * g)

    jgrads = dict(jax_parameters(jax.grad(jloss)(jk)))
    loss = torch.sum(tk.K(_t(X), _t(X2)) * _t(G)) + torch.sum(tk.Kdiag(_t(X)) * _t(g))
    loss.backward()
    assert np.isclose(loss.item(), float(jloss(jk)), rtol=VALUE_RTOL)
    names = [gft.interop.port_name(n) for n in jgrads]
    assert [n for n, _ in gft.params.parameters(tk)] == names
    for (_, want), (n, p) in zip(jgrads.items(), gft.params.parameters(tk)):
        w = np.asarray(want.unconstrained)
        got = np.zeros_like(w) if p.unconstrained.grad is None else p.unconstrained.grad.numpy()
        np.testing.assert_allclose(got, w, rtol=GRAD_RTOL, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-300),
                                   err_msg=n)


@pytest.mark.parametrize("name", sorted(set(KERNELS) - FUSED))
def test_kernel_matches_jax(name):
    _check(name)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_combination_matches_jax(name, route):
    _check(name)


def test_active_dims_composition_oracle():
    # tests/test_kernels.py's oracle, on the port alone
    X = torch.tensor(np.random.RandomState(0).randn(12, 3))
    k = gft.kernels.RBF(1, active_dims=[0]) + gft.kernels.Periodic(1, active_dims=[2]) * gft.kernels.Matern32(
        1, active_dims=[1])
    want = gft.kernels.RBF(1).K(X[:, :1]) + gft.kernels.Periodic(1).K(X[:, 2:3]) * gft.kernels.Matern32(
        1).K(X[:, 1:2])
    np.testing.assert_allclose(k.K(X).detach().numpy(), want.detach().numpy(), atol=1e-12)
    ksum, kprod = gft.kernels.RBF(3) + gft.kernels.Linear(3), gft.kernels.RBF(3) * gft.kernels.Linear(3)
    parts = [ksum.kernels[0].K(X), ksum.kernels[1].K(X)]
    np.testing.assert_allclose(ksum.K(X).detach().numpy(), (parts[0] + parts[1]).detach().numpy(), atol=1e-12)
    parts = [kprod.kernels[0].K(X), kprod.kernels[1].K(X)]
    np.testing.assert_allclose(kprod.K(X).detach().numpy(), (parts[0] * parts[1]).detach().numpy(), atol=1e-12)


def test_periodic_is_the_gpflow1_form():
    # 0.5 sin^2 / l^2, not 2 sin^2 / l^2
    k = gft.kernels.Periodic(1, period=0.8, variance=1.7, lengthscales=0.6)
    x = torch.tensor([[0.1], [0.45]], dtype=torch.float64)
    want = 1.7 * np.exp(-0.5 * np.sin(np.pi * 0.35 / 0.8) ** 2 / 0.6 ** 2)
    np.testing.assert_allclose(k.K(x)[0, 1].item(), want, rtol=1e-14)
    np.testing.assert_allclose(k.Kdiag(x).detach().numpy(), [1.7, 1.7], rtol=1e-15)


@pytest.mark.parametrize("build,structure,input_dim", [
    (lambda K: (K.RBF(1) + K.Matern32(1)) + K.Periodic(1), ["RBF", "Matern32", "Periodic"], 1),
    (lambda K: K.RBF(1) + (K.Matern32(1) + K.Periodic(1)), ["RBF", "Matern32", "Periodic"], 1),
    (lambda K: (K.RBF(1) * K.Linear(1)) * (K.Periodic(1) * K.White(1)),
     ["RBF", "Linear", "Periodic", "White"], 1),
    (lambda K: K.RBF(1) + K.Linear(2) * K.Periodic(1, active_dims=[4]), ["RBF", "Product"], 5),
    (lambda K: (K.RBF(1, active_dims=slice(0, 3)) + K.Bias(2)) * K.Constant(1),
     ["Sum", "Constant"], 3),
])
def test_combination_flattening_matches_jax(build, structure, input_dim):
    jk, tk = build(gfs.kernels), build(gft.kernels)
    assert [type(k).__name__ for k in tk.kernels] == [type(k).__name__ for k in jk.kernels] == structure
    assert tk.input_dim == jk.input_dim == input_dim
    assert [n for n, _ in gft.params.parameters(tk)] == [
        gft.interop.port_name(n) for n, _ in jax_parameters(jk)]
    with pytest.raises(TypeError, match="Kernel instances"):
        gft.kernels.Sum([gft.kernels.RBF(1), 3.0])


def test_children_past_ten_are_ordered_as_jax_orders_them():
    # twelve children: kernels.10 and kernels.11 after kernels.9, not after kernels.1
    def build(pkg):
        return pkg.kernels.Sum([pkg.kernels.RBF(1, variance=0.1 * (i + 1), lengthscales=0.2 + 0.05 * i)
                                for i in range(12)])

    jk, tk = build(gfs), build(gft)
    jnames = [n for n, _ in jax_parameters(jk)]
    assert jnames[20:24] == ["kernels[10].lengthscales", "kernels[10].variance", "kernels[11].lengthscales",
                             "kernels[11].variance"]
    assert [n for n, _ in gft.params.parameters(tk)] == [gft.interop.port_name(n) for n in jnames]
    # a fresh port kernel loads the JAX values under the JAX names, each into its own child
    fresh = gft.kernels.Sum([gft.kernels.RBF(1) for _ in range(12)])
    gft.interop.load_unconstrained(fresh, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jk)})
    for i in range(12):
        np.testing.assert_allclose(fresh.kernels[i].variance.value.item(), 0.1 * (i + 1), rtol=1e-14)
    X = np.random.RandomState(0).uniform(0, 1, (6, 1))
    np.testing.assert_allclose(fresh.K(_t(X)).detach().numpy(), np.asarray(jk.K(X)), rtol=VALUE_RTOL)


def test_load_unconstrained_list_index_names():
    jk, tk, _ = _pair("config2_sum")
    arrays = {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jk)}
    assert sorted(arrays) == ["kernels[0].lengthscales", "kernels[0].variance", "kernels[1].lengthscales",
                              "kernels[1].period", "kernels[1].variance"]
    assert gft.interop.port_name("kern.kernels[0].kernels[12].variance") == "kern.kernels.0.kernels.12.variance"
    # the port's own names load too, and a name that is neither raises
    port_arrays = {gft.interop.port_name(n): a + 0.1 for n, a in arrays.items()}
    gft.interop.load_unconstrained(tk, port_arrays)
    np.testing.assert_allclose(tk.kernels[1].period.unconstrained.item(), arrays["kernels[1].period"] + 0.1)
    with pytest.raises(KeyError, match=r"kernels\.1\.period"):
        gft.interop.load_unconstrained(tk, {n: a for n, a in arrays.items() if n != "kernels[1].period"})
