"""``torch.func`` through the port's autograd Functions, on the CPU in
float64, against ``torch.autograd``, a loop and the JAX package.

Each Function of ``gpflow_slim_tpu_torch.ops`` (the cross, lower-tile and
operand Grams, the factor-only and fused Cholesky, the TRSM on one
triangle or a batch) is taken through ``torch.func.grad`` and
``torch.func.vmap``: the gradient equals ``torch.autograd.grad``, the
batched call equals a loop, and both equal ``jax.grad`` / ``jax.vmap`` of
the JAX package's ``custom_vjp`` with its Pallas kernel in interpret mode
(as tests/test_torch_ops.py runs it), at that file's tolerance for the
same function. On the CPU the Functions run their kernels' plain versions;
a recorder on their forward routes checks that the kernels would be handed
plain tensors (whose ``data_ptr`` a launch takes) under every transform.
Then the closed-form Gram VJP at coincident points, the TF32 guard of the
Gram expansion, and two models: ``torch.func.grad`` of the GPR objective
through ``functional_call``, and a GPR on ``nn.Linear``-warped inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpr import GRAD_RTOL, VALUE_RTOL, _pair, route  # noqa: F401  (route is a fixture)
from torch._C._functorch import is_batchedtensor, is_functorch_wrapped_tensor
from torch.func import functional_call, grad, vmap

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu.params import parameters as jax_parameters
from gpflow_slim_tpu.ops import pallas_cholesky, pallas_gram, pallas_trsm
from gpflow_slim_tpu_torch.ops import _build, _func, cholesky, gram, trsm

torch.set_num_threads(2)

KINDS = list(gram.KINDS)
B = 3  # the batch of the vmap cases


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _grid(shape, seed):
    # multiples of 1/8: the interpret-mode Gram forms its cross product in
    # f32 even for f64 inputs, exactly on this grid (as in test_torch_ops)
    return np.random.RandomState(seed).randint(-40, 40, shape) / 8.0


def _tri(shape, seed):
    A = np.random.RandomState(seed).randn(*shape)
    M = shape[-1]
    return np.tril(A) + M * np.eye(M)


def _spd(N, seed):
    A = np.random.RandomState(seed).randn(N, N)
    return A @ A.T + N * np.eye(N)


def _operand(N, pad_to, seed):
    Xs = np.random.RandomState(seed).uniform(0, 1, (N, 1)) / 0.3
    return gram.gram_chol_operand_plain("rbf", _t(Xs), 1.1, 0.3, pad_to).numpy()


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas entry points in interpret mode, as
    tests/test_torch_ops.py runs them on the CPU."""
    monkeypatch.setattr(pallas_gram, "_gram_pallas",
                        lambda kind, a, b, v: pallas_gram.gram_interpret_mode(kind, a, b, v))
    for mod, name, kw in ((pallas_gram, "_gram_lower_pallas", dict(tile=64)),
                          (pallas_gram, "_gram_chol_operand_pallas", dict(tile=128)),
                          (pallas_cholesky, "_cholesky_pallas", dict(block_size=64)),
                          (pallas_cholesky, "_cholesky_solve_pallas", dict(block_size=64)),
                          (pallas_trsm, "_trsm_pallas", dict(block_size=64)),
                          (pallas_trsm, "_batched_trsm_pallas", {})):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True, **kw))


# Each case: (port function, JAX function, arguments as numpy arrays, the
# tolerance against JAX as (rtol, atol), atol absolute or, as a string,
# relative to the largest entry). The tolerances are tests/test_torch_ops.py's
# for the same function: the Grams' VJPs are f64 on both sides; the others
# go through the interpret-mode kernels, which accumulate in f32.
def _cases():
    N, M, P = 30, 20, 3
    Xs, X2s = _grid((N, 2), 0), _grid((M, 2), 1)
    L = _tri((N, N), 2)
    Lb = _tri((2, 40, 40), 3)
    Kp = _operand(100, 128, 4)
    Dp = np.zeros((128, 2))
    Dp[:100] = np.random.RandomState(5).randn(100, 2)
    return {
        "gram": (lambda a, b, v: gram.stationary_gram("matern52", a, b, v),
                 lambda a, b, v: pallas_gram.stationary_gram("matern52", a, b, v),
                 (Xs, X2s, np.float64(1.3)), (1e-10, 1e-12)),
        "gram_lower": (lambda a, v: gram.stationary_gram_lower("rbf", a, v),
                       lambda a, v: pallas_gram.stationary_gram_lower("rbf", a, v),
                       (Xs, np.float64(1.3)), (1e-10, 1e-12)),
        "operand": (lambda a, v, n: gram.gram_chol_operand("matern32", a, v, n, 128),
                    lambda a, v, n: pallas_gram.stationary_gram_chol_operand("matern32", a, v, n, 128),
                    (Xs, np.float64(1.3), np.float64(0.2)), (1e-10, 1e-10)),
        "cholesky": (cholesky.cholesky, lambda k: pallas_cholesky.cholesky(k, block_size=64),
                     (_spd(70, 6),), (0, "1e-6")),
        "chol_solve_logdet": (lambda k, d: torch.stack(cholesky.cholesky_solve_logdet(k.clone(), d)),
                              lambda k, d: jnp.stack(pallas_cholesky.cholesky_solve_logdet(k, d, 64)),
                              (Kp, Dp), (0, "1e-5")),
        "solve_lower": (trsm.solve_lower, pallas_trsm.solve_lower, (L, np.random.RandomState(7).randn(N, P)),
                        (0, 1e-8)),
        "solve_upper": (trsm.solve_upper, pallas_trsm.solve_upper,
                        (L.T, np.random.RandomState(8).randn(N, P)), (0, 1e-8)),
        "batched_solve_lower": (trsm.batched_solve_lower, pallas_trsm.batched_solve_lower,
                                (Lb, np.random.RandomState(9).randn(2, 40, 5)), (0, 1e-5)),
        "batched_solve_upper": (trsm.batched_solve_upper, pallas_trsm.batched_solve_upper,
                                (np.swapaxes(Lb, 1, 2), np.random.RandomState(10).randn(2, 40, 5)), (0, 1e-5)),
    }


CASES = list(_cases())


def _cotangent(out_shape, seed=11):
    return np.random.RandomState(seed).randn(*out_shape)


def _allclose(got, want, tol, what):
    rtol, atol = tol
    want = np.asarray(want)
    if isinstance(atol, str):
        atol = float(atol) * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_func_grad_matches_autograd_and_jax(case, interpret):
    fn, jfn, args, tol = _cases()[case]
    out = fn(*map(_t, args))
    G = _cotangent(out.shape)
    if case == "gram_lower":
        G = np.tril(G)  # what a Cholesky consumer gives it
    argnums = tuple(range(len(args)))

    def loss(*a):
        return torch.sum(fn(*a) * _t(G))

    got = grad(loss, argnums=argnums)(*map(_t, args))
    leaves = [_t(a).requires_grad_() for a in args]
    want = torch.autograd.grad(loss(*leaves), leaves)
    for g, w, i in zip(got, want, argnums):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-13, atol=1e-13 * float(w.abs().max()),
                                   err_msg=f"argument {i}: torch.func.grad against torch.autograd.grad")
    jgot = jax.grad(lambda *a: jnp.sum(jfn(*a) * jnp.asarray(G)), argnums=argnums)(*map(jnp.asarray, args))
    for g, w, i in zip(got, jgot, argnums):
        _allclose(g.numpy(), w, tol, f"argument {i}: torch.func.grad against jax.grad")


def _batch(args, seed):
    # B entries of each array argument, perturbed so they differ; scalars too
    rng = np.random.RandomState(seed)
    out = []
    for a in args:
        a = np.asarray(a)
        if a.ndim == 0:
            out.append(a * (1.0 + 0.1 * np.arange(B)))
        else:
            out.append(np.stack([a + (0.125 * i * rng.randint(-2, 3, a.shape) if a.ndim == 2 else 0.01 * i)
                                 for i in range(B)]))
    return out


@pytest.mark.parametrize("case", CASES)
def test_func_vmap_matches_loop_and_jax(case, interpret):
    fn, jfn, args, tol = _cases()[case]
    if case in ("cholesky", "chol_solve_logdet"):
        batched = [np.stack([a + 0.5 * i * np.eye(len(a)) if a.shape[0] == a.shape[1] else a for i in range(B)])
                   for a in args]
    elif case in ("solve_lower", "solve_upper", "batched_solve_lower", "batched_solve_upper"):
        batched = [np.stack([a * (1.0 + 0.1 * i) for i in range(B)]) for a in args]
    else:
        batched = _batch(args, 12)
    got = vmap(fn)(*map(_t, batched))
    want = torch.stack([fn(*[_t(a[i]) for a in batched]) for i in range(B)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-13 * float(want.abs().max()),
                               err_msg="torch.func.vmap against a loop")
    jwant = jax.vmap(jfn)(*map(jnp.asarray, batched))
    if case in ("gram_lower", "operand"):  # the lower triangle is the specified part
        n = got.shape[-1]
        low = np.tril(np.ones((n, n), bool))
        got, jwant = got.numpy()[:, low], np.asarray(jwant)[:, :n, :n][:, low]
    _allclose(np.asarray(got), jwant, tol, "torch.func.vmap against jax.vmap")


@pytest.mark.parametrize("shared", ["T", "B", "neither"])
def test_vmap_of_one_triangle_solves_is_one_batched_solve(shared, monkeypatch):
    # a batch of 2-D solves reaches the batched kernel's route once, with
    # an unbatched triangle broadcast over the batch (stride 0)
    L, Bm = _tri((B, 20, 20), 13), np.random.RandomState(14).randn(B, 20, 4)
    calls = []
    route = trsm._solve

    def recording(T, Bt, lower):
        calls.append((T.dim(), T.stride(0) if T.dim() == 3 else None))
        return route(T, Bt, lower)

    monkeypatch.setattr(trsm, "_solve", recording)
    in_dims = {"T": (None, 0), "B": (0, None), "neither": (0, 0)}[shared]
    Ts = _t(L[0]) if shared == "T" else _t(L)
    Bs = _t(Bm[0]) if shared == "B" else _t(Bm)
    got = vmap(trsm.solve_lower, in_dims=in_dims)(Ts, Bs)
    assert calls == [(3, 0 if shared == "T" else 400)]
    want = [trsm.solve_triangular_plain(_t(L[0] if shared == "T" else L[i]),
                                        _t(Bm[0] if shared == "B" else Bm[i]), True) for i in range(B)]
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("transform", ["grad", "vmap", "grad_of_vmap", "vmap_of_grad"])
def test_kernel_routes_get_plain_tensors(transform, monkeypatch):
    # every forward route (which on a CUDA tensor launches a kernel from
    # its data_ptr) is handed plain tensors under each transform, and the
    # fused Cholesky factors its input in place only outside them
    seen = []

    def record(mod, name):
        inner = getattr(mod, name)

        def recording(*a):
            tensors = [x for x in a if isinstance(x, torch.Tensor)]
            seen.append((name, all(not is_functorch_wrapped_tensor(x) and not is_batchedtensor(x)
                                   for x in tensors)))
            return inner(*a)

        monkeypatch.setattr(mod, name, recording)

    for mod, name in ((gram, "_gram_forward"), (gram, "_operand"), (cholesky, "cholesky_solve"),
                      (cholesky, "_factor_padded"), (trsm, "_solve")):
        record(mod, name)
    Xs = _t(_grid((12, 1), 15))
    Y = _t(np.random.RandomState(16).randn(12, 1))

    def objective(v):
        Kp = gram.gram_chol_operand("rbf", Xs, v, 0.5, 64)
        Dp = torch.nn.functional.pad(Y, (0, 0, 0, 52))
        hl, q = cholesky.cholesky_solve_logdet(Kp, Dp)
        L = cholesky.cholesky(gram.stationary_gram("rbf", Xs, Xs, v) + 0.5 * torch.eye(12, dtype=v.dtype))
        return hl + q + torch.sum(trsm.solve_upper(L.T, trsm.solve_lower(L, Y)))

    v0, vb = _t(1.3), _t([1.1, 1.3])
    out = {"grad": lambda: grad(objective)(v0), "vmap": lambda: vmap(objective)(vb),
           "grad_of_vmap": lambda: grad(lambda v: vmap(objective)(v).sum())(vb),
           "vmap_of_grad": lambda: vmap(grad(objective))(vb)}[transform]()
    assert torch.isfinite(out).all()
    names = {n for n, _ in seen}
    assert names == {"_gram_forward", "_operand", "cholesky_solve", "_factor_padded", "_solve"}
    assert all(plain for _, plain in seen), seen


@pytest.mark.parametrize("transform", ["grad", "vmap", "grad_of_vmap", "vmap_of_grad"])
def test_kernel_function_hands_its_kernel_plain_tensors(transform, monkeypatch):
    # the operand's VJP as kernel_function makes it: on CPU tensors the
    # plain version, which launches nothing; with the kernel branch forced,
    # the Function around the "kernel" (the plain version, recording what it
    # is handed) gives it plain tensors under each transform and the same
    # results, through a backward (grad) and through its loop vmap rule
    Xs, G = _t(_grid((12, 2), 17)), _t(np.random.RandomState(18).randn(64, 64))
    v0, vb = _t(1.3), _t([1.1, 1.3])

    def objective(v):
        return torch.sum(gram.gram_chol_operand("rbf", Xs, v, 0.5, 64) * G)

    run = {"grad": lambda: grad(objective)(v0),
           "vmap": lambda: vmap(lambda v: gram._operand_vjp("rbf", G, Xs, v))(vb),
           "grad_of_vmap": lambda: grad(lambda v: vmap(objective)(v).sum())(vb),
           "vmap_of_grad": lambda: vmap(grad(objective))(vb)}[transform]
    before = dict(_build.launches)
    want = run()
    assert _build.launches == before

    seen = []

    def kernel(kind, g, x, v):
        seen.append(all(not is_functorch_wrapped_tensor(t) and not is_batchedtensor(t) for t in (g, x, v)))
        return gram.gram_operand_vjp_plain(kind, g, x, v)

    monkeypatch.setattr(_func, "on_device", lambda plain, cuda, at=0: cuda)  # the kernel branch, always
    monkeypatch.setattr(gram, "_operand_vjp", _func.kernel_function(gram.gram_operand_vjp_plain, kernel, at=1))
    got = run()
    assert seen and all(seen), seen
    for a, b in zip(*(w if isinstance(w, tuple) else (w,) for w in (got, want))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-13)


def test_chol_solve_logdet_factors_in_place_only_outside_transforms():
    Kp, Dp = _t(_operand(50, 64, 17)), _t(np.random.RandomState(25).randn(64, 1))
    Dp[50:] = 0.0
    K = Kp.clone().requires_grad_()
    Kw = K.clone()
    hl, q = cholesky.cholesky_solve_logdet(Kw, Dp)
    assert torch.equal(Kw.detach(), cholesky.cholesky_plain(Kp))  # overwritten by its factor
    want = torch.autograd.grad(hl + q, K)[0]
    K2 = Kp.clone()
    got = grad(lambda k: sum(cholesky.cholesky_solve_logdet(k, Dp)))(K2)
    assert torch.equal(K2, Kp)  # a transform factors a copy
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-13 * float(want.abs().max()))


def _coincident(seed):
    # duplicated rows, and X2s sharing rows with Xs: d = 0, where the clamp
    # of the expansion ties and sqrt(d^2 + 1e-12) is steepest
    rng = np.random.RandomState(seed)
    Xs = rng.uniform(0, 1, (30, 2)) / 0.3
    Xs[5] = Xs[7] = Xs[3]
    X2s = np.concatenate([Xs[:6], rng.uniform(0, 1, (14, 2)) / 0.3])
    return Xs, X2s


@pytest.mark.parametrize("kind", KINDS)
def test_gram_vjp_closed_form_matches_jax_at_coincident_points(kind):
    # the closed form against `_bwd`, `_lower_bwd` and `_opnd_bwd` (jax.vjp
    # of `_gram_reference`, whose clamp splits a tie at d^2 = 0 in halves).
    # Matern12 and Exponential have the slope 1/(2r) = 5e5 at d = 0, which
    # amplifies the f64 rounding of the coordinate sums in both packages
    # alike: ~4e-10 of the largest entry (test_torch_gpr's NONSMOOTH case)
    Xs, X2s = _coincident(18)
    rng = np.random.RandomState(19)
    G, Gs, Gp = rng.randn(30, 20), rng.randn(30, 30), rng.randn(32, 32)
    atol = "1e-9" if kind in ("matern12", "exponential") else "1e-13"
    var, noise = _t(1.3), _t(0.2)
    j = jnp.asarray
    pairs = [(gram._gram_vjp(kind, _t(G), _t(Xs), _t(X2s), var),
              pallas_gram._bwd(kind, (j(Xs), j(X2s), j(1.3)), j(G))),
             (gram._gram_vjp(kind, _t(Gs), _t(Xs), None, var),
              pallas_gram._lower_bwd(kind, (j(Xs), j(1.3)), j(Gs)))]
    xs, v, n = (_t(a).requires_grad_() for a in (Xs, 1.3, 0.2))
    torch.sum(gram.gram_chol_operand(kind, xs, v, n, 32) * _t(Gp)).backward()
    pairs.append(((xs.grad, v.grad, n.grad),
                  pallas_gram._opnd_bwd(kind, 32, (j(Xs), j(1.3), j(0.2)), j(Gp))))
    for got, want in pairs:
        for g, w in zip(got, want):
            _allclose(g.numpy(), w, (1e-10, atol), kind)
    assert noise.dtype == torch.float64


@pytest.mark.parametrize("kind", ["rbf", "matern12"])
def test_gram_second_order_matches_jax(kind):
    # d/dXs of the variance gradient: the closed-form VJP is itself
    # differentiable. The JAX package's custom_vjp is not (its forward is a
    # Pallas call), so the reference is its VJP's function, `_gram_reference`
    Xs, X2s = _grid((15, 2), 20), _grid((9, 2), 21)
    G = np.random.RandomState(22).randn(15, 9)

    def gv(a):
        return grad(lambda v: torch.sum(gram.stationary_gram(kind, a, _t(X2s), v) * _t(G)))(_t(1.3))

    got = grad(gv)(_t(Xs))
    want = jax.grad(lambda a: jax.grad(lambda v: jnp.sum(
        pallas_gram._gram_reference(kind, a, jnp.asarray(X2s), v) * jnp.asarray(G)))(1.3))(jnp.asarray(Xs))
    _allclose(got.numpy(), want, (1e-10, "1e-12"), kind)


def _tf32_state():
    out = [torch.backends.cuda.matmul.fp32_precision]
    try:
        out.append(torch.get_float32_matmul_precision())
    except RuntimeError:
        out.append("mixed")
    return out


@pytest.mark.parametrize("setup", ["off", "high", "medium", "allow_tf32", "fp32_precision"])
def test_full_precision_switches_tf32_off_and_restores_it(setup):
    # the guard of the Gram expansion: TF32 off inside, whatever the process
    # set and through whichever API, and the caller's setting back after
    try:
        if setup in ("high", "medium"):
            torch.set_float32_matmul_precision(setup)
        elif setup == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        elif setup == "fp32_precision":
            torch.backends.cuda.matmul.fp32_precision = "tf32"
        before = _tf32_state()
        assert gram._tf32_enabled() == (setup != "off")
        with gram.full_precision():
            assert not gram._tf32_enabled()
            assert torch.backends.cuda.matmul.fp32_precision == "ieee" or setup == "off"
        assert _tf32_state() == before
    finally:
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.set_float32_matmul_precision("highest")
    assert not gram._tf32_enabled()


class _Objective(torch.nn.Module):
    """``model.objective()`` as a module call, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self):
        return self.model.objective()


@pytest.mark.parametrize("kern_name", ["RBF", "Matern12"])
def test_func_grad_of_gpr_objective_matches_autograd_and_jax(kern_name, route):
    jm, tm = _pair(kern_name)
    names = [n for n, _ in gft.params.parameters(tm)]
    params = {f"model.{n}.unconstrained": p.unconstrained.detach() for n, p in gft.params.parameters(tm)}
    got = grad(lambda ps: functional_call(_Objective(tm), ps, ()))(params)
    tm.objective().backward()
    jgrads = dict(jax_parameters(jax.grad(lambda m: m.objective())(jm)))
    rtol = GRAD_RTOL if kern_name == "RBF" else 1e-6  # test_torch_gpr's NONSMOOTH_RTOL
    for n, (_, p) in zip(names, gft.params.parameters(tm)):
        g = got[f"model.{n}.unconstrained"]
        np.testing.assert_allclose(g.numpy(), p.unconstrained.grad.numpy(), rtol=1e-12, err_msg=n)
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[n].unconstrained), rtol=rtol, err_msg=n)


def test_gpr_on_linear_warped_inputs(route):
    # a GPR on inputs warped by nn.Linear (2 -> 1): the objective and the
    # warp's gradient match the JAX GPR on the same warped inputs, with
    # the gradient to X chained through the warp; then Adam fits both
    rng = np.random.RandomState(24)
    Xr = rng.uniform(0, 1, (40, 2))
    Y = np.sin(6 * Xr[:, :1] - 3 * Xr[:, 1:]) + 0.05 * rng.randn(40, 1)
    torch.manual_seed(0)
    warp = torch.nn.Linear(2, 1, dtype=torch.float64)
    W0, b0 = warp.weight.detach().numpy().copy(), warp.bias.detach().numpy().copy()
    tm = gft.models.GPR(Xr @ W0.T + b0, Y, kern=gft.kernels.RBF(1, lengthscales=0.3), device="cpu",
                        dtype=torch.float64)
    jm = gfs.models.GPR(Xr @ W0.T + b0, Y, kern=gfs.kernels.RBF(1, lengthscales=0.3))
    gft.interop.load_unconstrained(tm, {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)})
    warped = _Objective(tm)

    def loss():
        return functional_call(warped, {"model.X": warp(_t(Xr))}, ())

    value = loss()
    value.backward()

    def jloss(W, b):
        mm = jax.tree_util.tree_map(lambda a: a, jm)
        object.__setattr__(mm, "X", jnp.asarray(Xr) @ W.T + b)
        return mm.objective()

    jv, (gW, gb) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(W0), jnp.asarray(b0))
    np.testing.assert_allclose(value.item(), float(jv), rtol=VALUE_RTOL)
    np.testing.assert_allclose(warp.weight.grad.numpy(), np.asarray(gW), rtol=GRAD_RTOL)
    # a stationary kernel does not see a shift of the inputs: the bias's
    # gradient is rounding on both sides
    np.testing.assert_allclose(warp.bias.grad.numpy(), np.asarray(gb), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(gW)).max())

    opt = torch.optim.Adam([*warp.parameters(), *tm.parameters()], lr=0.05)
    losses = []
    for _ in range(30):
        opt.zero_grad()
        out = loss()
        out.backward()
        opt.step()
        losses.append(out.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 1.0
