"""The port's program spans and host-sync counter (``utils.trace``).

Off, a span is one shared no-op and the profiler sees none of the port's
names; on, each of the 16 spans of the GPR training and serving paths is
recorded, a backward's span holds the spans it calls, and the results are
bitwise those of a run with tracing off, also under ``torch.func``; so are
the NKN operand's two spans on a GPR over the paper's network. The
kernel route is forced on the CPU (``ops.linalg.kernels_active``), so the
autograd Functions run through their plain versions. The card test runs
with ``python -m pytest --noconftest -q tests/test_torch_trace.py`` on a
machine with a card (this file imports no JAX).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpflow_slim_tpu_torch as gft
from gpflow_slim_tpu_torch.ops import cholesky, linalg, trsm
from gpflow_slim_tpu_torch.training.optimize import make_step_fn
from gpflow_slim_tpu_torch.utils import named_scope, trace, traced

SPANS = [f"gfs.{layer}.{side}" for layer in ("gram", "gram_lower", "gram_operand", "cholesky",
                                             "chol_solve_logdet", "trsm") for side in ("fwd", "bwd")]
SPANS += ["gfs.gpr.likelihood", "gfs.gpr.posterior", "gfs.posterior.predict_f", "gfs.step.update"]


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setattr(linalg, "kernels_active", lambda t: True)


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    yield
    trace.disable()


def _model(N=40):
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(12 * X) + 0.1 * rng.randn(N, 1)
    return gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.3), device="cpu", dtype=torch.float64)


def _run():
    """Two Adam steps, then a differentiated request to the posterior and a
    plain one: every span of the GPR paths, on the plain versions."""
    model = _model()
    step_fn, opt = make_step_fn(model, lambda ps: torch.optim.Adam(ps, lr=0.01))
    losses = [step_fn() for _ in range(2)]
    grads = [p.grad.clone() for g in opt.param_groups for p in g["params"]]
    Xq = torch.linspace(0, 1, 7, dtype=torch.float64)[:, None]
    mean, var = model.posterior().predict_f(Xq)
    (mean.sum() + var.sum()).backward()
    with torch.no_grad():
        pred = model.posterior().predict_f(Xq)
    return [*losses, *grads, mean.detach(), var.detach(), *pred,
            *(p.grad.clone() for g in opt.param_groups for p in g["params"])]


def _names(prof):
    return [e.name for e in prof.events()]


def test_off_is_one_shared_noop_and_records_nothing(kernel_route):
    assert not trace.enabled()
    assert named_scope("gfs.a") is named_scope("gfs.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run()
    assert not [n for n in _names(prof) if n.startswith("gfs.")]


def test_on_records_every_span_and_backward_spans_nest(kernel_route):
    with traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        _run()
    assert not trace.enabled()
    names = _names(prof)
    assert [s for s in SPANS if s not in names] == []
    events = prof.events()

    def holds(outer, inner):
        return any(i.name == inner and i.thread == o.thread and o.time_range.start <= i.time_range.start
                   and i.time_range.end <= o.time_range.end for o in events if o.name == outer for i in events)

    assert holds("gfs.trsm.bwd", "gfs.trsm.fwd")  # gB by the Function on the transposed view
    assert holds("gfs.cholesky.bwd", "gfs.trsm.fwd")  # the factor's VJP solves through the TRSM
    assert holds("gfs.gpr.likelihood", "gfs.chol_solve_logdet.fwd")
    assert holds("gfs.posterior.predict_f", "gfs.gram.fwd")


def test_results_are_bitwise_equal_with_tracing_on(kernel_route):
    off = _run()
    with traced():
        on = _run()
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))


def _spd(n, seed):
    A = torch.tensor(np.random.RandomState(seed).randn(n, n))
    return A @ A.T + n * torch.eye(n, dtype=torch.float64)


@pytest.mark.parametrize("transform", ["grad", "vmap", "jacrev"])
def test_func_transforms_are_bitwise_equal_with_tracing_on(transform):
    L = torch.linalg.cholesky(_spd(12, 1))
    B = torch.tensor(np.random.RandomState(2).randn(3, 12, 4))
    Ks = torch.stack([_spd(12, s) for s in (3, 4, 5)])
    D = B[..., :1]

    def trsm_loss(b):
        return trsm.solve_lower(L, b).square().sum()

    def csl_loss(K, d):
        hl, q = cholesky.cholesky_solve_logdet(K, d)
        return hl + q

    def run():
        if transform == "grad":
            return [torch.func.grad(trsm_loss)(B[0]), *torch.func.grad(csl_loss, argnums=(0, 1))(Ks[0], D[0])]
        if transform == "jacrev":
            return [torch.func.jacrev(lambda b: trsm.solve_lower(L, b))(B[0]),
                    *torch.func.jacrev(csl_loss, argnums=(0, 1))(Ks[0], D[0])]
        return [torch.func.vmap(lambda b: trsm.solve_lower(L, b))(B),
                *torch.func.vmap(lambda k, d: cholesky.cholesky_solve_logdet(k, d))(Ks.clone(), D),
                torch.func.vmap(torch.func.grad(trsm_loss))(B)]

    off = run()
    with traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    names = _names(prof)
    assert "gfs.trsm.fwd" in names and "gfs.chol_solve_logdet.fwd" in names
    if transform != "vmap":
        assert "gfs.trsm.bwd" in names and "gfs.chol_solve_logdet.bwd" in names


def test_host_syncs_read_zero_on_the_cpu(kernel_route):
    before = trace.host_syncs
    with traced():
        _run()
        with named_scope("gfs.test"):
            float(torch.ones(3).sum())
    assert trace.host_syncs == before


@pytest.mark.cuda
def test_host_syncs_count_syncs_inside_program_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.ones(8, device=dev)

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(t):
            return 2 * t

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, g):
            with named_scope("gfs.test.bwd"):
                g.sum().item()  # on autograd's device thread
                return 2 * g

    assert torch.cuda.get_sync_debug_mode() == 0
    with traced():
        assert torch.cuda.get_sync_debug_mode() == 1
        base = trace.host_syncs
        with named_scope("gfs.test"):
            x.sum().item()
        assert trace.host_syncs == base + 1
        x.sum().item()  # outside every program span
        assert trace.host_syncs == base + 1
        Twice.apply(x.clone().requires_grad_()).sum().backward()
        assert trace.host_syncs == base + 2
    assert torch.cuda.get_sync_debug_mode() == 0


def _nkn_model(N=40, device="cpu", dtype=torch.float64):
    """A GPR on the paper's time-series NKN (ops.nkn.NET), whose objective
    takes the one-pass NKN operand on the kernel route."""
    from gpflow_slim_tpu_torch.kernels_nkn import NKN, NKNLinear, NKNProduct

    k = gft.kernels
    prims = [k.Linear(1, variance=2.0), k.Linear(1, variance=4.0), k.Periodic(1, period=0.25, variance=3.0),
             k.Periodic(1, period=0.1, variance=3.0, lengthscales=0.5), k.RBF(1, variance=3.0, lengthscales=0.05),
             k.RBF(1, variance=3.0, lengthscales=0.3),
             k.RationalQuadratic(1, variance=3.0, lengthscales=0.1, alpha=0.5),
             k.RationalQuadratic(1, variance=3.0, lengthscales=0.5, alpha=2.0)]
    kern = NKN(1, prims, [NKNLinear(8, 8), NKNProduct(8, 2), NKNLinear(4, 4), NKNProduct(4, 2), NKNLinear(2, 1)])
    rng = np.random.RandomState(1)
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(12 * X) + 0.1 * rng.randn(N, 1)
    return gft.models.GPR(X, Y, kern=kern, device=device, dtype=dtype)


def _nkn_steps(model):
    step_fn, opt = make_step_fn(model, lambda ps: torch.optim.Adam(ps, lr=0.01))
    losses = [step_fn() for _ in range(2)]
    return [*losses, *(p.grad.clone() for g in opt.param_groups for p in g["params"])]


def test_nkn_operand_spans(kernel_route):
    """The NKN operand's two spans: recorded when traced, the backward's on
    its own; off, no span of the port's is recorded; the results are
    bitwise those of a run with tracing off; no host sync counted."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = _nkn_steps(_nkn_model())
    assert not [n for n in _names(prof) if n.startswith("gfs.")]
    before = trace.host_syncs
    with traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _nkn_steps(_nkn_model())
    assert trace.host_syncs == before
    names = _names(prof)
    assert names.count("gfs.nkn_operand.fwd") == 2 and names.count("gfs.nkn_operand.bwd") == 2
    assert "gfs.gram_operand.fwd" not in names and "gfs.chol_solve_logdet.bwd" in names
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))


@pytest.mark.cuda
def test_nkn_operand_spans_sync_nothing_on_the_card():
    """On the card, float32, the kernel route: the NKN operand's spans hold
    its launches, and host_syncs reads 0 inside them over two Adam steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _nkn_model(N=300, device="cuda", dtype=torch.float32)
    _nkn_steps(model)  # builds and loads the kernels outside the count
    with traced():
        base = trace.host_syncs
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _nkn_steps(model)
            torch.cuda.synchronize()
        assert trace.host_syncs == base
    names = _names(prof)
    assert "gfs.nkn_operand.fwd" in names and "gfs.nkn_operand.bwd" in names
    assert any("nkn_operand_kernel" in n for n in names) and any("nkn_vjp_kernel" in n for n in names)
