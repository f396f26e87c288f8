"""The NKN cell (``nkn-n10k-train``): its plain reference against closed
forms and finite differences in float64, the roofline reader's work count,
and whole runs at a tiny size on the CPU (the program's composite route
there): a sound run comes out correct, each fault not."""

import json
import math

import numpy as np
import pytest
import torch

from conftest import TINY

from port_bench import faults, harness

NKN = harness.load_file(harness.BENCH / "reference" / "gpr-nkn8-d1.py", "ref_nkn")
CFG = json.loads((harness.BENCH / "configs" / "gpr-nkn8-d1.json").read_text())
ROOFLINE = harness.load_file(harness.BENCH / "metrics" / "nkn_train.operand_roofline.py", "nkn_roofline")
F64 = torch.float64


def _u(values):
    return {k: torch.as_tensor(np.log(np.expm1(np.asarray(v, np.float64) - CFG["positive_minimum"])), dtype=F64)
            for k, v in values.items()}


def test_leaves_are_the_loops_22():
    loop = harness.load_file(harness.BENCH / "loops" / "nkn_fit.py", "loop_nkn")
    start = NKN.start(CFG, 5)
    assert NKN.leaves(CFG) == list(start) and sorted(loop.LEAVES.values()) == sorted(start)
    assert len(start) == 22 and sum(np.size(v) for v in start.values()) == 101
    w = start["layer0.weights"]
    assert w.shape == (8, 8) and 0.2 / 8 <= w.min() and w.max() <= 1.0 / 8
    assert not np.array_equal(w, NKN.start(CFG, 6)["layer0.weights"])


def test_gram_at_one_point_is_the_network_of_the_primitives():
    """K(x, x) from the equations: each primitive's value at d = 0, then the
    layers by hand."""
    v = NKN.start(CFG, 3)
    x = 0.7
    prims = []
    for p in CFG["primitives"]:
        prims.append(v[f"{p['name']}.variance"] * (x * x if p["kind"] == "Linear" else 1.0))
    W0, W2, W4 = (np.asarray(v[f"layer{i}.weights"]) for i in (0, 2, 4))
    h = W0 @ np.array(prims)
    h = W2 @ (h[0::2] * h[1::2])
    want = float(W4 @ (h[0::2] * h[1::2]))
    got = NKN.gram(CFG, torch.tensor([[x]], dtype=F64), {k: torch.as_tensor(t, dtype=F64) for k, t in v.items()})
    assert abs(float(got) - want) < 1e-12 * abs(want)


def test_objective_gradient_finite_differences():
    X, Y = (torch.as_tensor(a, dtype=F64) for a in NKN.data(CFG, 9, seed=3))
    u = _u(NKN.start(CFG, 3))
    leaves = {k: t.clone().requires_grad_() for k, t in u.items()}
    g = dict(zip(leaves, torch.autograd.grad(NKN.objective(X, Y, leaves, CFG), list(leaves.values()))))
    h = 1e-6
    for k, idx in (("per1.period", ()), ("rq0.alpha", ()), ("layer2.weights", (1, 3)), ("noise_variance", ())):
        up = {j: t.clone() for j, t in u.items()}
        dn = {j: t.clone() for j, t in u.items()}
        up[k][idx] += h
        dn[k][idx] -= h
        fd = (NKN.objective(X, Y, up, CFG) - NKN.objective(X, Y, dn, CFG)) / (2 * h)
        assert abs(float(g[k][idx]) - float(fd)) < 1e-6 * max(1, abs(float(fd))), k


def test_roofline_work_counts_the_configuration():
    """Per entry: 4 x (64 + 16 + 2) multiply-adds of the Linear layers, 18
    of the primitives' parameters, 24 multiplies of the Product layers; the
    padded operand written and the cotangent read, float32."""
    flop, nbytes = ROOFLINE.work(CFG, 10000)
    tri = 10000 * 10001 // 2
    assert flop == tri * (2 * (4 * 82 + 18) + 24)
    assert nbytes == 4 * (10048 * 10049 // 2 + tri)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_fault_makes_the_run_incorrect(fault, one_thread):
    if fault is None:
        r = harness.run_cell("nkn-n10k-train", 2**31 + 77, 0.3, 0, "cpu", overrides=TINY["nkn-n10k-train"])
        assert r["correct"], r["checks"]
    else:
        with faults.FAULTS[fault]():
            r = harness.run_cell("nkn-n10k-train", 2**31 + 77, 0.3, 0, "cpu", overrides=TINY["nkn-n10k-train"])
        assert not r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and math.isfinite(r["metrics"]["gpr_train_evals_per_s"]["value"])


def test_traced_run_reads_no_device_metric_on_the_cpu(one_thread):
    r = harness.run_cell("nkn-n10k-train", 2**31 + 78, 0.5, 1, "cpu", overrides=TINY["nkn-n10k-train"])
    assert r["correct"] and r["device"]["busy_s"] == 0
    assert set(r["metrics"]) == {"nkn_train.mfu"}
