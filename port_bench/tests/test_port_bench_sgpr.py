"""The SGPR cell (``sgpr-m512-n910k-train``): the readers' work counts, the
reference's leaves against the loop's, whole runs at a tiny size on the
CPU (the program's plain route there: a sound run comes out correct, a step
that changes nothing not), and on the card the control, which must fail
the cell's limits at the cell's own size."""

import math

import pytest

from port_bench import faults, harness

WORKLOAD = "sgpr-m512-n910k-train"
TINY = {"config": {"num_inducing": 24}, "traffic": {"n": 300}}
REF = harness.load_file(harness.BENCH / "reference" / "sgpr-m512-matern32-d11.py", "ref_sgpr")
TRSM = harness.load_file(harness.BENCH / "metrics" / "sgpr_train.trsm_roofline.py", "sgpr_trsm_roofline")
MFU = harness.load_file(harness.BENCH / "metrics" / "sgpr_train.mfu.py", "sgpr_mfu")


def _cell():
    return harness.resolve(harness.load_manifest(), WORKLOAD)


def test_cell_resolves_to_its_files():
    cell = _cell()
    assert cell["config"]["num_inducing"] == 512 and cell["config"]["input_dim"] == 11
    assert cell["traffic"]["n"] == 910791 == 2049280 * 4 // 9
    assert {m["name"] for m in cell["end_to_end"]} == {"gpr_train_evals_per_s", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {"sgpr_train.trsm_roofline", "sgpr_train.backward_ms",
                                                      "sgpr_train.mfu", "sgpr_train.idle_share"}
    assert set(cell["limits"]) == {"loss", "grad", "change"}


def test_leaves_are_the_loops():
    loop = harness.load_file(harness.BENCH / "loops" / "sgpr_fit.py", "loop_sgpr")
    assert sorted(loop.LEAVES.values()) == sorted(REF.LEAVES)


def test_trsm_work_counts_the_solves():
    """Two solves at P = N (L^-1 Kuf and its VJP), two at P = 1 (LB^-1 (A
    err) and its VJP), four at P = M (Murray's VJP of the two factors);
    each M^2 P flop and the triangle plus the M x P right side read and
    written once, float32."""
    cfg = _cell()["config"]
    work = TRSM.work(cfg, 910791)
    tri = 512 * 513 // 2
    assert sorted(work) == sorted([(512**2 * 910791, (tri + 2 * 512 * 910791) * 4)] * 2
                                  + [(512**2, (tri + 1024) * 4)] * 2 + [(512**3, (tri + 2 * 512**2) * 4)] * 4)


def test_mfu_flop_count():
    cfg = _cell()["config"]
    m, n, d = 512, 910791, 11
    assert MFU.flop(cfg, n) == 3 * (2 * m * m * n + 2 * m**3 / 3 + 3 * m * n * d)
    assert 1.4e12 < MFU.flop(cfg, n) < 1.5e12


@pytest.mark.parametrize("fault", [None, "unchanged"])
def test_fault_makes_the_run_incorrect(fault, one_thread):
    if fault is None:
        r = harness.run_cell(WORKLOAD, 2**31 + 77, 0.3, 0, "cpu", overrides=TINY)
        assert r["correct"], r["checks"]
    else:
        with faults.FAULTS[fault]():
            r = harness.run_cell(WORKLOAD, 2**31 + 77, 0.3, 0, "cpu", overrides=TINY)
        assert not r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and math.isfinite(r["metrics"]["gpr_train_evals_per_s"]["value"])


def test_traced_run_reads_no_device_metric_on_the_cpu(one_thread):
    r = harness.run_cell(WORKLOAD, 2**31 + 78, 0.5, 1, "cpu", overrides=TINY)
    assert r["correct"] and r["device"]["busy_s"] == 0
    assert set(r["metrics"]) == {"sgpr_train.mfu"}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 2**31 + 5])
def test_control_is_not_correct(seed, card):
    cell = _cell()
    loop = harness.load_file(cell["files"]["loop"], f"loop_{WORKLOAD}")
    env = harness.Env(cell, seed, "cuda", harness.Tracer(False))
    rows, ok = harness.judge(loop.control(env), cell["limits"])
    assert not ok, rows
