"""``spans``: idle gaps named by the late launch's span, the readers of
``pending/program-spans.json`` on synthetic traces, and a traced run on
the CPU with ``ProgramTracer``."""

import json
import random

import pytest

from port_bench import harness, spans

from conftest import TINY

PENDING = json.loads((harness.BENCH / "pending" / "program-spans.json").read_text())["per_layer"]
READERS = {m["name"]: harness.load_file(harness.BENCH / "metrics" / f"{m['name']}.py", f"spans_{m['name']}")
           for m in PENDING}
MAIN = 1  # thread ids as the profiler numbers them
AUTOGRAD = 2

# two steps; the device's times (us) and the host's launches share one clock
SPANS = [
    ("step.forward", 0, 100, MAIN), ("gfs.gpr.likelihood", 5, 95, MAIN),
    ("step.backward", 100, 400, MAIN),
    ("gfs.chol_solve_logdet.bwd", 110, 300, AUTOGRAD), ("gfs.trsm.fwd", 150, 160, AUTOGRAD),
    ("gfs.gram_operand.bwd", 310, 390, AUTOGRAD),
    ("step.forward", 500, 600, MAIN), ("gfs.gpr.likelihood", 505, 595, MAIN),
]
# (name, device start, device end) and each one's launch (host time, thread)
DEVICE = [("k_fwd", 20, 90, None), ("k_gemm", 120, 200, (115, AUTOGRAD)), ("k_trsm", 230, 260, (155, AUTOGRAD)),
          ("k_elem", 320, 330, (315, AUTOGRAD)), ("k_op", 325, 380, (320, AUTOGRAD)),
          ("k_fwd2", 520, 560, (510, MAIN)), ("k_late", 700, 710, (690, 7))]


def _trace(units=2, syncs=0, program=True):
    device = [d[:3] for d in DEVICE]
    launch = [d[3] for d in DEVICE]
    merged = harness.union(device)
    prog = [s for s in SPANS if s[0].startswith(spans.PREFIX)] if program else []
    every = [s for s in SPANS if program or not s[0].startswith(spans.PREFIX)]
    return {"device": device, "launch": launch, "program_spans": prog, "gaps": spans.idle_gaps(device, launch, every),
            "units": units, "host_syncs": syncs if program else None, "busy_s": sum(e - s for s, e in merged) / 1e6,
            "wall_s": (merged[-1][1] - merged[0][0]) / 1e6, "sizes": [], "spans": []}


def test_gaps_are_named_by_the_late_launchs_innermost_span():
    gaps = {DEVICE[g[1]][0]: g for g in _trace()["gaps"]}
    # k_trsm's launch lies in gfs.trsm.fwd nested in the Cholesky's backward, on autograd's thread
    assert gaps["k_trsm"][0] == 30 and gaps["k_trsm"][2] == ("gfs.trsm.fwd", "gfs.chol_solve_logdet.bwd")
    assert gaps["k_elem"][2] == ("gfs.gram_operand.bwd",)
    # the middle of k_gemm's gap (105) lies in step.backward; its launch does not
    assert gaps["k_gemm"][2] == ("gfs.chol_solve_logdet.bwd",) and not gaps["k_gemm"][4]
    # a thread with no span: named by the spans of any thread that hold the launch (none here)
    assert gaps["k_late"][2] == () and gaps["k_late"][3] == ()
    assert list(gaps) == sorted(gaps, key=lambda n: -gaps[n][0])  # longest first


def test_a_gap_without_a_launch_falls_back_to_its_middle():
    device = [("a", 0, 10), ("b", 500, 510)]
    gaps = spans.idle_gaps(device, [None, None], SPANS)
    assert len(gaps) == 1 and gaps[0][4]  # counted as a fallback
    # the middle, 255, on any thread, where the old rule named step.backward alone
    assert gaps[0][2] == () and gaps[0][3] == ("gfs.chol_solve_logdet.bwd", "step.backward")


def test_holders_match_a_scan_over_every_span():
    rng = random.Random(5)
    sp = []
    for _ in range(300):
        s = rng.uniform(0, 1000)
        sp.append((f"s{len(sp)}", s, s + rng.expovariate(1 / 30), rng.choice((1, 2))))
    pts = [(rng.uniform(0, 1100), rng.choice((1, 2, 3))) for _ in range(500)]
    got = spans.holders(sp, pts)
    for (t, th), h in zip(pts, got):
        want = sorted((x for x in sp if x[3] == th and x[1] <= t <= x[2]), key=lambda x: x[2] - x[1])
        assert h == tuple(x[0] for x in want)


def test_readers_on_a_synthetic_trace():
    ctx = {"trace": _trace(units=2, syncs=3), "stats": {}}
    read = {n: r.read(ctx) for n, r in READERS.items()}
    # k_gemm and k_trsm: 80 + 30 us over 2 steps; k_elem and k_op overlap: 320..380
    assert read["gpr_train.chol_vjp_ms"] == pytest.approx(0.055)
    assert read["gpr_train.operand_vjp_ms"] == pytest.approx(0.030)
    # gaps ended inside either VJP: 30 (k_gemm) + 30 (k_trsm) + 60 (k_elem) us
    assert read["gpr_train_small.backward_idle_ms"] == pytest.approx(0.060)
    assert read["gpr_train_small.host_syncs_per_step"] == 1.5
    assert read["gpr_serve.host_syncs_per_request"] == 1.5
    assert read["gpr_serve.predict_idle_ms"] is None  # no gfs.posterior.predict_f span in the slice


def test_readers_return_none_without_device_work_or_program_spans():
    for t in (None, {**_trace(), "device": [], "launch": [], "gaps": []}, _trace(program=False)):
        ctx = {"trace": t, "stats": {}}
        assert {n: r.read(ctx) for n, r in READERS.items()} == dict.fromkeys(READERS)


def test_clock_reads_offset_and_drift():
    # launch latency 7 us, the device's clock 400 ppm fast, a queue of 50 us
    # before a third of the operations
    rng = random.Random(1)
    host = [100.0 * i for i in range(400)]
    starts = [t + 7 + 4e-4 * t + rng.choice((0, 0, 50)) for t in host]
    device = [("k", s, s + 20) for s in starts]
    launch = [(t, 1) for t in host]
    c = spans.clock(device, launch)
    assert c["min_us"] == pytest.approx(7)
    assert c["drift_ppm"] == pytest.approx(400, rel=0.02)
    assert spans.clock(device[:5], launch[:5]) is None


def test_host_self_takes_out_what_contained_spans_cover():
    rows = dict(spans.host_self(SPANS, units=2))
    # step.forward: 100 us less gfs.gpr.likelihood's 90, twice; over 2 steps, in ms
    assert rows["step.forward"] == pytest.approx(0.010)
    assert rows["gfs.chol_solve_logdet.bwd"] == pytest.approx((190 - 10) / 2e3)
    assert rows["step.backward"] == pytest.approx(0.150)  # the backward's spans lie on another thread


def test_pending_entries_are_well_formed():
    manifest = harness.load_manifest(pending=True)
    layers = {m["layer"] for m in harness.load_manifest()["per_layer"]}
    for m in PENDING:
        assert m["source"] in ("program_span", "program_counter") and m["layer"] in layers
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for w in m["workloads"]:
            cell = harness.resolve(manifest, w)
            assert m["moves"] in {e["name"] for e in cell["end_to_end"]}
            assert m["name"] in cell["readers"]


@pytest.mark.parametrize("workload", ["gpr-n2k-train", "gpr-n10k-serve"])
def test_a_traced_cpu_run_keeps_every_key(workload, one_thread):
    base = harness.run_cell(workload, 2147483999, 0.3, 1, "cpu", overrides=TINY[workload],
                            manifest=harness.load_manifest(pending=True))
    got = spans.run_cell(workload, 2147483999, 0.3, 1, device="cpu", overrides=TINY[workload])
    assert set(base) <= set(got) and set(base["breakdown"]) <= set(got["breakdown"])
    assert set(base["device"]) <= set(got["device"]) and got["correct"]
    assert {"host_self", "clock", "launch_fallbacks"} <= set(got["breakdown"])
    # the CPU profile has no device work: the new readers find nothing
    assert not set(got["metrics"]) & set(READERS)
    assert spans.program_trace() is not None and not spans.program_trace().enabled()
