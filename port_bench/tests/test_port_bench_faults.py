"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: a sound run comes out correct, and each fault the cell can
have, planted in the program's timed path, comes out not correct."""

import pytest
from conftest import TINY, manifest

from port_bench import faults, harness

FAULTS = {
    "gpr-n10k-train": ["unchanged", "half_batch"],
    "gpr-n2k-train": ["unchanged", "half_batch"],
    "svgp-n100k-train": ["unchanged", "half_batch"],
    "gpr-n10k-serve": ["altered"],
}
CASES = [(w, f) for w, fs in FAULTS.items() for f in [None, *fs]]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f or 'sound'}" for w, f in CASES])
def test_fault_makes_the_run_incorrect(workload, fault, one_thread):
    if fault is None:
        r = harness.run_cell(workload, 2**31 + 77, 0.3, 0, "cpu", overrides=TINY[workload], manifest=manifest())
        assert r["correct"], r["checks"]
    else:
        with faults.FAULTS[fault]():
            r = harness.run_cell(workload, 2**31 + 77, 0.3, 0, "cpu", overrides=TINY[workload], manifest=manifest())
        assert not r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", list(FAULTS))
def test_traced_run_reads_its_layer_metrics(workload, one_thread):
    """A traced run on the CPU: spans and the profiled slice work; device
    metrics find nothing to read there, so they are left out."""
    r = harness.run_cell(workload, 2**31 + 78, 0.5, 1, "cpu", overrides=TINY[workload], manifest=manifest())
    assert r["correct"]
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    assert not any("idle_share" in k or "roofline" in k for k in r["metrics"])
