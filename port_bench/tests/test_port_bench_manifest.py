"""BENCHMARK.json against the benchmark's contract: names, units, metric
wiring, files found by name."""

import re

import pytest

from port_bench import harness

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MANIFEST[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_bounds():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_moves_a_metric_its_cells_report(metric):
    assert "moves" in metric and "workloads" in metric and metric["layer"]
    for w in metric["workloads"]:
        cell = harness.resolve(MANIFEST, w)
        assert metric["moves"] in {m["name"] for m in cell["end_to_end"]}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_and_reports(workload):
    cell = harness.resolve(MANIFEST, workload)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    assert set(cell["limits"]) and all("limit" in v for v in cell["limits"].values())


def test_check_fits_its_budget():
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s of compilation a cell and 1200 s spare, within 43200 s."""
    cells = 24
    assert (2 + 14 * cells) * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)
