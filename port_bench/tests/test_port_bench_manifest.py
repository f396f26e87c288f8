"""BENCHMARK.json against the benchmark's contract: names, units, metric
wiring, files found by name; and the same of BENCHMARK.json with the
entries of ``pending/`` added, so that a held-back cell stays ready to be
admitted."""

import re

import pytest

from port_bench import harness

MANIFEST = harness.load_manifest()
WITH_PENDING = harness.load_manifest(pending=True)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = [w["name"] for w in MANIFEST["workloads"]]
HELD = [m for m in WITH_PENDING["end_to_end"] + WITH_PENDING["per_layer"] if m not in METRICS]
HELD_CELLS = [w["name"] for w in WITH_PENDING["workloads"] if w["name"] not in CELLS]


def _both(cases, held, key):
    """``cases`` of BENCHMARK.json under their own ids, then ``held``, those
    that ``pending/`` adds, under ids that say so."""
    return ([pytest.param(MANIFEST, c, id=key(c)) for c in cases]
            + [pytest.param(WITH_PENDING, c, id=f"pending-{key(c)}") for c in held])


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])


@pytest.mark.parametrize(("manifest", "metric"), _both(METRICS, HELD, lambda m: m["name"]))
def test_metric_fields(manifest, metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES


def test_names_are_unique_and_well_formed():
    for manifest in (MANIFEST, WITH_PENDING):
        for group in ("configs", "workloads"):
            names = [x["name"] for x in manifest[group]]
            assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
        names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
        assert len(names) == len(set(names))
        for w in manifest["workloads"]:
            assert NAME.match(w["traffic"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
        for c in manifest["configs"]:
            assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_bounds():
    for manifest in (MANIFEST, WITH_PENDING):
        for m in manifest["end_to_end"]:
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


@pytest.mark.parametrize(("manifest", "metric"),
                         _both(MANIFEST["per_layer"], [m for m in HELD if "layer" in m], lambda m: m["name"]))
def test_layer_metric_moves_a_metric_its_cells_report(manifest, metric):
    assert "moves" in metric and "workloads" in metric and metric["layer"]
    for w in metric["workloads"]:
        cell = harness.resolve(manifest, w)
        assert metric["moves"] in {m["name"] for m in cell["end_to_end"]}


@pytest.mark.parametrize(("manifest", "workload"), _both(CELLS, HELD_CELLS, lambda w: w))
def test_cell_resolves_and_reports(manifest, workload):
    cell = harness.resolve(manifest, workload)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    assert set(cell["limits"]) and all("limit" in v for v in cell["limits"].values())


def test_check_fits_its_budget():
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s of compilation a cell and 1200 s spare, within 43200 s."""
    cells = 24
    assert (2 + 14 * cells) * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_four_chip_cells_at_most_a_quarter():
    for manifest in (MANIFEST, WITH_PENDING):
        four = sum(w["chips"] == 4 for w in manifest["workloads"])
        assert four <= max(1, len(manifest["workloads"]) // 4)


def test_every_config_is_used_and_every_metric_reported():
    """Each configuration runs some cell, and each end-to-end metric that
    names its cells is reported by at least one, with and without pending/."""
    for manifest in (MANIFEST, WITH_PENDING):
        cells = {w["name"]: w for w in manifest["workloads"]}
        assert {c["name"] for c in manifest["configs"]} <= {w["config"] for w in cells.values()}
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            assert set(m.get("workloads", cells)) <= set(cells) and m.get("workloads", cells)
