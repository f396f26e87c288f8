"""The spread arithmetic of spread.py, what a run records of the host, and
how a cell held back in ``pending/`` is run, on the CPU."""

import json
import statistics
import subprocess

from port_bench import harness, run, spread


def test_spread_is_the_quartiles_over_the_median():
    values = [100.0, 101.0, 99.0, 104.0, 98.0, 100.5]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert spread.spread(values) == (q3 - q1) / statistics.median(values)
    rows = spread.summary([{"workload": "w", "root": "r", "set": s, "metrics": {"rate": v * (1 + s)}}
                           for s in (0, 1) for v in values])
    (row,) = rows
    assert row["widest"] == max(row["sets"][0]["spread"], row["sets"][1]["spread"])
    assert row["five_times"] == 5 * row["widest"] and row["sets"][1]["median"] == 2 * row["sets"][0]["median"]


def test_trimmed_spread_leaves_out_the_farthest_run():
    values = [100.0, 101.0, 99.0, 100.5, 99.5, 160.0]
    assert spread.trimmed_spread(values) == spread.spread([100.0, 101.0, 99.0, 100.5, 99.5])
    rows = spread.summary([{"workload": "w", "root": "r", "set": s, "metrics": {"rate": v}}
                           for s in (0, 1) for v in values])
    assert rows[0]["trimmed_mean"] == spread.trimmed_spread(values) < rows[0]["widest"]


def test_host_steps_median_longest_and_stalls():
    stamps = [0.01, 0.02, 0.03, 0.04, 0.10, 0.11]
    h = harness.host_steps(stamps)
    assert abs(h["median_ms"] - 10) < 1e-9 and abs(h["max_ms"] - 60) < 1e-9
    assert h["over_5x"] == 1 and abs(h["over_5x_ms"] - 60) < 1e-9
    assert harness.host_steps([]) is None


def test_list_with_pending_adds_the_held_back_cells(capsys):
    listed = {w["name"] for w in harness.load_manifest()["workloads"]}
    assert run.main(["--list"]) == 0
    plain = {json.loads(line)["workload"] for line in capsys.readouterr().out.splitlines()}
    assert run.main(["--list", "--pending"]) == 0
    held = {json.loads(line)["workload"] for line in capsys.readouterr().out.splitlines()}
    assert plain == listed and held > plain
    assert {"svgp-n100k-train", "gpr-n2k-train"} <= held - plain


def test_run_one_asks_for_pending_only_where_the_cell_is_held_back(monkeypatch):
    calls = []

    def fake(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout='{"correct": true, "metrics": {}}\n', stderr="")

    monkeypatch.setattr(spread.subprocess, "run", fake)
    listed = harness.load_manifest()["workloads"][0]["name"]
    for workload in (listed, "svgp-n100k-train"):
        rec = spread.run_one(harness.ROOT, workload, 7, 1)
        assert rec["correct"] and rec["rc"] == 0
    assert "--pending" not in calls[0] and "--pending" in calls[1]
    assert calls[1][calls[1].index("--workload") + 1] == "svgp-n100k-train"
