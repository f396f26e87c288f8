"""The command itself: no card, no program, a cell added from new files
alone, and no module of JAX in a run."""

import json
import shutil
import subprocess
import sys

import pytest

from port_bench import harness

ROOT = harness.ROOT
RUN = ["python3", "port_bench/run.py"]


def _run(args, cwd=ROOT, env=None):
    return subprocess.run(RUN + args, cwd=cwd, capture_output=True, text=True, timeout=240, env=env)


def _no_result(out):
    return not any(line.strip().startswith("{") for line in out.splitlines())


def test_measuring_run_without_a_card_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(["--workload", "gpr-n10k-train", "--seed", "2147483999", "--seconds", "1", "--trace", "0"])
    assert p.returncode != 0 and _no_result(p.stdout)
    assert "CUDA device" in p.stderr


def test_run_without_the_program_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and port_bench/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "gpr-n10k-train", "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path)
    assert p.returncode != 0 and _no_result(p.stdout)
    assert "gpflow_slim_tpu_torch" in p.stderr


def test_a_cell_from_new_files_alone_is_listed(tmp_path):
    """A dummy configuration, traffic mix, limits and metric, as new files
    and new manifest entries, with no file of the benchmark edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "port_bench"
    (b / "configs" / "dummy-cfg.json").write_text(json.dumps({"name": "dummy-cfg", "lengthscale": 0.5}))
    shutil.copy(b / "reference" / "gpr-rbf-d1.py", b / "reference" / "dummy-cfg.py")
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps({"loop": "gpr_fit", "n": 64}))
    (b / "limits" / "dummy-cell.json").write_text(json.dumps({"loss": {"limit": 1e-3}}))
    (b / "metrics" / "dummy.metric.py").write_text("def read(ctx):\n    return None\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "dummy-cfg", "source": "https://example.org", "file": "port_bench/configs/dummy-cfg.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "dummy-cell", "config": "dummy-cfg", "traffic": "dummy-mix", "chips": 1,
                           "why": "a test"})
    m["end_to_end"][0]["workloads"].append("dummy-cell")
    m["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": m["end_to_end"][0]["name"], "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    p = _run(["--list"], cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    cells = {c["workload"]: c for c in map(json.loads, p.stdout.splitlines())}
    assert set(cells) == {w["name"] for w in m["workloads"]}
    files = cells["dummy-cell"]["files"]
    assert files["traffic"] == "port_bench/traffic/dummy-mix.json"
    assert files["dummy.metric"] == "port_bench/metrics/dummy.metric.py"


def test_a_run_loads_no_module_of_jax():
    """A whole run of a cell at a tiny size on the CPU, in a fresh process:
    no module whose top-level name is jax, jaxlib, flax or gpflow_slim_tpu
    (compared whole), and the reference alone loads nothing of the port."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from port_bench import harness\n"
        "ref = harness.load_file(harness.BENCH / 'reference' / 'gpr-rbf-d1.py', 'r')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "harness.run_cell('gpr-n10k-serve', 3, 0.2, 1, 'cpu', overrides=%r)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(ROOT), {"traffic": {"n": 100, "max_points": 16, "block": 8, "pool": 50, "sample": 4}})
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    before, after = (set(json.loads(line)) for line in p.stdout.splitlines()[-2:])
    assert "gpflow_slim_tpu_torch" not in before and "gpflow_slim_tpu_torch" in after
    assert not after & set(harness.FORBIDDEN)


def test_sources_read_nothing_outside_the_benchmark():
    """No file of the harness imports or names JAX, the JAX package,
    bench.py, benchmarks/, chip_smoke.py or tools/ in its code."""
    import ast

    for f in (ROOT / "port_bench").rglob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "flax", "gpflow_slim_tpu", "bench", "benchmarks",
                                     "chip_smoke", "tools"}, f
