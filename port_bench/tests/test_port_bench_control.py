"""The control on the card: the reference put in the program's place in
float32 with TF32 on (the program's float32 runs with TF32 off) fails the
cell's limits, at the cells' own sizes (each fits a test run on the card:
the f64 reference of N=10000 takes seconds). The readings that set the
limits came from calibrate.py, on more seeds."""

import pytest
from conftest import TINY, manifest

from port_bench import harness

pytestmark = pytest.mark.cuda
CELLS = ["gpr-n10k-train", "gpr-n2k-train", "svgp-n100k-train", "gpr-n10k-serve", "nkn-n10k-train"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [101, 2**31 + 5])
def test_control_is_not_correct(workload, seed, card):
    cell = harness.resolve(manifest(), workload)
    loop = harness.load_file(cell["files"]["loop"], f"loop_{workload}")
    env = harness.Env(cell, seed, "cuda", harness.Tracer(False))
    rows, ok = harness.judge(loop.control(env), cell["limits"])
    assert not ok, rows


def test_every_cell_has_a_control_and_a_tiny_size():
    assert set(TINY) == set(CELLS) == {w["name"] for w in manifest()["workloads"]}
