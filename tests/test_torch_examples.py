"""Smoke runs of the port's example twins (examples/torch/*.py), as
tests/test_examples.py runs the JAX package's examples: each in a
subprocess on the CPU (``--device cpu``) with ``GFS_EXAMPLE_FAST=1`` (few
steps); the test asserts a clean exit and the example's result lines, not
their quality."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples" / "torch").glob("*.py"))
# a line each example prints last
LAST_LINE = {"01_gpr_regression.py": "posterior-mean RMSE vs noiseless truth",
             "02_svgp_classification.py": "ELBO:",
             "03_nuts_hyperparameters.py": "posterior noise variance: median=",
             "04_distributed_gpr.py": "matches single-device: True",
             "05_deep_kernel.py": "objective",
             "06_nkn_pattern_discovery.py": "objective",
             "07_serving_posterior.py": "pred mean range:",
             "08_gplvm_latent_discovery.py": "BGPLVM",
             "09_grouped_data_switched.py": "learned offsets",
             "10_coregion_multioutput.py": "task-1 prediction RMSE"}


def test_every_twin_is_listed():
    assert sorted(p.name for p in EXAMPLES) == sorted(LAST_LINE)


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.name for p in EXAMPLES])
def test_torch_example_runs(path):
    env = dict(os.environ, GFS_EXAMPLE_FAST="1")
    proc = subprocess.run([sys.executable, str(path), "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, (
        f"{path.name} exited {proc.returncode}\n"
        f"--- stdout ---\n{proc.stdout[-2000:]}\n"
        f"--- stderr ---\n{proc.stderr[-2000:]}"
    )
    assert proc.stdout.strip().splitlines()[-1].startswith(LAST_LINE[path.name]), proc.stdout
