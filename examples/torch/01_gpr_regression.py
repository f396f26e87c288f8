"""Exact GPR on a 1-D sinusoid, on gpflow_slim_tpu_torch: the twin of
examples/01_gpr_regression.py. Runs on the CUDA device in float32 (the
hand-written kernels) unless given ``--device cpu``.

Run: python examples/torch/01_gpr_regression.py [--device cpu]
"""

import argparse
import os
import pathlib
import sys

import numpy as np
import torch

FAST = os.environ.get("GFS_EXAMPLE_FAST") == "1"  # tiny sizes for tests/test_torch_examples.py smoke runs

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # the repo root
import gpflow_slim_tpu_torch as gft  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

rng = np.random.RandomState(42)
X = rng.uniform(0, 1, (200, 1))
Y = np.sin(12 * X) + 0.66 * np.cos(25 * X) + rng.randn(200, 1) * 0.1

kernel = gft.kernels.RBF(1, lengthscales=0.1) + gft.kernels.White(1, variance=1e-4)
m = gft.models.GPR(X, Y, kern=kernel, device=device, dtype=torch.float32)
with torch.no_grad():
    print("initial -log p(Y):", m.objective().item())

m, losses = gft.training.fit(m, num_steps=10 if FAST else 1000, learning_rate=0.05)
with torch.no_grad():
    print("final   -log p(Y):", m.objective().item())

    Xt = np.linspace(0, 1, 100)[:, None]
    mean, var = m.predict_y(Xt)
truth = np.sin(12 * Xt) + 0.66 * np.cos(25 * Xt)
rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - truth) ** 2)))
print(f"posterior-mean RMSE vs noiseless truth: {rmse:.4f}")
