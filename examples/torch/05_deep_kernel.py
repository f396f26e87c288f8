"""Deep kernel: MLP-warped inputs trained jointly with the GP hyperparameters,
on gpflow_slim_tpu_torch: the twin of examples/05_deep_kernel.py. Runs on
the CUDA device in float32 (the hand-written kernels) unless given
``--device cpu``.

Run: python examples/torch/05_deep_kernel.py [--device cpu]
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
from gpflow_slim_tpu_torch.kernels_deep import DeepKernel, mlp_warp  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

rng = np.random.RandomState(0)
N = 300
X = rng.uniform(-1, 1, (N, 2))
Y = np.sin(3 * (X[:, :1] + 0.5 * X[:, 1:2])) + 0.05 * rng.randn(N, 1)

kern = DeepKernel(2, gft.kernels.RBF(1, lengthscales=0.5), mlp_warp([2, 16, 1], torch.Generator().manual_seed(0)))
m = gft.models.GPR(X, Y, kern=kern, device=device, dtype=torch.float32)

m, losses = gft.training.fit(m, num_steps=10 if FAST else 500, learning_rate=0.02)
with torch.no_grad():
    mu, _ = m.predict_f(X)
    objective = m.objective().item()
rmse = float(np.sqrt(np.mean((mu.cpu().numpy() - Y) ** 2)))
print(f"objective {objective:.1f}, train RMSE {rmse:.4f}")
