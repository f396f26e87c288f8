"""Neural Kernel Network: learn kernel structure (trend + periodicity) from
data, on gpflow_slim_tpu_torch: the twin of
examples/06_nkn_pattern_discovery.py. Runs on the CUDA device in float32
(the hand-written kernels) unless given ``--device cpu``.

Run: python examples/torch/06_nkn_pattern_discovery.py [--device cpu]
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
from gpflow_slim_tpu_torch.kernels_nkn import NKN, NKNLinear, NKNProduct  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

rng = np.random.RandomState(0)
X = np.linspace(0, 2, 200)[:, None]
Y = 0.5 * X + 0.5 * np.sin(8 * X) + 0.05 * rng.randn(200, 1)

primitives = [
    gft.kernels.RBF(1, lengthscales=0.5, name="p_rbf"),
    gft.kernels.Periodic(1, period=0.7, name="p_per"),
    gft.kernels.Linear(1, name="p_lin"),
    gft.kernels.Matern32(1, lengthscales=1.0, name="p_mat"),
]
kern = NKN(1, primitives, [NKNLinear(4, 4, name="l0"), NKNProduct(4, 2, name="l1"), NKNLinear(2, 1, name="l2")])

m = gft.models.GPR(X, Y, kern=kern, device=device, dtype=torch.float32)
m, _ = gft.training.fit(m, num_steps=10 if FAST else 400, learning_rate=0.03)
with torch.no_grad():
    mu, _ = m.predict_f(X)
    objective = m.objective().item()
rmse = float(np.sqrt(np.mean((mu.cpu().numpy() - Y) ** 2)))
gft.utils.print_summary(m.kern.layers[0])
print(f"objective {objective:.1f}, train RMSE {rmse:.4f}")
