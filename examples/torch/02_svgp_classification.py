"""SVGP binary classification with natural gradients (BASELINE config #3
shape, scaled down), on gpflow_slim_tpu_torch: the twin of
examples/02_svgp_classification.py. Runs on the CUDA device in float32
(the hand-written kernels) unless given ``--device cpu``.

Run: python examples/torch/02_svgp_classification.py [--device cpu]
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

rng = np.random.RandomState(0)
N = 200 if FAST else 2000
X = rng.uniform(0, 1, (N, 1))
Y = (np.sin(10 * X) > 0).astype(float)

m = gft.models.SVGP(
    X, Y,
    kern=gft.kernels.RBF(1, lengthscales=0.2),
    likelihood=gft.likelihoods.Bernoulli(),
    Z=np.linspace(0, 1, 32)[:, None],
    device=device, dtype=torch.float32,
)

m, losses = gft.training.fit_svgp_natgrad(
    m, num_steps=5 if FAST else 300, generator=torch.Generator(device=device).manual_seed(0),
    gamma=0.2, learning_rate=0.05, batch_size=64 if FAST else 256,
)

with torch.no_grad():
    p, _ = m.predict_y(X)
    elbo = m.build_likelihood().item()
acc = float(np.mean((p.cpu().numpy() > 0.5) == (Y > 0.5)))
print(f"ELBO: {elbo:.1f}   accuracy: {acc:.3f}")
