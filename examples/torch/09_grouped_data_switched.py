"""Grouped observations: per-group noise and per-group mean in one GP, on
gpflow_slim_tpu_torch: the twin of examples/09_grouped_data_switched.py.

Two sensor groups measure the same latent function; group 1 is noisier and
has a constant offset. The group index rides in the last column of X and
Y; ``SwitchedLikelihood`` gives each group its own noise variance and
``SwitchedMeanFunction`` its own mean, all trained jointly with a VGP. Runs
on the CUDA device in float32 (the hand-written kernels) unless given
``--device cpu``.

Run: python examples/torch/09_grouped_data_switched.py [--device cpu]
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
from gpflow_slim_tpu_torch.likelihoods import Gaussian, SwitchedLikelihood  # noqa: E402
from gpflow_slim_tpu_torch.mean_functions import Constant, SwitchedMeanFunction  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

rng = np.random.RandomState(0)
N = 120
x = rng.uniform(0, 1, (N, 1))
group = (rng.rand(N) < 0.5).astype(float)  # about half the points per group
f = np.sin(8 * x[:, 0])
noise = np.where(group == 0, 0.05, 0.3)
offset = np.where(group == 0, 0.0, 1.5)
y = (f + offset + noise * rng.randn(N))[:, None]

# the reference's convention: the group index rides in the last column of
# both X (read by SwitchedMeanFunction) and Y (read by SwitchedLikelihood)
X = np.concatenate([x, group[:, None]], axis=1)
Y = np.concatenate([y, group[:, None]], axis=1)

lik = SwitchedLikelihood([Gaussian(name="g0"), Gaussian(name="g1")])
mean = SwitchedMeanFunction([Constant(0.0, name="m0"), Constant(0.0, name="m1")])
kern = gft.kernels.RBF(1, active_dims=[0], lengthscales=0.2)
m = gft.models.VGP(X, Y, kern=kern, likelihood=lik, mean_function=mean, num_latent=1, device=device,
                   dtype=torch.float32)

m, losses = gft.training.fit(m, num_steps=10 if FAST else 1500, learning_rate=0.02)

s0, s1 = (lk.variance.value.item() for lk in m.likelihood.likelihood_list)
c0, c1 = (mf.c.value.item() for mf in m.mean_function.meanfunctions)
print(f"learned noise std: group0 {np.sqrt(s0):.3f} (true 0.05), "
      f"group1 {np.sqrt(s1):.3f} (true 0.30)")
print(f"learned offsets  : group0 {c0:+.3f} (true +0.0), "
      f"group1 {c1:+.3f} (true +1.5)")
