"""Coregionalized multi-output regression (the intrinsic model of
coregionalization) on gpflow_slim_tpu_torch: the twin of
examples/10_coregion_multioutput.py.

Output 2 is a noisy, shifted transformation of output 1 and is only
sparsely observed; the Coregion kernel's learned task covariance
``B = W W^T + diag(kappa)`` lets output 1's dense observations inform
output 2's predictions. Augmented inputs: X = [x, task], the kernel is
RBF(x) * Coregion(task), the likelihood is switched per task. Runs on the
CUDA device in float32 (the hand-written kernels) unless given
``--device cpu``.

Run: python examples/torch/10_coregion_multioutput.py [--device cpu]
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

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

rng = np.random.RandomState(0)


def f(x):
    return np.sin(6 * x)


# dense observations of task 0, sparse of task 1 (correlated: a shared latent)
X1 = rng.rand(60, 1)
Y1 = f(X1) + 0.05 * rng.randn(60, 1)
X2 = rng.rand(8, 1)
Y2 = -1.3 * f(X2) + 0.1 + 0.05 * rng.randn(8, 1)

# augmented inputs and outputs: the last column is the task index
X_aug = np.vstack([np.hstack([X1, np.zeros_like(X1)]), np.hstack([X2, np.ones_like(X2)])])
Y_aug = np.vstack([np.hstack([Y1, np.zeros_like(Y1)]), np.hstack([Y2, np.ones_like(Y2)])])

k_input = gft.kernels.RBF(1, active_dims=[0], lengthscales=0.3)
k_task = gft.kernels.Coregion(1, output_dim=2, rank=1, active_dims=[1], W=0.5 * np.ones((2, 1)))
kern = k_input * k_task
lik = SwitchedLikelihood([Gaussian(name="t0"), Gaussian(name="t1")])

m = gft.models.VGP(X_aug, Y_aug, kern=kern, likelihood=lik, num_latent=1, device=device, dtype=torch.float32)
m, losses = gft.training.fit(m, num_steps=10 if FAST else 1500, learning_rate=0.02)

with torch.no_grad():
    B = m.kern.kernels[1]._B().cpu().double().numpy()
    # the task correlation implied by the learned coregionalization matrix
    corr = B[0, 1] / np.sqrt(B[0, 0] * B[1, 1])
    print(f"learned task covariance B = {np.round(B, 3).tolist()}")
    print(f"implied task correlation: {corr:+.3f} (ground truth strongly "
          f"negative: task2 = -1.3*task1 + const)")

    # prediction for the sparse task at unseen inputs, informed by task 0
    xs = np.linspace(0, 1, 7)[:, None]
    mu, var = m.predict_f(np.hstack([xs, np.ones_like(xs)]))
true = -1.3 * f(xs) + 0.1
rmse = float(np.sqrt(np.mean((mu.cpu().numpy() - true) ** 2)))
print(f"task-1 prediction RMSE from 8 observations: {rmse:.3f} "
      f"(sigma ~ {float(torch.sqrt(var).mean()):.3f})")
