"""GP-LVM: latent structure discovered from 12-dimensional observations
driven by a 2-D latent manifold, on gpflow_slim_tpu_torch: the twin of
examples/08_gplvm_latent_discovery.py. GPLVM (MAP latents, PCA-initialized)
and BayesianGPLVM (variational q(X), inducing points, psi-statistics). Runs
on the CUDA device in float32 (the hand-written kernels) unless given
``--device cpu``.

Run: python examples/torch/08_gplvm_latent_discovery.py [--device cpu]
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
N, P, Q = 80, 12, 2
X_true = rng.randn(N, Q)
W = rng.randn(Q, P)
Y = np.tanh(X_true @ W) + 0.05 * rng.randn(N, P)


def latent_r2(X):
    A = np.linalg.pinv(X) @ X_true  # the best linear alignment to the true latents
    return 1 - np.sum((X @ A - X_true) ** 2) / np.sum(X_true ** 2)


# MAP GPLVM
m = gft.models.GPLVM(Y, latent_dim=Q, device=device, dtype=torch.float32)
m, losses = gft.training.fit(m, num_steps=10 if FAST else 800, learning_rate=0.01)
X_map = m.X.value.detach().cpu().numpy().astype(np.float64)
print(f"GPLVM     : objective {float(losses[-1]):.1f}, latent R^2 {latent_r2(X_map):.3f}")

# Bayesian GPLVM; lr 0.005: inducing points chasing moving latents need gentler steps (f32)
X0 = gft.models.pca_reduce(Y, Q)
mb = gft.models.BayesianGPLVM(X0, np.full((N, Q), 0.1), Y, gft.kernels.RBF(Q, ARD=True), M=16, device=device,
                              dtype=torch.float32)
mb, losses_b = gft.training.fit(mb, num_steps=10 if FAST else 800, learning_rate=0.005)
Xb = mb.X_mean.value.detach().cpu().numpy().astype(np.float64)
mean_var = mb.X_var.value.mean().item()
print(f"BGPLVM    : ELBO {-float(losses_b[-1]):.1f}, latent R^2 {latent_r2(Xb):.3f}, mean q(X) var {mean_var:.4f}")
