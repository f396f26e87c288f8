"""Production serving: precompute the posterior once, checkpoint it, and
serve O(N N*) predictions from the restored cache, on gpflow_slim_tpu_torch:
the twin of examples/07_serving_posterior.py. Runs on the CUDA device in
float32 (the hand-written kernels) unless given ``--device cpu``.

Run: python examples/torch/07_serving_posterior.py [--device cpu]
"""

import argparse
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

FAST = os.environ.get("GFS_EXAMPLE_FAST") == "1"  # tiny sizes for tests/test_torch_examples.py smoke runs

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # the repo root
import gpflow_slim_tpu_torch as gft  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

rng = np.random.RandomState(0)
X = rng.uniform(0, 1, (256 if FAST else 2000, 1))
Y = np.sin(12 * X) + 0.1 * rng.randn(*X.shape)


def model():
    return gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=device, dtype=torch.float32)


m, _ = gft.training.fit(model(), num_steps=10 if FAST else 200, learning_rate=0.05)

with tempfile.TemporaryDirectory() as tmp:
    # training side: factorize once, checkpoint the posterior
    with torch.no_grad():
        post = m.posterior()
    path = gft.utils.save_checkpoint(os.path.join(tmp, "gp_posterior"), post)

    # serving side: a posterior of the same shapes as the template, restored
    # from the checkpoint, answers queries without refactorizing
    with torch.no_grad():
        post2 = gft.utils.load_checkpoint(path, model().posterior())

Xq = np.linspace(0, 1, 256)[:, None]
with torch.no_grad():
    mean, var = post2.predict_y(Xq)  # warm-up
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 2 if FAST else 20
    for _ in range(reps):
        mean, var = post2.predict_y(Xq)
    if device != "cpu":
        torch.cuda.synchronize()
dt = (time.perf_counter() - t0) / reps
mean = mean.cpu().numpy()
print(f"serving latency (N={X.shape[0]} cache, 256 queries): {dt*1000:.2f} ms")
print(f"pred mean range: [{float(np.min(mean)):.2f}, "
      f"{float(np.max(mean)):.2f}]")
