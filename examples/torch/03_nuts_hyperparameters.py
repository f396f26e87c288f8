"""NUTS over GPR kernel hyperparameters, parallel chains with shared
step-size adaptation (BASELINE config #4 shape), on gpflow_slim_tpu_torch:
the twin of examples/03_nuts_hyperparameters.py. Runs on the CUDA device in
float32 (the hand-written kernels) unless given ``--device cpu``.

Run: python examples/torch/03_nuts_hyperparameters.py [--device cpu]
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
X = rng.uniform(0, 1, (80, 1))
Y = np.sin(6 * X) + 0.2 * rng.randn(80, 1)

k = gft.kernels.RBF(1)
k.variance = gft.params.Param(
    1.0, transform=gft.transforms.positive(),
    prior=gft.priors.LogNormal(0.0, 1.0), name="variance")
k.lengthscales = gft.params.Param(
    0.3, transform=gft.transforms.positive(),
    prior=gft.priors.LogNormal(-1.0, 1.0), name="lengthscales")
m = gft.models.GPR(X, Y, kern=k, device=device, dtype=torch.float32)
m.likelihood.variance = gft.params.Param(
    0.05, transform=gft.transforms.positive(),
    prior=gft.priors.LogNormal(-2.0, 1.0), name="noise", device=m.X.device, dtype=torch.float32)

logprob, x0, unpack = gft.mcmc.model_logprob(m)

C = 2 if FAST else 4  # scale up freely on real hardware
samples, info = gft.parallel.sample_chains(
    logprob, x0.repeat(C, 1), torch.Generator(device=device).manual_seed(0),
    num_samples=8 if FAST else 300, sampler="nuts",
    num_warmup=8 if FAST else 200,
)
s = samples.cpu().numpy()
print("chains:", s.shape)
print("split-R-hat:", np.round(gft.mcmc.potential_scale_reduction(s), 3))
print("bulk ESS:  ", np.round(gft.mcmc.effective_sample_size(s), 1))

u = torch.stack([unpack(v)["likelihood.variance.unconstrained"] for v in samples.reshape(-1, s.shape[-1])])
noise = m.likelihood.variance.transform.forward(u).cpu().numpy()
print(f"posterior noise variance: median={np.median(noise):.4f} "
      f"(true 0.04)")
