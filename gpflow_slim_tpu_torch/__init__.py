"""gpflow_slim_tpu_torch: the PyTorch and CUDA port of gpflow_slim_tpu.

The same module layout and public names as the JAX package (``models.GPR``,
``kernels.RBF``, ``training.fit``, ``config.temp_settings``), in PyTorch's
idiom: modules are ``nn.Module``s, each ``Param`` holds one unconstrained
``nn.Parameter``, and models are placed on the CUDA device unless the
caller passes ``device="cpu"``. On CUDA float32 tensors the exact-GPR
objective and predictions and the SVGP's ELBO run on hand-written CUDA
kernels (``csrc/``); elsewhere on their plain PyTorch versions. ``mcmc``
samples a model's hyperparameters (HMC, NUTS) with the chains batched on
one device (``parallel.sample_chains``).

    import gpflow_slim_tpu_torch as gft
    m = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1),
                       device="cuda", dtype=torch.float32)
    m, losses = gft.training.fit(m, num_steps=100, learning_rate=0.01)
"""

from . import (
    conditionals,
    config,
    densities,
    entry,
    features,
    interop,
    io,
    kernels,
    kernels_deep,
    kernels_nkn,
    kullback_leiblers,
    likelihoods,
    mean_functions,
    mcmc,
    models,
    ops,
    parallel,
    params,
    priors,
    quadrature,
    training,
    transforms,
    utils,
)
from .config import settings, temp_settings
from .params import Module, Param

__version__ = "0.1.0"
