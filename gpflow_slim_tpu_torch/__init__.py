"""gpflow_slim_tpu_torch: the PyTorch and CUDA port of gpflow_slim_tpu.

The same module layout and public names as the JAX package (``models.GPR``,
``kernels.RBF``, ``training.fit``, ``config.temp_settings``), in PyTorch's
idiom: modules are ``nn.Module``s, each ``Param`` holds one unconstrained
``nn.Parameter``, and models are placed on the CUDA device unless the
caller passes ``device="cpu"``. On CUDA float32 tensors the exact-GPR
objective and predictions and the SVGP's ELBO run on hand-written CUDA
kernels (``csrc/``); elsewhere on their plain PyTorch versions.

    import gpflow_slim_tpu_torch as gft
    m = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1),
                       device="cuda", dtype=torch.float32)
    m, losses = gft.training.fit(m, num_steps=100, learning_rate=0.01)
"""

from . import (
    conditionals,
    config,
    densities,
    features,
    interop,
    kernels,
    kullback_leiblers,
    likelihoods,
    mean_functions,
    models,
    ops,
    params,
    priors,
    quadrature,
    training,
    transforms,
)
from .config import settings, temp_settings
from .params import Module, Param

__version__ = "0.1.0"
