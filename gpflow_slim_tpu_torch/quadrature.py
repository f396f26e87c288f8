"""Gauss-Hermite quadrature (counterpart of ``gpflow_slim_tpu.quadrature``).

The nodes and weights are numpy float64 constants, moved once to each
(dtype, device) they are used on. ``ndiagquad`` computes E[g(f)] under
diagonal Gaussians for a function or a list of functions, the default of
every likelihood without a closed form.
"""

from __future__ import annotations

import functools
import itertools
from collections.abc import Iterable

import numpy as np
import torch

__all__ = ["hermgauss", "mvhermgauss", "ndiagquad"]


def hermgauss(n: int):
    """1-D Gauss-Hermite nodes and weights as numpy float64."""
    return np.polynomial.hermite.hermgauss(n)


def mvhermgauss(H: int, D: int):
    """Tensor-product Gauss-Hermite grid over D dimensions: locations
    (H^D, D) and weights (H^D,)."""
    gh_x, gh_w = hermgauss(H)
    x = np.array(list(itertools.product(*(gh_x,) * D)))
    w = np.prod(np.array(list(itertools.product(*(gh_w,) * D))), 1)
    return x, w


@functools.lru_cache(maxsize=32)
def _grid(H: int, D: int, dtype: torch.dtype, device: torch.device):
    """Nodes (H^D, D) and weights normalised by pi^(D/2), on ``device``."""
    xn, wn = mvhermgauss(H, D)
    return (torch.as_tensor(xn, dtype=dtype, device=device),
            torch.as_tensor(wn / np.pi ** (D / 2.0), dtype=dtype, device=device))


def ndiagquad(funcs, H: int, Fmu, Fvar, logspace: bool = False, **Ys):
    """Gauss-Hermite expectation of ``funcs`` under diagonal Gaussians.

    E[g(f, **Ys)] ~ sum_i w_i / sqrt(pi) g(mu + sqrt(2) v x_i) per element of
    Fmu/Fvar. ``Fmu`` and ``Fvar`` may be tensors or tuples of tensors (for
    multi-latent likelihoods); ``Ys`` broadcast against the quadrature axis.
    With ``logspace=True`` it computes log E[exp(g)] by logsumexp.
    """
    multi = isinstance(Fmu, (tuple, list))
    if multi:
        Din = len(Fmu)
        shape = Fmu[0].shape
        Fmu = torch.stack([f.reshape(-1) for f in Fmu], dim=-1)  # (N, Din)
        Fvar = torch.stack([f.reshape(-1) for f in Fvar], dim=-1)
    else:
        Din = 1
        shape = Fmu.shape
        Fmu = Fmu.reshape(-1, 1)
        Fvar = Fvar.reshape(-1, 1)

    xn, wn = _grid(H, Din, Fmu.dtype, Fmu.device)
    # evaluation points: (H^D, N, Din)
    Xall = Fmu[None, :, :] + torch.sqrt(2.0 * Fvar)[None, :, :] * xn[:, None, :]
    Ys_flat = {name: torch.as_tensor(Y, dtype=Fmu.dtype, device=Fmu.device).reshape(1, -1)
               for name, Y in Ys.items()}

    def eval_func(f):
        feval = f(*[Xall[:, :, d] for d in range(Din)], **Ys_flat)  # (H^D, N)
        if logspace:
            result = torch.logsumexp(feval + torch.log(wn)[:, None], dim=0)
        else:
            result = wn @ feval
        return result.reshape(shape)

    if isinstance(funcs, Iterable) and not callable(funcs):
        return [eval_func(f) for f in funcs]
    return eval_func(funcs)
