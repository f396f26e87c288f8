"""2-D (rows x cols) distributed block Cholesky with a replicated output
(counterpart of ``gpflow_slim_tpu.parallel.grid_cholesky``).

The algorithm is ``grid_gpr.grid_cholesky_tiles``; this wrapper takes and
returns ordinary (N, N) tensors: it permutes K block-cyclically, factors
this rank's tile, and sums every rank's tile into the whole factor (an
N x N ``all_reduce``), convenient for tests and callers that need the
dense L, not the memory-scaling path (``grid_gpr.make_grid_gpr_loss``).
"""

from __future__ import annotations

import numpy as np
import torch

from .grid_gpr import GridLayout, grid_cholesky_tiles
from .mesh import Mesh

__all__ = ["grid_cholesky"]


@torch.no_grad()
def grid_cholesky(K, mesh: Mesh, axes=("rows", "cols"), block_size: int = 128):
    """Lower Cholesky factor of the SPD ``K`` (N, N) over a 2-D mesh, on
    every rank. N / block_size must divide by both axis sizes."""
    lo = GridLayout(K.shape[0], mesh, axes=axes, block_size=block_size)
    rp, cp = torch.as_tensor(lo.row_perm(), device=K.device), torch.as_tensor(lo.col_perm(), device=K.device)
    tile = grid_cholesky_tiles(lo.tile_of(K[rp][:, cp]), lo)
    if lo.Pr * lo.Pc == 1:
        Lp = tile
    else:
        Lp = K.new_zeros(K.shape)
        lo.tile_of(Lp).copy_(tile)
        lo.psum_c(lo.psum_r(Lp))
    inv_r = torch.as_tensor(np.argsort(lo.row_perm()), device=K.device)
    inv_c = torch.as_tensor(np.argsort(lo.col_perm()), device=K.device)
    return torch.tril(Lp[inv_r][:, inv_c])
