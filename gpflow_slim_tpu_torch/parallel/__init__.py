from .chains import sample_chains
from .cyclic_cholesky import cyclic_cholesky
from .dist_cg import make_distributed_cg_loss
from .dist_linalg import distributed_cholesky, distributed_gpr_mll, distributed_solve_lower, make_distributed_gpr_loss
from .dp import dp_value_and_grad, fit_svgp, make_svgp_step
from .grid_cholesky import grid_cholesky
from .grid_gpr import (
    GridLayout,
    grid_cholesky_tiles,
    grid_gram,
    grid_nll,
    grid_solve_lower_thin,
    grid_solve_lower_wide,
    grid_solve_upper_thin,
    make_grid_gpr_loss,
)
from .mesh import Mesh, initialize_distributed, make_mesh, replicated, shard_rows
from .ring_gram import ring_gram, ring_gram_matvec

__all__ = [
    "Mesh", "make_mesh", "replicated", "shard_rows", "initialize_distributed",
    "sample_chains", "cyclic_cholesky", "dp_value_and_grad", "fit_svgp", "make_svgp_step",
    "ring_gram", "ring_gram_matvec", "distributed_cholesky", "grid_cholesky",
    "distributed_gpr_mll", "distributed_solve_lower",
    "make_distributed_gpr_loss", "make_distributed_cg_loss",
    "GridLayout", "grid_cholesky_tiles", "grid_gram", "grid_nll",
    "grid_solve_lower_thin", "grid_solve_upper_thin", "grid_solve_lower_wide",
    "make_grid_gpr_loss",
]
