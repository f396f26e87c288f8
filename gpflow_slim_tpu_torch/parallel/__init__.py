from .chains import sample_chains
from .dp import dp_value_and_grad, fit_svgp, make_svgp_step
from .mesh import Mesh, initialize_distributed, make_mesh, replicated, shard_rows

__all__ = ["Mesh", "make_mesh", "replicated", "shard_rows", "initialize_distributed", "sample_chains",
           "dp_value_and_grad", "fit_svgp", "make_svgp_step"]
