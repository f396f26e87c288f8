from .gpr import GPR
from .model import GPModel, Model
from .posterior import GPRPosterior
from .svgp import SVGP

__all__ = ["Model", "GPModel", "GPR", "GPRPosterior", "SVGP"]
