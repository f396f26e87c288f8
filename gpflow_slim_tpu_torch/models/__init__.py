from .gpr import GPR
from .model import GPModel, Model
from .posterior import GPRPosterior

__all__ = ["Model", "GPModel", "GPR", "GPRPosterior"]
