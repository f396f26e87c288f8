from .gpr import GPR
from .model import GPModel, Model

__all__ = ["Model", "GPModel", "GPR"]
