from .gpr import GPR
from .model import GPModel, Model
from .posterior import GPRPosterior, SGPRPosterior, SVGPPosterior
from .sgpr import GPRFITC, SGPR
from .svgp import SVGP

__all__ = ["Model", "GPModel", "GPR", "GPRPosterior", "SGPR", "GPRFITC", "SGPRPosterior", "SVGP",
           "SVGPPosterior"]
