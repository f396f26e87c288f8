from .cg_gpr import GPRCG
from .gpmc import GPMC
from .gplvm import GPLVM, BayesianGPLVM, pca_reduce
from .gpr import GPR
from .model import GPModel, Model
from .posterior import GPRPosterior, SGPRPosterior, SVGPPosterior
from .sgpmc import SGPMC
from .sgpr import GPRFITC, SGPR
from .svgp import SVGP
from .vgp import VGP, VGPOpperArchambeau

__all__ = ["Model", "GPModel", "GPR", "GPRPosterior", "SGPR", "GPRFITC", "SGPRPosterior", "SVGP",
           "SVGPPosterior", "VGP", "VGPOpperArchambeau", "GPMC", "SGPMC", "GPRCG", "GPLVM", "BayesianGPLVM",
           "pca_reduce"]
