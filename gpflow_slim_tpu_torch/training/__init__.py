from .natgrad import fit_svgp_natgrad, natgrad_step
from .optimize import fit

__all__ = ["fit", "fit_svgp_natgrad", "natgrad_step"]
