from .natgrad import fit_svgp_natgrad, natgrad_step
from .optimize import fit, fit_lbfgs, make_step_fn

__all__ = ["fit", "fit_lbfgs", "fit_svgp_natgrad", "make_step_fn", "natgrad_step"]
