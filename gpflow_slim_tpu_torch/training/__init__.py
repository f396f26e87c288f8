from .optimize import fit

__all__ = ["fit"]
