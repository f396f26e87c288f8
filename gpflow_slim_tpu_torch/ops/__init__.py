from . import blocked, chol_inverse, cholesky, gram, iterative, linalg, trsm

__all__ = ["blocked", "chol_inverse", "cholesky", "gram", "iterative", "linalg", "trsm"]
