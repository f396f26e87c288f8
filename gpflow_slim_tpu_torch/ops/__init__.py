from . import blocked, chol_inverse, cholesky, gram, iterative, linalg, nkn, trsm

__all__ = ["blocked", "chol_inverse", "cholesky", "gram", "iterative", "linalg", "nkn", "trsm"]
