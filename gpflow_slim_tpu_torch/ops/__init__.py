from . import blocked, cholesky, gram, iterative, linalg, trsm

__all__ = ["blocked", "cholesky", "gram", "iterative", "linalg", "trsm"]
