from . import cholesky, gram, linalg, trsm

__all__ = ["cholesky", "gram", "linalg", "trsm"]
