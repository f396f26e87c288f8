from . import cholesky, gram, linalg

__all__ = ["cholesky", "gram", "linalg"]
