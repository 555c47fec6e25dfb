from .elliptic import EllipticSolver
from .hjb import HJBSolver

__all__ = ["EllipticSolver", "HJBSolver"]
