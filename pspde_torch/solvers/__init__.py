from .elliptic import EllipticSolver
from .general import GeneralSolver
from .hjb import HJBSolver

__all__ = ["EllipticSolver", "GeneralSolver", "HJBSolver"]
