from .eigen import EigenSolver
from .elliptic import EllipticSolver
from .general import GeneralSolver
from .hjb import HJBSolver

__all__ = ["EigenSolver", "EllipticSolver", "GeneralSolver", "HJBSolver"]
