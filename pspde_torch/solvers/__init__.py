from .hjb import HJBSolver

__all__ = ["HJBSolver"]
