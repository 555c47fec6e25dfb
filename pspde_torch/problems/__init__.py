from .base import DiffusionMatrix, Geometry, Problem
from .ou import LLGC, LQGC

__all__ = ["DiffusionMatrix", "Geometry", "Problem", "LLGC", "LQGC"]
