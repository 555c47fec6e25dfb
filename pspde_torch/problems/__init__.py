from .base import DiffusionMatrix, Geometry, Problem
from .elliptic import (ExponentialOnBallNonlinear,
                       ExponentialOnBallNonlinearSin, ExponentialOnSphere)
from .ou import LLGC, LQGC

__all__ = ["DiffusionMatrix", "ExponentialOnBallNonlinear",
           "ExponentialOnBallNonlinearSin", "ExponentialOnSphere",
           "Geometry", "LLGC", "LQGC", "Problem"]
