from .base import DiffusionMatrix, Geometry, Problem
from .eigen import FokkerPlanckEigen, SchrodingerEigen
from .elliptic import (ExponentialOnBallNonlinear,
                       ExponentialOnBallNonlinearSin, ExponentialOnSphere)
from .ou import LLGC, LQGC
from .parabolic import (AllenCahn, ExponentialOnSphereNonlinearParabolic,
                        ExponentialOnSphereParabolic, HeatEquation)

__all__ = ["AllenCahn", "DiffusionMatrix", "ExponentialOnBallNonlinear",
           "ExponentialOnBallNonlinearSin", "ExponentialOnSphere",
           "ExponentialOnSphereNonlinearParabolic",
           "ExponentialOnSphereParabolic", "FokkerPlanckEigen", "Geometry",
           "HeatEquation", "LLGC", "LQGC", "Problem", "SchrodingerEigen"]
