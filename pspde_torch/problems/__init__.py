from .base import DiffusionMatrix, Geometry, Problem
from .double_well import DoubleWell, DoubleWell_multidim
from .eigen import FokkerPlanckEigen, SchrodingerEigen
from .elliptic import (ExponentialOnBallNonlinear,
                       ExponentialOnBallNonlinearSin, ExponentialOnSphere)
from .ou import LLGC, LQGC
from .parabolic import (AllenCahn, ExponentialOnSphereNonlinearParabolic,
                        ExponentialOnSphereParabolic, HeatEquation)

__all__ = ["AllenCahn", "DiffusionMatrix", "DoubleWell",
           "DoubleWell_multidim", "ExponentialOnBallNonlinear",
           "ExponentialOnBallNonlinearSin", "ExponentialOnSphere",
           "ExponentialOnSphereNonlinearParabolic",
           "ExponentialOnSphereParabolic", "FokkerPlanckEigen", "Geometry",
           "HeatEquation", "LLGC", "LQGC", "Problem", "SchrodingerEigen"]
