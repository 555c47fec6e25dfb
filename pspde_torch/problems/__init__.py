from .base import DiffusionMatrix, Geometry, Problem
from .double_well import DoubleWell, DoubleWell_multidim
from .eigen import FokkerPlanckEigen, SchrodingerEigen
from .elliptic import (Committor, ExponentialOnBallNonlinear,
                       ExponentialOnBallNonlinearSin,
                       ExponentialOnBallNonlinearSinHessian,
                       ExponentialOnSphere, Helmholtz, Oscillations,
                       QuadraticGradient, SinNorm2)
from .ou import LLGC, LQGC
from .parabolic import (AllenCahn, ExponentialOnSphereNonlinearParabolic,
                        ExponentialOnSphereParabolic, HeatEquation)

__all__ = ["AllenCahn", "Committor", "DiffusionMatrix", "DoubleWell",
           "DoubleWell_multidim", "ExponentialOnBallNonlinear",
           "ExponentialOnBallNonlinearSin",
           "ExponentialOnBallNonlinearSinHessian", "ExponentialOnSphere",
           "ExponentialOnSphereNonlinearParabolic",
           "ExponentialOnSphereParabolic", "FokkerPlanckEigen", "Geometry",
           "HeatEquation", "Helmholtz", "LLGC", "LQGC", "Oscillations",
           "Problem", "QuadraticGradient", "SchrodingerEigen", "SinNorm2"]
