from .base import DiffusionMatrix, Geometry, Problem
from .double_well import (Committor_DoubleWell, DoubleWell,
                          DoubleWell_expectation_hitting_time,
                          DoubleWell_multidim, DoubleWell_multidim_2,
                          DoubleWell_multidim_3, DoubleWell_OU,
                          DoubleWell_stopping, DoubleWell_stopping_linear,
                          DoubleWellGeneral)
from .eigen import FokkerPlanckEigen, SchrodingerEigen
from .elliptic import (Committor, ExponentialOnBallNonlinear,
                       ExponentialOnBallNonlinearSin,
                       ExponentialOnBallNonlinearSinHessian,
                       ExponentialOnSphere, Helmholtz, Oscillations,
                       QuadraticGradient, SinNorm2)
from .ou import LLGC, LLGC_general_f, LQGC
from .parabolic import (AllenCahn, ExponentialOnSphereNonlinearParabolic,
                        ExponentialOnSphereParabolic, HeatEquation)

# the JAX package's alias of the general solver's double well
DoubleWell_multidim_for_general_solver = DoubleWellGeneral

REGISTRY = {
    cls.__name__: cls
    for cls in [
        LLGC, LLGC_general_f, LQGC,
        DoubleWell, DoubleWell_multidim, DoubleWellGeneral,
        DoubleWell_multidim_2, DoubleWell_multidim_3, DoubleWell_OU,
        ExponentialOnSphere, ExponentialOnBallNonlinear,
        ExponentialOnBallNonlinearSin, ExponentialOnBallNonlinearSinHessian,
        ExponentialOnSphereParabolic, ExponentialOnSphereNonlinearParabolic,
        AllenCahn, HeatEquation,
        DoubleWell_stopping, DoubleWell_stopping_linear,
        DoubleWell_expectation_hitting_time,
        Committor_DoubleWell, Committor,
        QuadraticGradient, Helmholtz, Oscillations, SinNorm2,
        FokkerPlanckEigen, SchrodingerEigen,
    ]
}

__all__ = list(REGISTRY) + [
    "DiffusionMatrix", "Geometry", "Problem", "REGISTRY",
    "DoubleWell_multidim_for_general_solver",
]
