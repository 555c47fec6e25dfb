from .eigen_power import (eigen_power_refine, eigen_subspace_refine,
                          fk_semigroup_targets)
from .estimator_stats import loss_estimator_statistics, relative_error
from .gradient_variance import gradient_variances
from .importance_sampling import (do_importance_sampling,
                                  do_importance_sampling_Wei,
                                  importance_sampling,
                                  importance_sampling_fused, make_is_runner)
from .picard import picard_refine, picard_refine_elliptic
from .plotting import load_exp_logs, save_exp_logs
from .refine import (RefinedValue, feynman_kac_refine,
                     feynman_kac_refine_elliptic)
from .test_error import compute_test_error, control_test_error

__all__ = ["RefinedValue", "compute_test_error", "control_test_error",
           "do_importance_sampling", "do_importance_sampling_Wei",
           "eigen_power_refine", "eigen_subspace_refine",
           "feynman_kac_refine", "feynman_kac_refine_elliptic",
           "fk_semigroup_targets", "gradient_variances",
           "importance_sampling", "importance_sampling_fused",
           "load_exp_logs", "loss_estimator_statistics", "make_is_runner",
           "picard_refine", "picard_refine_elliptic", "relative_error",
           "save_exp_logs"]
