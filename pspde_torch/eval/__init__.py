from .estimator_stats import loss_estimator_statistics, relative_error
from .gradient_variance import gradient_variances
from .importance_sampling import (do_importance_sampling,
                                  do_importance_sampling_Wei,
                                  importance_sampling,
                                  importance_sampling_fused, make_is_runner)
from .plotting import load_exp_logs, save_exp_logs
from .test_error import compute_test_error, control_test_error

__all__ = ["compute_test_error", "control_test_error",
           "do_importance_sampling", "do_importance_sampling_Wei",
           "gradient_variances", "importance_sampling",
           "importance_sampling_fused", "load_exp_logs",
           "loss_estimator_statistics", "make_is_runner", "relative_error",
           "save_exp_logs"]
