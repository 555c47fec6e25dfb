from .importance_sampling import (do_importance_sampling,
                                  do_importance_sampling_Wei,
                                  importance_sampling,
                                  importance_sampling_fused)
from .test_error import compute_test_error, control_test_error

__all__ = ["compute_test_error", "control_test_error",
           "do_importance_sampling", "do_importance_sampling_Wei",
           "importance_sampling", "importance_sampling_fused"]
