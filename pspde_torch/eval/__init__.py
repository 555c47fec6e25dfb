from .importance_sampling import importance_sampling, importance_sampling_fused
from .test_error import compute_test_error, control_test_error

__all__ = ["compute_test_error", "control_test_error", "importance_sampling",
           "importance_sampling_fused"]
