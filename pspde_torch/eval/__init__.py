from .importance_sampling import importance_sampling, importance_sampling_fused
from .test_error import control_test_error

__all__ = ["control_test_error", "importance_sampling",
           "importance_sampling_fused"]
