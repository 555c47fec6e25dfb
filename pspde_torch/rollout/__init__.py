from .kernels import (FusedStoppedOut, FusedTrainOut, ISRolloutOut,
                      fused_controlled_rollout, fused_stopped_train_rollout,
                      fused_train_rollout, philox_normals,
                      reference_controlled_rollout,
                      reference_stopped_train_rollout,
                      reference_train_rollout, train_normals)
from .sampling import (inside_fn, sample_boundary, sample_boundary_reflected,
                       sample_domain)
from .sde import (HJBRolloutConfig, HJBRolloutOut, StoppedRolloutConfig,
                  StoppedRolloutOut, hjb_rollout, stopped_rollout,
                  value_and_z)

__all__ = ["FusedStoppedOut", "FusedTrainOut", "HJBRolloutConfig",
           "HJBRolloutOut", "ISRolloutOut", "StoppedRolloutConfig",
           "StoppedRolloutOut", "fused_controlled_rollout",
           "fused_stopped_train_rollout", "fused_train_rollout",
           "hjb_rollout", "inside_fn", "philox_normals",
           "reference_controlled_rollout", "reference_stopped_train_rollout",
           "reference_train_rollout", "sample_boundary",
           "sample_boundary_reflected", "sample_domain", "stopped_rollout",
           "train_normals", "value_and_z"]
