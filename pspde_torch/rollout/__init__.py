from .kernels import (FusedTrainOut, ISRolloutOut, fused_controlled_rollout,
                      fused_train_rollout, philox_normals,
                      reference_controlled_rollout, reference_train_rollout,
                      train_normals)
from .sde import HJBRolloutConfig, HJBRolloutOut, hjb_rollout

__all__ = ["FusedTrainOut", "HJBRolloutConfig", "HJBRolloutOut",
           "ISRolloutOut", "fused_controlled_rollout", "fused_train_rollout",
           "hjb_rollout", "philox_normals", "reference_controlled_rollout",
           "reference_train_rollout", "train_normals"]
