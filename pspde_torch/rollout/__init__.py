from .kernels import (ISRolloutOut, fused_controlled_rollout, philox_normals,
                      reference_controlled_rollout)

__all__ = ["ISRolloutOut", "fused_controlled_rollout", "philox_normals",
           "reference_controlled_rollout"]
