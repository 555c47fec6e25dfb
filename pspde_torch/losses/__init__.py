from .pathspace import (HJB_LOSS_METHODS, hjb_loss, log_variance_loss,
                        log_variance_y0_losses)
from .pinn import elliptic_pinn_residual, parabolic_pinn_residual

__all__ = ["HJB_LOSS_METHODS", "elliptic_pinn_residual", "hjb_loss",
           "log_variance_loss", "log_variance_y0_losses",
           "parabolic_pinn_residual"]
