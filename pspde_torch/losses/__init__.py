from .pathspace import (HJB_LOSS_METHODS, hjb_loss, log_variance_loss,
                        log_variance_y0_losses)

__all__ = ["HJB_LOSS_METHODS", "hjb_loss", "log_variance_loss",
           "log_variance_y0_losses"]
