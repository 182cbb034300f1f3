from .drop import drop_loss_rate, drop_mask_device

__all__ = ["drop_loss_rate", "drop_mask_device"]
