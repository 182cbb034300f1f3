from .drop import drop_loss_rate, drop_mask_device
from .encoding import StateEncoder
from .table import StateTable

__all__ = ["drop_loss_rate", "drop_mask_device", "StateEncoder",
           "StateTable"]
