from .box import BoxSpace

__all__ = ["BoxSpace"]
