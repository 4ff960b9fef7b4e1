from .edict import EDict
from .device import as_tensor, resolve_device

__all__ = ["EDict", "as_tensor", "resolve_device"]
