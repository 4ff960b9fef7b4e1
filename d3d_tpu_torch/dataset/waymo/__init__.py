from .constants import WaymoObjectClass
from .loader import WaymoLoader

__all__ = ["WaymoObjectClass", "WaymoLoader"]
