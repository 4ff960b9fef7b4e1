from .utils import CADCObjectClass
from .loader import CADCDLoader

__all__ = ["CADCObjectClass", "CADCDLoader"]
