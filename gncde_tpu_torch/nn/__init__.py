from .layers import Linear, RMSNorm
from . import convert

__all__ = ["Linear", "RMSNorm", "convert"]
