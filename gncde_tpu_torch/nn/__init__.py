from .layers import MLP, Embedding, Linear, RMSNorm
from . import convert

__all__ = ["MLP", "Embedding", "Linear", "RMSNorm", "convert"]
