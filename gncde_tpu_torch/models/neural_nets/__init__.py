from .idx_encoder import IdxEncoder

__all__ = ["IdxEncoder"]
