from . import vector_fields
from .continuous import GraphNeuralCDE, make_control
from .tgb import TGBGraphNeuralCDE

__all__ = ["vector_fields", "GraphNeuralCDE", "make_control", "TGBGraphNeuralCDE"]
