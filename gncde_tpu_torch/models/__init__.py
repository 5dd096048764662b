from . import vector_fields
from .continuous import GraphNeuralCDE, make_control

__all__ = ["vector_fields", "GraphNeuralCDE", "make_control"]
