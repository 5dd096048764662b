from .solve import (
    ODETerm,
    SaveAt,
    PIDController,
    ConstantStepSize,
    Solution,
    diffeqsolve,
)
from .tableaus import get_tableau, ButcherTableau, TSIT5, DOPRI5, BOSH3, EULER, HEUN

__all__ = [
    "ODETerm", "SaveAt", "PIDController", "ConstantStepSize", "Solution",
    "diffeqsolve", "get_tableau", "ButcherTableau", "TSIT5", "DOPRI5", "BOSH3",
    "EULER", "HEUN",
]
