from .paths import (
    fill_nan_linear,
    linear_interpolation,
    backward_hermite_coefficients,
    interval_index,
    LinearInterpolation,
    CubicInterpolation,
    MatrixControl,
)

__all__ = [
    "fill_nan_linear",
    "linear_interpolation",
    "backward_hermite_coefficients",
    "interval_index",
    "LinearInterpolation",
    "CubicInterpolation",
    "MatrixControl",
]
