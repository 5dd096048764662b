from .paths import (
    fill_nan_linear,
    linear_interpolation,
    backward_hermite_coefficients,
    interval_index,
    LinearInterpolation,
    CubicInterpolation,
    MatrixControl,
)
from .sparse_paths import (
    SparseMatrixControl,
    SparseCubicMatrixPath,
    SparseLinearMatrixPath,
    union_ell_pattern,
)
from .bcsr_paths import (
    BCSRMatrixControl,
    BCSRCubicMatrixPath,
    BCSRLinearMatrixPath,
    bcsr_control_from_edge_snapshots,
    build_sparse_control,
)

__all__ = [
    "fill_nan_linear",
    "linear_interpolation",
    "backward_hermite_coefficients",
    "interval_index",
    "LinearInterpolation",
    "CubicInterpolation",
    "MatrixControl",
    "SparseMatrixControl",
    "SparseCubicMatrixPath",
    "SparseLinearMatrixPath",
    "union_ell_pattern",
    "BCSRMatrixControl",
    "BCSRCubicMatrixPath",
    "BCSRLinearMatrixPath",
    "bcsr_control_from_edge_snapshots",
    "build_sparse_control",
]
