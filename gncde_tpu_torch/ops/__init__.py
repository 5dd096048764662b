"""Backend and precision knobs for the equivariant fusion operator.

Counterpart of ``gncde_tpu/ops/__init__.py``. Backends:

  * ``"auto"``       -- (default) ``"megakernel"`` when the tensors of the
                        call lie on a CUDA device, ``"dense"`` otherwise.
                        Resolved per call from the device of the node state.
  * ``"megakernel"`` -- the vector-field-level fast path for the undirected
                        perm-equiv field with a slim cubic control: for
                        ``n <= MEGAKERNEL_MAX_N`` one forward kernel (K1,
                        ``ops/megakernel.py``) and one backward kernel (K2,
                        ``ops/megakernel_bwd.py``) per vf eval; above it,
                        up to ``TILED_MAX_N``, the tiled regime
                        (``ops/tiled.py``: K3 per layer, K4 backward).
                        An enc_idx field runs K7 (``ops/modulate.py``)
                        and the plane-pair kernels K6a/K6b
                        (``ops/pair.py``) at every n up to
                        ``TILED_MAX_N``. On CPU tensors the kernels'
                        plain versions run.
  * ``"dense"``      -- the reference formulation: materialise the fused
                        operator and multiply once.
  * ``"decomposed"`` -- the rank-structured two-matmul formulation
                        (``equiv_basis.fused_apply``).
  * ``"pipeline"``   -- per layer, ``pipeline.pipeline_fused_apply``: the
                        fused apply on the materialised A(t), dA(t) in one
                        launch of K13 (``ops/pipeline.py``), ``dM`` by K13 on
                        the transposed operator, the rest of the backward in
                        torch.
  * ``"pallas"``     -- per layer, ``fused_basis.fused_apply_pallas``: the
                        same apply through K12 (``ops/fused_basis.py``), the
                        backward by autograd of ``equiv_basis.fused_apply``.

Whatever the backend, a sparse control (the dyn trainer's
``sparse_control``) bypasses all of them: its ELL values go to
``sparse.sparse_fused_apply`` (K10, ``ops/ell_spmm.py``) and its BCSR values
to ``bcsr.bcsr_fused_apply`` (K8 and K9, ``ops/bcsr.py``), on CUDA tensors
through the kernels and on CPU ones through their plain versions.

The fused RK step (``set_fused_step``, off by default as in the JAX
package): under the megakernel backend, each explicit FSAL solver step of
an undirected perm-equiv field with n <= 640 and a square layer stack runs
as one launch of K11 (``ops/fused_step.py``) instead of one K1 per stage.

Precision: only ``"f32"`` is implemented. ``"bf16"`` raises, because the
kernels have no bf16 operand path yet (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from . import equiv_basis  # noqa: F401

_BACKEND = "auto"
_VALID = ("auto", "dense", "decomposed", "megakernel", "pipeline", "pallas")
_PRECISION = "f32"
_VALID_PRECISION = ("f32",)


def check_fusion_backend(name: str) -> None:
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}; got {name!r}")


def set_fusion_backend(name: str) -> None:
    global _BACKEND
    check_fusion_backend(name)
    _BACKEND = name


def get_fusion_backend(device: torch.device | str | None = None) -> str:
    """The selected backend; ``"auto"`` resolves against ``device``."""
    if _BACKEND != "auto":
        return _BACKEND
    if device is not None and torch.device(device).type == "cuda":
        return "megakernel"
    return "dense"


def check_fusion_precision(name: str) -> None:
    if name == "bf16":
        raise NotImplementedError(
            "fusion_precision 'bf16' is not implemented in the Hopper kernels "
            "yet (ROADMAP Queue 2); use 'f32'"
        )
    if name not in _VALID_PRECISION:
        raise ValueError(f"precision must be one of {_VALID_PRECISION}")


def set_fusion_precision(name: str) -> None:
    global _PRECISION
    check_fusion_precision(name)
    _PRECISION = name


def get_fusion_precision() -> str:
    return _PRECISION


_FUSED_STEP = False


def set_fused_step(enabled: bool) -> None:
    """Turn the fused RK step (K11, ``ops/fused_step.py``) on or off: one
    kernel launch per explicit FSAL solver step when the megakernel backend
    serves the vector field. Off by default, as in the JAX package."""
    global _FUSED_STEP
    _FUSED_STEP = bool(enabled)


def get_fused_step() -> bool:
    return _FUSED_STEP
