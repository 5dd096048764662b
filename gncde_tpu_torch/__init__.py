"""PyTorch / CUDA port of :mod:`gncde_tpu` for NVIDIA Hopper GPUs.

The layout mirrors ``gncde_tpu`` file for file, so each module's JAX
counterpart sits at the same relative path. This package imports ``torch``
and never ``jax`` or anything of ``gncde_tpu``. The hot path (one
vector-field evaluation and its cotangent) runs through hand-written CUDA
kernels, built from ``gncde_tpu_torch/csrc`` at first use
(``ops/_build.py``): K1/K2 for n <= 640, the tiled K3-K5b above.
"""
