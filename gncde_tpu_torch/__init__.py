"""PyTorch / CUDA port of :mod:`gncde_tpu` for NVIDIA Hopper GPUs.

The layout mirrors ``gncde_tpu`` file for file, so each module's JAX
counterpart sits at the same relative path. This package imports ``torch``
and never ``jax``. The hot path (one vector-field evaluation and its
cotangent) runs through two hand-written CUDA kernels, built from
``gncde_tpu_torch/csrc`` at first use (``ops/_build.py``).
"""
