"""K7: the enc_idx per-edge MLP modulation of both planes.

Counterpart of ``gncde_tpu/ops/pallas/modulate.py``. An enc_idx field
modulates ``A(t)`` and ``dA(t)`` entrywise with a small MLP over
``concat([X_ij, emb_i, emb_j])``. The first layer is affine in the concat,
so its pairwise part is per-node projections (``_edge_projections``,
``torch.matmul``, as the JAX package leaves them to XLA); the rest is
pointwise with a tiny width::

    z_c = ((wa_c X + Ei[:, c]) + Ej[c, :]) + b1_c
    relu -> (depth - 1) x [w x w mix + bias, relu] -> head ow . r + ob

:func:`modulate_pair` runs both planes' chains in one pass over the planes
(``csrc/modulate.cu``) for CUDA tensors, counts the launch, and raises on
what the kernel does not take; on CPU tensors it runs
:func:`plain_modulate_pair`. Planes are batch-first ``(B, n, n)`` float32
and unpadded; the embedding and both MLPs are shared by the batch. The
outputs are float32, or under ``fusion_precision: bf16`` bfloat16 (K7bf):
the chain runs in f32 and each output is rounded once, as the JAX kernel's
``out_dtype`` store. Forward only: the field differentiates through
``fields.fused_modulate``, whose backward recomputes the plain decomposed
chain in f32 (as ``_fused_modulate_bwd``).
"""

from __future__ import annotations

import ctypes
import types

import torch

from . import _build
from ..nn.layers import ACTIVATIONS

#: The kernel's channel width: the reference's modulation MLPs are 8 wide.
WIDTH = 8
#: Dynamic shared memory a launch may ask for without an opt-in.
_SMEM_LIMIT = 48 * 1024


def modulate_supported(mlp) -> bool:
    """The kernel covers the reference family: relu hidden activations,
    identity head, depth >= 1, width 8, every layer with a bias."""
    return (mlp.activation == "relu" and mlp.final_activation == "identity"
            and mlp.depth >= 1 and mlp.width_size == WIDTH
            and all(layer.bias is not None for layer in mlp.layers))


def modulate_matrix(mat, mlp, emb):
    """Per-edge MLP modulation of ``mat`` ``(B, n, n)``: the MLP of
    ``concat([mat_ij, emb_i, emb_j])`` for every edge, decomposed as the
    JAX package does -- the first layer's pairwise part is two
    ``(n, d) @ (d, w)`` products, so the ``(n, n, 2d + 1)`` concat never
    materialises -- with channel-first activations ``(B, w, n, n)``."""
    W1, b1 = mlp.layers[0].weight, mlp.layers[0].bias  # columns [a | emb_i | emb_j]
    d = emb.shape[1]
    Ei = emb @ W1[:, 1:1 + d].T  # (n, w)
    Ej = emb @ W1[:, 1 + d:].T
    z = W1[:, 0][None, :, None, None] * mat[:, None] + Ei.T[None, :, :, None] \
        + Ej.T[None, :, None, :]
    if b1 is not None:
        z = z + b1[None, :, None, None]
    act = ACTIVATIONS[mlp.activation]
    z = act(z)
    for layer in mlp.layers[1:-1]:
        z = torch.einsum("vw,bwij->bvij", layer.weight, z)
        if layer.bias is not None:
            z = z + layer.bias[None, :, None, None]
        z = act(z)
    last = mlp.layers[-1]
    z = torch.einsum("vw,bwij->bvij", last.weight, z)
    if last.bias is not None:
        z = z + last.bias[None, :, None, None]
    return ACTIVATIONS[mlp.final_activation](z)[:, 0]


def plain_modulate_pair(A, dA, mlp_a, mlp_d, emb, out_dtype=torch.float32):
    """K7's plain version: ``(A_m, dA_m)``, each plane's decomposed chain
    built from the MLPs themselves in f32, rounded once to ``out_dtype``."""
    return (modulate_matrix(A, mlp_a, emb).to(out_dtype),
            modulate_matrix(dA, mlp_d, emb).to(out_dtype))


def _mlp_scalars(mlp_a, mlp_d):
    """Both MLPs' weights as the kernel reads them, one flat buffer of
    ``2 * wstride`` floats; per MLP ``[wa w | b1 w | (hw w*w | hb w) x
    (depth-1) | ow w | ob]``, with ``wa`` the first layer's plane column."""
    parts = []
    for mlp in (mlp_a, mlp_d):
        first, last = mlp.layers[0], mlp.layers[-1]
        parts += [first.weight[:, 0], first.bias]
        for layer in mlp.layers[1:-1]:
            parts += [layer.weight.reshape(-1), layer.bias]
        parts += [last.weight.reshape(-1), last.bias]
    return torch.cat(parts)


def _edge_projections(mlp_a, mlp_d, emb):
    """The first layers' node parts of both MLPs, two products: ``Ei (n,
    2w)`` = ``[emb Wi_A^T | emb Wi_D^T]`` and ``Ej (2w, n)`` = ``[Wj_A;
    Wj_D] emb^T``."""
    d = emb.shape[1]
    W1 = torch.cat([mlp_a.layers[0].weight, mlp_d.layers[0].weight])  # (2w, 2d+1)
    return emb @ W1[:, 1:1 + d].T, W1[:, 1 + d:] @ emb.T


_ARGTYPES = [_build.P, _build.P, _build.I, _build.I, _build.I, _build.P, _build.I,
             _build.P, _build.P, _build.I, _build.P, _build.P, _build.P]


def _fn():
    fn = _build.load("modulate").gncde_modulate
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def kernel_inputs(mlp_a, mlp_d, emb):
    """``(depth, wts, Ei, Ej)`` as the kernel reads them (a dozen small
    torch ops: the host work of a :func:`modulate_pair` call besides the
    launch)."""
    with torch.no_grad():
        wts = _mlp_scalars(mlp_a, mlp_d)
        Ei, Ej = _edge_projections(mlp_a, mlp_d, emb)
    if 4 * (wts.numel() + 2 * WIDTH) > _SMEM_LIMIT:
        raise ValueError(f"K7: depth {mlp_a.depth} needs more than 48 KB of weights")
    return mlp_a.depth, wts, Ei.contiguous(), Ej.contiguous()


def launch(A, dA, depth, wts, Ei, Ej, out_dtype=torch.float32):
    """K7's launch (K7bf's with a bfloat16 ``out_dtype``) on contiguous
    float32 CUDA planes ``(B, n, n)`` with the inputs of
    :func:`kernel_inputs`; raises on what the kernel does not take."""
    shape = A.shape
    for P in (A, dA):
        if (P.dim() != 3 or P.shape != shape or shape[1] != shape[2] or not P.is_cuda
                or P.dtype != torch.float32 or not P.is_contiguous()):
            raise ValueError(f"K7: planes must be contiguous float32 CUDA tensors of one "
                             f"(B, n, n) shape; got {tuple(P.shape)} {P.dtype}")
    B, n, _ = shape
    if Ei.shape != (n, 2 * WIDTH) or Ei.device != A.device:
        raise ValueError(f"K7: node projections {tuple(Ei.shape)} do not match n={n} on "
                         f"the planes' device")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K7: output dtype {out_dtype} is neither float32 nor bfloat16")
    bf16 = out_dtype == torch.bfloat16
    outA = torch.empty_like(A, dtype=out_dtype)
    outD = torch.empty_like(dA, dtype=out_dtype)
    err = _fn()(_build.ptr(A), _build.ptr(dA), n, B, depth, _build.ptr(wts),
                wts.numel() // 2, _build.ptr(Ei), _build.ptr(Ej), int(bf16),
                _build.ptr(outA), _build.ptr(outD), _build.stream())
    _build.check(err, "K7bf modulate" if bf16 else "K7 modulate")
    (modulate_pair.bf16 if bf16 else modulate_pair).launches += 1
    return outA, outD


def modulate_pair(A, dA, mlp_a, mlp_d, emb, out_dtype=torch.float32):
    """K7 (K7bf for a bfloat16 ``out_dtype``): ``(A_m, dA_m)`` = the
    per-edge MLP ``mlp_a`` of ``A`` and ``mlp_d`` of ``dA`` with node
    embeddings ``emb`` ``(n, d)``; planes ``(B, n, n)`` float32, outputs in
    ``out_dtype``. On the card both MLPs must be of the kernel's family
    (:func:`modulate_supported`) and share their depth."""
    if not A.is_cuda:
        return plain_modulate_pair(A, dA, mlp_a, mlp_d, emb, out_dtype)
    if not (modulate_supported(mlp_a) and modulate_supported(mlp_d)
            and mlp_a.depth == mlp_d.depth):
        raise ValueError(f"K7: the MLPs must be relu -> identity with biases, width "
                         f"{WIDTH} and one depth >= 1")
    return launch(A, dA, *kernel_inputs(mlp_a, mlp_d, emb), out_dtype)


#: Launches of the f32-output kernel; ``.bf16.launches`` those of K7bf.
modulate_pair.launches = 0
modulate_pair.bf16 = types.SimpleNamespace(launches=0)
