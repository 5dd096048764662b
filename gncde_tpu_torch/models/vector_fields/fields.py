"""Graph vector fields (the functions the CDE solver integrates).

Counterpart of ``gncde_tpu/models/vector_fields/fields.py`` for the
permutation-equivariant fields, undirected and directed, each with or
without ``enc_idx`` modulation. Call signature ``vf(t, y, control) ->
dy/dt`` with a leading batch dim written out: ``t`` is ``(B,)``, ``y`` is
``(B, n, H)`` and the control's path holds per-element knots ``(B, T)`` and
planes ``(B, T-1, n, n)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import ops as ops_config
from ...interp import CubicInterpolation
from ...nn import MLP
from ...ops import fused_step as _fs
from ...ops import megakernel as _mk
from ...ops import modulate as _mod
from ...ops.modulate import modulate_matrix as _modulate_matrix
from ...ops import pair as _pair
from ...ops import tiled as _tiled
from ..neural_nets import IdxEncoder
from .layers import ConvEquivFusionDirectedLayer, ConvEquivFusionLayer


def control_terms(control_adj, t):
    """(A(t), dA(t), time-gradient matrix or None)."""
    if getattr(control_adj, "tgrad_is_unit", False):
        return control_adj.adj(t), control_adj.dadj(t), None
    deriv = control_adj.derivative(t)
    return control_adj.evaluate(t)[..., -1], deriv[..., -1], deriv[..., 0]


def _pallas_plane_dispatch_ok(control_adj, device) -> bool:
    """The gate for the vf-level kernels: the megakernel backend is selected
    (or ``auto`` on a CUDA device), the control's time gradient is the
    implicit unit channel, and the path is cubic Hermite, whose interval
    planes the kernels read. A sparse control (ELL or BCSR) fails the last
    test: its values go to the layers' sparse applies."""
    return (
        ops_config.get_fusion_backend(device) == "megakernel"
        and getattr(control_adj, "tgrad_is_unit", False)
        and isinstance(control_adj.path, CubicInterpolation)
    )


def _mlp_params(mlp):
    return [p for layer in mlp.layers for p in (layer.weight, layer.bias) if p is not None]


def _plane_dtype():
    """The modulated planes' dtype: bf16 under ``fusion_precision: bf16``
    (the JAX package's ``out_dtype``), else f32."""
    return torch.bfloat16 if ops_config.bf16_precision() else torch.float32


class _FusedModulate(torch.autograd.Function):
    """Forward: K7 on CUDA planes (its plain version on CPU ones), with bf16
    outputs (K7bf) under ``fusion_precision: bf16``. Backward: autograd
    through the plain f32 :func:`_modulate_matrix`, recomputed from the
    saved planes and embedding, the planes' cotangents cast to f32 first,
    as ``_fused_modulate_bwd`` differentiates ``_fused_modulate_ref``'s
    cast. Inputs: ``(mlp_a, mlp_d, A, dA, emb, *params of mlp_a, *params of
    mlp_d)``; the parameters are passed so that autograd returns their
    gradients."""

    @staticmethod
    def forward(ctx, mlp_a, mlp_d, A, dA, emb, *params):
        ctx.mlps = (mlp_a, mlp_d)
        ctx.save_for_backward(A, dA, emb)
        return _mod.modulate_pair(A, dA, mlp_a, mlp_d, emb, _plane_dtype())

    @staticmethod
    def backward(ctx, gA, gD):
        mlp_a, mlp_d = ctx.mlps
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need)
                      for x, need in zip(ctx.saved_tensors, needs)]
            outs = (_modulate_matrix(leaves[0], mlp_a, leaves[2]),
                    _modulate_matrix(leaves[1], mlp_d, leaves[2]))
            inputs = leaves + _mlp_params(mlp_a) + _mlp_params(mlp_d)
            wrt = [x for x, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(outs, wrt, (gA.float(), gD.float())))
        return (None, None, *[next(grads) if need else None for need in needs])


def fused_modulate(A, dA, mlp_a, mlp_d, emb):
    """Differentiable fused modulation of both f32 planes, ``(B, n, n)``
    each in the precision's dtype (unpadded: the JAX package pads to its
    consumer's tile)."""
    return _FusedModulate.apply(mlp_a, mlp_d, A, dA, emb,
                                *_mlp_params(mlp_a), *_mlp_params(mlp_d))


def enc_idx_planes(control_adj, t, batch):
    """``(A(t), dA(t))`` ``(B, n, n)`` f32 from a cubic control's interval
    Hermite planes, as the enc_idx route evaluates them before modulation."""
    path = control_adj.path
    ts = path.ts if path.ts.dim() == 2 else path.ts.unsqueeze(0).expand(batch, -1)
    idx, tau = _mk.interval(ts, t)
    return _mk.hermite(tuple(path.coeffs), idx, tau)


def _enc_idx_pallas_eval(vf, control_adj, t, y):
    """The enc_idx eval on the plane-pair kernels: ``A(t)``, ``dA(t)`` in f32
    from the interval Hermite planes (bf16 stacks under ``fusion_precision:
    bf16`` read as stored and upcast), both modulated by K7 (K7bf under
    bf16) when both MLPs are of its family and share their depth, else by
    the decomposed :func:`_modulate_matrix` (its planes cast to bf16 under
    bf16), as the JAX package dispatches; then
    :func:`~gncde_tpu_torch.ops.pair.tiled_vf_eval_planes` (K6 per layer,
    the planes differentiable)."""
    A_t, dA_t = enc_idx_planes(control_adj, t, y.shape[0])
    emb = vf.idx_enc.node_embedding()
    mlp_a, mlp_d = vf.msg_func_adj, vf.msg_func_adj_deriv
    if (_mod.modulate_supported(mlp_a) and _mod.modulate_supported(mlp_d)
            and mlp_a.depth == mlp_d.depth):
        A_m, dA_m = fused_modulate(A_t, dA_t, mlp_a, mlp_d, emb)
    else:
        A_m = _modulate_matrix(A_t, mlp_a, emb).to(_plane_dtype())
        dA_m = _modulate_matrix(dA_t, mlp_d, emb).to(_plane_dtype())
    return _pair.tiled_vf_eval_planes(A_m, dA_m, y, vf)


def _fused_rk_step_hook(vf, tab, t, y, h, control_adj, f0):
    """Step-level fast path (the solver's ``_rk_step`` hook): one explicit
    FSAL RK step as one K11 launch (``ops/fused_step.py``) when the per-eval
    dispatch would take K1 anyway. Returns None, and the solver runs its
    stage loop, when the field has ``enc_idx``, the fused step is off, the
    megakernel gate fails, n exceeds ``MEGAKERNEL_MAX_N``, or the layer
    stack does not map the state width to itself (the stage combinations
    add k's to y) -- the JAX package's own conditions. Under
    ``fusion_precision: bf16`` the step is K11bf."""
    if vf.enc_idx or not ops_config.get_fused_step():
        return None
    if not _pallas_plane_dispatch_ok(control_adj, y.device):
        return None
    if y.shape[-2] > _mk.MEGAKERNEL_MAX_N:
        return None
    dims = [(l.conv_layer.linear.in_features, l.conv_layer.linear.out_features)
            for l in vf.gnn_layers]
    if dims[0][0] != dims[-1][1] or y.shape[-1] != dims[0][0]:
        return None
    path = control_adj.path
    return _fs.fused_rk_step(tab, tuple(path.coeffs), path.ts, t, y, h, f0, vf,
                             ops_config.bf16_precision())


def _make_stack(input_dim, hidden_dim, output_dim, num_layers, generator, device,
                layer_cls=ConvEquivFusionLayer):
    """num_layers-1 hidden layers + one output layer."""
    layers = []
    for _ in range(num_layers - 1):
        layers.append(layer_cls(input_dim, hidden_dim, generator=generator, device=device))
        input_dim = hidden_dim
    layers.append(layer_cls(input_dim, output_dim, generator=generator, device=device))
    return nn.ModuleList(layers)


class PermEquivGraphVectorField(nn.Module):
    """Undirected permutation-equivariant vf (perm_equiv_graph_vector_field.py).

    ``enc_idx=True`` adds an :class:`IdxEncoder` node embedding and two
    per-edge MLPs (width 8, depth 2) that modulate ``A(t)`` and ``dA(t)``
    before the layer stack (the JAX package's fixed mode of the reference's
    dead undirected branch). Built after the layer stack, in the JAX field
    order ``idx_enc``, ``msg_func_adj``, ``msg_func_adj_deriv``.
    """

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, data_embed_dim: int, num_nodes: int,
                 enc_idx: bool = False, enc_type: str = "mlp", idx_dim: int = 512, *,
                 generator: torch.Generator, device=None, **_unused):
        super().__init__()
        self.gnn_layers = _make_stack(input_dim, hidden_dim, output_dim,
                                      num_layers, generator, device)
        if enc_idx:
            kw = dict(generator=generator, device=device)
            self.idx_enc = IdxEncoder(num_nodes, idx_dim, type=enc_type, **kw)
            self.msg_func_adj = MLP(2 * idx_dim + 1, 1, width_size=8, depth=2, **kw)
            self.msg_func_adj_deriv = MLP(2 * idx_dim + 1, 1, width_size=8, depth=2, **kw)
        else:
            self.idx_enc = self.msg_func_adj = self.msg_func_adj_deriv = None
        self.data_embed_dim = data_embed_dim
        self.num_nodes = num_nodes
        self.enc_idx = enc_idx

    fused_rk_step = _fused_rk_step_hook

    def forward(self, t: torch.Tensor, y: torch.Tensor, control_adj) -> torch.Tensor:
        t = t.expand(y.shape[0]) if t.dim() == 0 else t
        if _pallas_plane_dispatch_ok(control_adj, y.device):
            n = y.shape[-2]
            path = control_adj.path
            if self.enc_idx:
                if n <= _tiled.TILED_MAX_N:
                    # The per-edge MLP breaks the Hermite factorisation, so
                    # K1/K2 and K3/K4 do not apply: modulated planes through
                    # the plane-pair kernels, at every n.
                    return _enc_idx_pallas_eval(self, control_adj, t, y)
            elif n <= _mk.MEGAKERNEL_MAX_N:
                return _mk.megakernel_vf(path.coeffs, path.ts, t, y, self,
                                         ops_config.bf16_precision())
            elif n <= _tiled.TILED_MAX_N:
                # K1/K2 serve n <= 640; above it the tiled kernels (twitter
                # n=1000, tgbn-genre n=1505 and beyond).
                return _tiled.tiled_vf_eval(path.coeffs, path.ts, t, y, self,
                                            red=getattr(control_adj, "red", None))
            # Beyond the tiled cap the dense layer stack below runs.

        adj, adj_derivative, tgrad = control_terms(control_adj, t)
        if self.enc_idx and not isinstance(adj, torch.Tensor):
            raise NotImplementedError(
                "enc_idx modulation needs dense planes; a sparse control (ELL or BCSR) "
                "cannot be modulated (neither can the JAX package's)")
        if self.enc_idx:
            emb = self.idx_enc.node_embedding()
            adj = _modulate_matrix(adj, self.msg_func_adj, emb)
            adj_derivative = _modulate_matrix(adj_derivative, self.msg_func_adj_deriv, emb)
        out = y
        for i, layer in enumerate(self.gnn_layers):
            out = layer(out, adj, adj_derivative)
            if i < len(self.gnn_layers) - 1:
                out = torch.relu(out)
        if tgrad is not None:
            out = tgrad.mean(-2)[..., :, None] * out
        return out


class PermEquivDirGraphVectorField(nn.Module):
    """Directed 11-term perm-equiv vf (perm_equiv_dir_graph_vector_field.py),
    with optional ``enc_idx`` modulation.

    As the JAX field, it builds the index encoder (``enc_type``, width
    ``idx_dim``) and both modulation MLPs whether or not ``enc_idx`` is set,
    in the JAX field order ``gnn_layers``, ``idx_enc``, ``msg_func_adj``,
    ``msg_func_adj_deriv``, so that parameter lists, optimiser state and
    ``save_weights`` files agree; without ``enc_idx`` the forward never
    reads them (their gradients are zero). The dispatch is the undirected
    field's: with ``enc_idx``, K7 and K6a/K6b up to ``TILED_MAX_N``;
    without, K1/K2 for n <= 640 and the tiled kernels up to
    ``TILED_MAX_N``; the layer stack beyond (and for sparse controls), each
    reading the directed basis off the layers.
    """

    #: The JAX field order (``nn/convert.py``).
    JAX_FIELDS = ("gnn_layers", "idx_enc", "msg_func_adj", "msg_func_adj_deriv")

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, data_embed_dim: int, num_nodes: int,
                 enc_idx: bool = False, enc_type: str = "mlp", idx_dim: int = 512, *,
                 generator: torch.Generator, device=None, **_unused):
        super().__init__()
        self.gnn_layers = _make_stack(input_dim, hidden_dim, output_dim, num_layers,
                                      generator, device, ConvEquivFusionDirectedLayer)
        kw = dict(generator=generator, device=device)
        self.idx_enc = IdxEncoder(num_nodes, idx_dim, type=enc_type, **kw)
        self.msg_func_adj = MLP(2 * idx_dim + 1, 1, width_size=8, depth=2, **kw)
        self.msg_func_adj_deriv = MLP(2 * idx_dim + 1, 1, width_size=8, depth=2, **kw)
        self.data_embed_dim = data_embed_dim
        self.num_nodes = num_nodes
        self.enc_idx = enc_idx

    fused_rk_step = _fused_rk_step_hook
    # The undirected field's dispatch: every route it takes reads the basis
    # (8 or 11 terms) off the layers.
    forward = PermEquivGraphVectorField.forward
