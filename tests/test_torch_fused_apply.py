"""Port parity of the dense per-layer fused applies and the 4-slab apply:
``ops/pipeline.py`` (K13, backend ``"pipeline"``), ``ops/fused_basis.py``
(K12, backend ``"pallas"``) and ``ops/tiled.py`` ``tiled_abar_apply`` (K5c).

On the CPU each wrapper runs its kernel's plain version; the JAX functions
run their Pallas kernels in interpret mode. Held in values and in the
gradients of A, dA, M and the basis parameters, rtol 1e-5 / 1e-4 (float32
on both sides, sums in another order); ``tiled_abar_apply`` on the same bf16
operands within 1e-4 of each output's scale (its VJP rounds g to bf16 on
both sides). Then ``ConvEquivFusionLayer`` under each backend, and the
trainer's acceptance of both names (the training steps under
``fusion_backend=pipeline``: tests/test_torch_pipeline_trainer.py). The
kernels are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 14).
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gncde_tpu import ops as jops
from gncde_tpu.models.vector_fields.layers import ConvEquivFusionLayer as JLayer
from gncde_tpu.ops.pallas import fused_basis as jfb
from gncde_tpu.ops.pallas import pipeline as jpl
from gncde_tpu.ops.pallas import tiled as jtiled
from gncde_tpu_torch import ops
from gncde_tpu_torch.models.vector_fields.layers import ConvEquivFusionLayer as TLayer
from gncde_tpu_torch.ops import fused_basis as tfb
from gncde_tpu_torch.ops import pipeline as tpl
from gncde_tpu_torch.ops import tiled as tt

from torch_parity_utils import copy_jax_to_torch


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture
def backends():
    yield
    ops.set_fusion_backend("auto")
    jops.set_fusion_backend("auto")


def _apply_inputs(n, H, B=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    return dict(A=np.abs(f(B, n, n, scale=0.3)), dA=f(B, n, n, scale=0.3), M=f(B, n, H),
                G=f(B, n, H),
                params=[rng.uniform(-1 / 15, 1 / 15, 2).astype(np.float32) for _ in range(8)])


def _port_apply(fn, x):
    leaves = [torch.tensor(v, requires_grad=True) for v in (x["A"], x["dA"], x["M"])]
    params = [torch.tensor(p, requires_grad=True) for p in x["params"]]
    out = fn(*leaves, params, False, True)
    grads = torch.autograd.grad((out * torch.tensor(x["G"])).sum(), leaves + params)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_apply(fn, x):
    """Per element (the JAX functions are unbatched); parameter gradients
    summed over the batch as the port's are."""
    params = [jnp.asarray(p) for p in x["params"]]
    outs, grads = [], None
    with pltpu.force_tpu_interpret_mode():
        for b in range(x["A"].shape[0]):
            out, vjp = jax.vjp(lambda A, dA, M, p: fn(A, dA, M, p, False, True),
                               jnp.asarray(x["A"][b]), jnp.asarray(x["dA"][b]),
                               jnp.asarray(x["M"][b]), params)
            gA, gdA, gM, gp = vjp(jnp.asarray(x["G"][b]))
            outs.append(np.asarray(out))
            g = [np.asarray(gA), np.asarray(gdA), np.asarray(gM)] + [np.asarray(v) for v in gp]
            grads = [g] if grads is None else grads + [g]
    per = list(zip(*grads))
    return np.stack(outs), [np.stack(v) for v in per[:3]] + [sum(v) for v in per[3:]]


@pytest.mark.parametrize("n", [20, 21], ids=["n20", "n21-no-tile-divisor"])
@pytest.mark.parametrize("which", ["pipeline", "pallas"])
def test_fused_applies_match_jax(which, n):
    """Values and every gradient against the JAX function. At n = 21 no
    TPU row tile divides n and JAX's fused_apply_pallas falls back to the
    decomposed XLA path; the port's kernel serves it (same function)."""
    x = _apply_inputs(n, 5, seed=n)
    port_fn, jax_fn = {"pipeline": (tpl.pipeline_fused_apply, jpl.pipeline_fused_apply),
                       "pallas": (tfb.fused_apply_pallas, jfb.fused_apply_pallas)}[which]
    counter = tpl.fused_conv_stream if which == "pipeline" else tfb._pallas_forward
    before = counter.launches
    got, got_g = _port_apply(port_fn, x)
    assert counter.launches == before  # CPU: plain versions
    ref, ref_g = _jax_apply(jax_fn, x)
    _close(got, ref, 1e-5)
    for a, b in zip(got_g, ref_g):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("backend", ["pipeline", "pallas"])
def test_layer_backends_match_jax(backends, backend):
    """ConvEquivFusionLayer (RMSNorm -> Linear -> fused apply + identity)
    under each backend in both packages, copied weights, batch of 2."""
    n, H = 16, 6
    x = _apply_inputs(n, H, seed=3)
    layer_j = JLayer(input_dim=H, output_dim=H, key=jr.PRNGKey(5))
    layer_t = TLayer(H, H, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(layer_j, layer_t)
    ops.set_fusion_backend(backend)
    jops.set_fusion_backend(backend)
    feats = torch.tensor(x["M"], requires_grad=True)
    out = layer_t(feats, torch.tensor(x["A"]), torch.tensor(x["dA"]))
    (out * torch.tensor(x["G"])).sum().backward()
    with pltpu.force_tpu_interpret_mode():
        def loss(layer, f):
            o = jax.vmap(lambda fb, a, da: layer(fb, a, da))(f, jnp.asarray(x["A"]),
                                                            jnp.asarray(x["dA"]))
            return jnp.sum(o * x["G"]), o

        (_, ref), (g_layer, g_feats) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            layer_j, jnp.asarray(x["M"]))
    _close(out.detach().numpy(), ref, 1e-5)
    _close(feats.grad.numpy(), g_feats, 1e-4)
    from torch_parity_utils import jax_leaves

    jg = jax_leaves(g_layer)
    for name, p in layer_t.named_parameters():
        _close(p.grad.numpy(), jg[name.replace(".", "/")], 1e-4)


def test_tiled_abar_apply_matches_jax():
    """Values and VJP (slabs, both weight vectors, M) of tiled_abar_apply
    against the JAX one on its ragged path (n = 50, tile 64)."""
    n, H, tile = 50, 8, 64
    rng = np.random.default_rng(4)
    slabs = [(0.1 * rng.normal(size=(n, n))).astype(np.float32) for _ in range(4)]
    w_row = rng.normal(size=4).astype(np.float32)
    w_col = rng.normal(size=4).astype(np.float32)
    NP = -(-n // tile) * tile
    M = np.zeros((NP, H), np.float32)
    M[:n] = rng.normal(size=(n, H))
    G = np.zeros((NP, H), np.float32)
    G[:n] = rng.normal(size=(n, H))

    leaves = [torch.tensor(v, requires_grad=True) for v in (*slabs, w_row, w_col, M)]
    before = tt.abar_call.launches
    out = tt.tiled_abar_apply(tuple(leaves[:4]), leaves[4], leaves[5], leaves[6], tile)
    got_g = torch.autograd.grad((out * torch.tensor(G)).sum(), leaves)
    assert tt.abar_call.launches == before
    assert out.shape == (NP, H) and not out[n:].any()

    out_j, vjp = jax.vjp(lambda s, wr, wc, m: jtiled.tiled_abar_apply(s, wr, wc, m, tile),
                         tuple(jnp.asarray(s) for s in slabs), jnp.asarray(w_row),
                         jnp.asarray(w_col), jnp.asarray(M))
    gs, gwr, gwc, gM = vjp(jnp.asarray(G))
    _close(out.detach().numpy(), out_j, 1e-4)
    for a, b in zip(got_g, [*gs, gwr, gwc, gM]):
        _close(a.numpy(), b, 1e-4)


@pytest.mark.parametrize("backend", ["pipeline", "pallas"])
def test_trainer_accepts_the_backends(backends, backend):
    from gncde_tpu_torch.run import common
    from gncde_tpu_torch.train.trainer import Trainer

    with open("configs/dyn/perm_equiv_gncde.yaml") as f:
        cfg = common.apply_overrides(common.safe_load(f.read()),
                                     [f"fusion_backend={backend}", "device=cpu"])
    tr = Trainer.from_dict(cfg)  # validates
    tr.run_initialisations()
    assert ops.get_fusion_backend("cuda") == backend
    with pytest.raises(ValueError):
        Trainer.from_dict(common.apply_overrides(cfg, ["fusion_backend=streamed"]))
