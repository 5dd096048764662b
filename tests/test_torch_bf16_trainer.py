"""The slice as a whole under ``fusion_precision: bf16`` on the CPU: two
parameter-synced training steps of the flagship model on the flagship's
dynamic heat data cut to n = 16, the port against the JAX dyn trainer's
step (``make_step_fn``) with ``set_fusion_precision("bf16")`` (the JAX
package's production precision; on the CPU its dense layers' bf16 apply,
``layers.py:147-155``). The port runs its dense layers' bf16 apply and,
under the ``megakernel`` backend, the plain versions of K1bf and K2bf.

Tolerances are stated against the same run's bf16-to-f32 distance of the
JAX trainer (its steps repeated in f32): the relative distance of the
losses and logged max_grads, and the fraction of parameter components that
end a step more than 1e-2 apart (AdamW's first update moves each component
by lr in the sign of its gradient, so a near-zero component whose sign
differs lands 0.2 away; the rest agree closely). The port's dense route
computes the JAX route's arithmetic; the megakernel route rounds at the
kernels' points (B1, B2^T and C^T formed in bf16, the reductions of the
unrounded planes), another bf16 computation. Each is held within a third
of that distance, as a route run in f32 would not be (measured: dense,
losses 5.1e-4 and parameters 2.8%; megakernel, 1.2e-3 and 2.2%; against
2.2e-2 and 28%).

Also: under bf16 the enc_idx kernel route runs K7bf and K6a-bf/K6b-bf (on
the CPU their plain versions) on bf16 planes, as the JAX package modulates
into bf16 planes there (its parity with the JAX bf16 route:
tests/test_torch_enc_idx_bf16.py).
"""

import numpy as np
import pytest
import torch

from gncde_tpu import ops as jops
from gncde_tpu.configs import MSELossCfg as JMSE, OptimiserCfg as JOpt
from gncde_tpu.models.continuous import make_control as j_make_control
from gncde_tpu.nn import is_inexact_array, partition
from gncde_tpu.train.trainer import make_step_fn as j_make_step_fn
from gncde_tpu_torch import ops
from gncde_tpu_torch.configs import MSELossCfg, OptimiserCfg
from gncde_tpu_torch.models import make_control
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import megakernel_bwd as mkb
from gncde_tpu_torch.train.trainer import make_step_fn

from test_torch_trainer import OPT, _small_models
from torch_parity_utils import copy_jax_to_torch, jax_leaves

STEPS = 2


@pytest.fixture(scope="module")
def heat():
    from gncde_tpu.data import ode_dataset as jds
    from gncde_tpu.data import pipeline as jpipe

    spec = jds.ODEDatasetSpec(name="heat", batch_size=2, dynamic_graph=True,
                              all_dynamic=True, num_nodes=16, time_tick=8,
                              method="Tsit5", amp_range=(1.0, 1.0), seed=1234)
    return jpipe.get_split_train_data(spec, jds.generate(spec), "cubic")


@pytest.fixture
def reset():
    yield
    ops.set_fusion_precision("f32")
    ops.set_fusion_backend("auto")
    jops.set_fusion_precision("f32")
    jops.set_fusion_backend("auto")


def _params(model_t):
    return np.concatenate([p.detach().numpy().ravel() for p in model_t.parameters()])


def _set_precision(precision, backend):
    jops.set_fusion_precision(precision)
    jops.set_fusion_backend("dense")
    ops.set_fusion_precision(precision)
    ops.set_fusion_backend(backend)


@pytest.fixture(scope="module")
def jax_runs(heat):
    """STEPS steps of the JAX trainer at bf16 and at f32 from the same init:
    {precision: (losses, max_grads, parameters after each step in the
    port's order, the port's state dict of the model before each step)}."""
    import jax.numpy as jnp

    out = {}
    try:
        for precision in ("bf16", "f32"):
            _set_precision(precision, "dense")
            model_j, spare = _small_models()
            opt_j, _ = JOpt(**OPT).build()
            opt_state = opt_j.init(partition(model_j, is_inexact_array)[0])
            step_j = j_make_step_fn(opt_j, JMSE(name="MSE").build())
            f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
            ctrl = j_make_control("cubic", f32(heat["train_t"]),
                                  tuple(f32(c) for c in heat["train_graph_path_coeffs"]),
                                  slim=True)
            data = (f32(heat["train_t"]), ctrl, f32(heat["train_true_y"]),
                    f32(heat["true_y0"]))
            run = ([], [], [], [])
            for _ in range(STEPS):
                # The step donates the model's buffers: keep a copy of it.
                copy_jax_to_torch(model_j, spare)
                run[3].append({k: v.clone() for k, v in spare.state_dict().items()})
                loss, model_j, opt_state, g, _ = step_j(model_j, opt_state, data)
                copy_jax_to_torch(model_j, spare)
                run[0].append(float(loss))
                run[1].append(float(g))
                run[2].append(_params(spare))
            out[precision] = run
    finally:
        jops.set_fusion_precision("f32")
        jops.set_fusion_backend("auto")
    return out


def _port_steps(d, states, backend):
    """The port's step from each JAX model (synced: step k starts from the
    JAX trainer's parameters before its step k) under bf16 and ``backend``:
    (losses, max_grads, parameters after each step)."""
    _set_precision("bf16", backend)
    _, model_t = _small_models()
    opt_t, schedule = OptimiserCfg.from_dict(OPT).build(model_t.parameters())
    step_t = make_step_fn(opt_t, schedule, MSELossCfg(name="MSE").build(), True)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    ctrl = make_control("cubic", t(d["train_t"]), tuple(t(c) for c in d["train_graph_path_coeffs"]))
    assert ctrl.path.coeffs[0].dtype == torch.bfloat16  # stored bf16 under bf16
    data = (t(d["train_t"]), ctrl, t(d["train_true_y"]), t(d["true_y0"]))
    run = ([], [], [])
    for state in states:
        model_t.load_state_dict(state)
        loss, g, _ = step_t(model_t, data)
        run[0].append(float(loss))
        run[1].append(float(g))
        run[2].append(_params(model_t))
    return run


def _dist(a, b):
    """(largest relative distance of the losses and max_grads, fraction of
    parameter components more than 1e-2 apart after the steps) of two runs.
    AdamW's first update is a step of lr in the sign of each gradient
    component, so two runs' parameters either agree or differ by about
    2 lr where a near-zero component's sign differs: the fraction counts
    those."""
    rel = max(abs(x - y) / abs(y) for k in (0, 1) for x, y in zip(a[k], b[k]))
    par = max(float(np.mean(np.abs(x - y) > 1e-2)) for x, y in zip(a[2], b[2]))
    return rel, par


@pytest.mark.parametrize("backend", ["dense", "megakernel"])
def test_bf16_two_synced_flagship_steps_track_jax(heat, jax_runs, reset, backend):
    before = (mk.megakernel_vf_eval.bf16.launches, mkb.megakernel_vf_bwd.bf16.launches)
    got = _port_steps(heat, jax_runs["bf16"][3], backend)
    # CPU: the plain versions ran, no kernel launched.
    assert (mk.megakernel_vf_eval.bf16.launches,
            mkb.megakernel_vf_bwd.bf16.launches) == before
    assert all(np.isfinite(got[0])) and len(set(got[0])) == STEPS
    gap = _dist(jax_runs["bf16"], jax_runs["f32"])
    err = _dist(got, jax_runs["bf16"])
    print(backend, "port vs JAX bf16", err, "JAX bf16 vs f32", gap)
    assert gap[0] > 0.0 and gap[1] > 0.0
    assert err[0] <= gap[0] / 3.0, (err, gap)
    assert err[1] <= gap[1] / 3.0, (err, gap)


def test_bf16_refuses_the_enc_idx_kernel_route(reset):
    """The enc_idx field on the kernel route (the megakernel backend) under
    bf16, which raised naming B2 until K7bf and K6a-bf/K6b-bf were ported
    (the name is kept from then): it runs, equals its plain route on the
    same inputs -- A(t), dA(t) in f32 from the bf16 Hermite stacks, the
    plain K7bf's bf16 planes, the layer stack on them -- bit for bit, and
    lies a finite, nonzero distance from the f32 call (the witness that
    the bf16 planes were used). No kernel launches on the CPU."""
    from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
    from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
    from gncde_tpu_torch.ops import modulate as tmod
    from gncde_tpu_torch.ops import pair as tp

    n, H, B, T = 12, 4, 2, 4
    rng = np.random.default_rng(0)
    ts = torch.tensor(np.cumsum(rng.uniform(0.1, 0.3, (B, T)), 1).astype(np.float32))
    planes = tuple(torch.tensor(rng.uniform(0.0, 0.1, (B, T - 1, n, n)).astype(np.float32))
                   for _ in range(4))
    vf = TVF(H, H, H, 2, 1, n, enc_idx=True, enc_type="emb", idx_dim=4,
             generator=torch.Generator().manual_seed(0))
    y = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32))
    t = ts[:, 1] + 0.05
    ops.set_fusion_backend("megakernel")
    bf16_planes = tuple(p.to(torch.bfloat16) for p in planes)
    with torch.no_grad():
        f32 = vf(t, y, MatrixControl(CubicInterpolation(ts, bf16_planes)))
        ops.set_fusion_precision("bf16")
        launches = (tmod.modulate_pair.bf16.launches, tp.pair_call.bf16.launches)
        out = vf(t, y, MatrixControl(CubicInterpolation(ts, bf16_planes)))
        assert (tmod.modulate_pair.bf16.launches, tp.pair_call.bf16.launches) == launches
        idx, tau = mk.interval(ts, t)
        A_t, dA_t = mk.hermite(bf16_planes, idx, tau)
        A_m, dA_m = tmod.plain_modulate_pair(A_t, dA_t, vf.msg_func_adj,
                                             vf.msg_func_adj_deriv,
                                             vf.idx_enc.node_embedding(), torch.bfloat16)
        ref = tp.tiled_vf_eval_planes(A_m, dA_m, y, vf)
    assert out.shape == y.shape and out.dtype == torch.float32
    assert torch.equal(out, ref)
    gap = float((out - f32).abs().max())
    assert np.isfinite(gap) and gap > 0.0
