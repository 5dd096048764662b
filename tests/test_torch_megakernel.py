"""Port parity for K1 and K2 (gncde_tpu_torch/ops/megakernel*.py).

On the CPU the wrappers run their plain PyTorch versions; they are held
against the JAX megakernels ``megakernel_vf_eval`` / ``megakernel_vf_bwd`` in
Pallas interpret mode, batched with distinct per-element planes, interval
indices and offsets (the batch-grid kernels ``_forward_batched`` /
``bwd_call_batched``). The CUDA kernels themselves are compared with the
plain versions by ``tests/test_torch_kernels_cuda.py`` and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gncde_tpu.interp import backward_hermite_coefficients as j_bhc
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.ops.pallas import megakernel as jmk
from gncde_tpu.ops.pallas import megakernel_bwd as jmkb
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import megakernel_bwd as mkb

from torch_parity_utils import copy_jax_to_torch, hermite_path

N, H, L, B, T = 20, 8, 2, 3, 6


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    ts, A = hermite_path(rng, B, T, N)
    coeffs_j = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    # Per-element query times in different intervals.
    t = np.array([ts[b, 1 + b] + 0.37 * (ts[b, 2 + b] - ts[b, 1 + b]) for b in range(B)],
                 np.float32)
    Z = rng.normal(size=(B, N, H)).astype(np.float32)
    G = rng.normal(size=(B, N, H)).astype(np.float32)
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L,
               data_embed_dim=1, num_nodes=N, key=jr.PRNGKey(seed + 8))
    vf_t = TVF(H, H, H, L, 1, N, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    planes = tuple(torch.tensor(np.asarray(c)) for c in coeffs_j)
    idx, tau = mk.interval(torch.as_tensor(ts), torch.as_tensor(t))
    assert len(set(idx.tolist())) == B  # distinct interval per element
    return dict(ts=ts, t=t, Z=Z, G=G, coeffs_j=coeffs_j, vf_j=vf_j, vf_t=vf_t,
                planes=planes, idx=idx, tau=tau)


def _close(got, ref, rtol):
    """rtol against the array's own scale (entries near 0 get scale-relative
    slack: sums over n^2 products reduce in different orders)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def test_plain_k1_matches_jax_megakernel_interpret():
    s = _setup()
    with pltpu.force_tpu_interpret_mode():
        ref = jax.vmap(lambda c, ts_, t_, z: jmk.megakernel_vf_eval(c, ts_, t_, z, s["vf_j"]))(
            s["coeffs_j"], jnp.asarray(s["ts"]), jnp.asarray(s["t"]), jnp.asarray(s["Z"]))
    before = mk.megakernel_vf_eval.launches
    got = mk.megakernel_vf_eval(s["planes"], s["idx"], s["tau"], torch.as_tensor(s["Z"]),
                                mk.layer_params(s["vf_t"]))
    assert mk.megakernel_vf_eval.launches == before  # CPU: plain version, no launch
    # f32 on both sides; the kernel's matmul and n-sums round differently.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_plain_k2_matches_jax_megakernel_bwd_interpret():
    s = _setup(seed=1)
    with pltpu.force_tpu_interpret_mode():
        d_t, d_Z, d_vf = jax.vmap(
            lambda c, ts_, t_, z, g: jmkb.megakernel_vf_bwd(c, ts_, t_, z, s["vf_j"], g,
                                                            need_t=True))(
            s["coeffs_j"], jnp.asarray(s["ts"]), jnp.asarray(s["t"]), jnp.asarray(s["Z"]),
            jnp.asarray(s["G"]))
    dtau, dZ, per_layer = mkb.megakernel_vf_bwd(
        s["planes"], s["idx"], s["tau"], torch.as_tensor(s["Z"]),
        mk.layer_params(s["vf_t"]), torch.as_tensor(s["G"]), need_tau=True)
    rtol = 1e-4  # cotangents reduce over n^2 products in a different order
    _close(dZ, d_Z, rtol)
    _close(dtau, d_t, rtol)
    for l, (dnw, dnb, dW, dlb, dbasis) in enumerate(per_layer):
        jl = d_vf.gnn_layers[l]
        _close(dnw, jl.conv_layer.norm.weight, rtol)
        _close(dnb, jl.conv_layer.norm.bias, rtol)
        _close(dW, jl.conv_layer.linear.weight, rtol)
        _close(dlb, jl.conv_layer.linear.bias, rtol)
        _close(dbasis, jnp.stack(jl.params, axis=1), rtol)


def test_plain_k2_without_tau_leaves_dtau_zero():
    s = _setup(seed=2)
    args = (s["planes"], s["idx"], s["tau"], torch.as_tensor(s["Z"]),
            mk.layer_params(s["vf_t"]), torch.as_tensor(s["G"]))
    with_tau = mkb.megakernel_vf_bwd(*args, need_tau=True)
    no_tau = mkb.megakernel_vf_bwd(*args, need_tau=False)
    assert float(no_tau[0].abs().max()) == 0.0
    np.testing.assert_array_equal(no_tau[1].numpy(), with_tau[1].numpy())



# Layer widths of the CDE-wrapper fields at n <= 640 (the last layer emits
# H * E * 2 columns): configs/tgb/trade_*perm_equiv_gncde*.yaml (n=255) and
# configs/pgt/england_perm_equiv_gncde.yaml (n=129); and an input wider than
# the kernels' 64.
WIDTH_CASES = {"trade": ((32, 32, 32, 32, 512), True),
               "england": ((64, 64, 64, 1024), True),
               "input-65": ((65, 8), False)}


@pytest.mark.parametrize("name", list(WIDTH_CASES))
def test_kernel_input_check_takes_the_wide_cde_wrapper_layers(name):
    """The check K1 and K2 run before every launch on the card takes outputs
    up to 4096 columns (it refused every layer wider than 64) and still
    refuses inputs wider than 64. The check alone runs here; no kernel is
    built or called."""
    widths, ok = WIDTH_CASES[name]
    n, b = 8, 2
    planes = tuple(torch.zeros((b, T - 1, n, n)) for _ in range(4))
    idx, tau = torch.zeros(b, dtype=torch.long), torch.zeros(b)
    Z = torch.zeros((b, n, widths[0]))
    layers = [dict(norm_w=torch.ones(hi), norm_b=torch.zeros(hi), W=torch.zeros((ho, hi)),
                   lin_b=torch.zeros(ho), basis=torch.zeros((8, 2)))
              for hi, ho in zip(widths[:-1], widths[1:])]
    if ok:
        mk._check_inputs(planes, idx, tau, Z, layers)
        assert mk.scratch_width(layers) == max(widths)
    else:
        with pytest.raises(ValueError, match="inputs up to 64"):
            mk._check_inputs(planes, idx, tau, Z, layers)


# The card's shared memory a CTA can use (H100: 227 KB of the SM's 256 KB),
# and the row pass's static shared memory (colS, colW, the slices' sums,
# Fs, zrows, scratch: csrc/megakernel_common.cuh rows_kernel).
SMEM_LIMIT = 227 * 1024
ROW_STATIC_BYTES = 4 * (2 * 128 + 2 * 2 * 256 + 8 + 16 * 64 + 16 * 64)
WIDTHS = [1, 2, 3, 5, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256,
          511, 512, 1000, 1024, 2047, 4095, 4096]


def _check_plan(p, n, B, H):
    assert p.bm in (4, 8, 16) and p.cc in (1, 2, 4) and p.cw == 512 * p.cc // p.bm
    assert p.cw in (32, 64, 128)
    assert (p.groups - 1) * p.cw < H <= p.groups * p.cw  # no empty group
    assert H > mk.MAX_IN or p.groups == 1  # a layer that feeds another is one group
    assert p.ctas == -(-n // p.bm) * p.groups * B
    assert p.smem_bytes + ROW_STATIC_BYTES <= SMEM_LIMIT


def test_k1_row_plan_fits_the_card_at_every_n_and_width():
    """The f32 row pass's plan (``row_plan``, plain Python) for every n the
    kernels serve and widths up to MAX_OUT: a CTA shape the kernel is built
    for (csrc/megakernel_common.cuh launch_rows refuses any other) and
    shared memory within the card's 227 KB (the largest n at every width
    1 .. 4096, which bounds the rest)."""
    for n in range(1, mk.MEGAKERNEL_MAX_N + 1):
        for H in WIDTHS:
            for B in (1, 4):
                _check_plan(mk.row_plan(n, B, H), n, B, H)
    for H in range(1, mk.MAX_OUT + 1):
        _check_plan(mk.row_plan(mk.MEGAKERNEL_MAX_N, 1, H), mk.MEGAKERNEL_MAX_N, 1, H)


@pytest.mark.parametrize("n,B,widths", [(400, 4, (16, 16, 16)), (255, 4, (32, 32, 32, 32, 512)),
                                        (400, 4, (32, 32, 32, 32))],
                         ids=["flagship", "trade", "bench"])
def test_k1_row_plan_fills_the_card_at_the_main_path_shapes(n, B, widths):
    """Every layer's row pass runs at least one CTA per SM (132) at the
    flagship, trade and bench shapes; the trade's 512-wide last layer in
    four column groups of 16-row CTAs."""
    plans = mk.row_plans(n, B, widths)
    assert len(plans) == len(widths) - 1
    assert min(p.ctas for p in plans) >= 132
    if widths[-1] == 512:
        assert (plans[-1].bm, plans[-1].groups, plans[-1].ctas) == (16, 4, 256)


# The bf16 row pass (K1bf, K2bf's recompute, K11bf's stages) takes the f32
# pass's CTAs with shared memory of its own (``row_plan(..., bf16=True)``).
# Its launch allows 101,888 bytes (the 16-row, 128-column plan at n = 640);
# K11bf's plans (8 or 4 rows, one column a thread, layers up to 64 wide)
# 52,480 (csrc/fused_step.cu step_smem_most).
ROW_BF16_ALLOWANCE = 101_888
STEP_BF16_ALLOWANCE = 52_480
BF16_WIDTHS = [w for w in WIDTHS if w <= 1024]


@pytest.mark.parametrize("B", [1, 4])
def test_k1bf_row_plan_fits_the_card_at_every_n_and_width(B):
    """The bf16 row pass's plan at every n up to 640 and every width up to
    england's 1024: the f32 plan's CTA shape (bm, cc, groups: the same
    partition, so the same tests of it hold), its shared memory (a card
    test holds it to the C side's) within the launch's allowance and, with
    the static shared memory, within the card's 227 KB."""
    for n in range(1, mk.MEGAKERNEL_MAX_N + 1):
        for H in BF16_WIDTHS:
            p, f = mk.row_plan(n, B, H, bf16=True), mk.row_plan(n, B, H)
            _check_plan(p, n, B, H)
            assert (p.bm, p.cc, p.cw, p.groups, p.ctas) == (f.bm, f.cc, f.cw, f.groups, f.ctas)
            assert p.smem_bytes == mk.row_smem_bytes(n, p.bm, p.cw, H, True)
            assert p.smem_bytes <= ROW_BF16_ALLOWANCE
    for bm in mk.ROW_BMS:
        assert max(mk.row_plan(640, 1, H, (bm,), bf16=True).smem_bytes
                   for H in BF16_WIDTHS) <= ROW_BF16_ALLOWANCE
    assert mk.row_smem_bytes(640, 16, 128, 512, bf16=True) == ROW_BF16_ALLOWANCE


@pytest.mark.parametrize("n,B,widths", [(400, 4, (16, 16, 16)), (255, 4, (32, 32, 32, 32, 512)),
                                        (640, 1, (64, 64, 64)), (129, 2, (64, 64, 64, 1024)),
                                        (300, 2, (13, 37, 70))],
                         ids=["flagship", "trade", "n640", "england-n129", "odd-n300"])
@pytest.mark.parametrize("bm", [None, 16, 8, 4])
def test_k1bf_row_plan_visits_every_row_block_and_group_once(n, B, widths, bm):
    """The bf16 pass's grid (row blocks, column groups) of every layer, on
    the default plan and on each forced CTA height, covers each (row,
    output column) exactly once, and the plan array the launch takes is
    the plans' (bm, cc, groups)."""
    bms = None if bm is None else (bm,)
    plans = mk.row_plans(n, B, widths, bms, bf16=True)
    for p, H in zip(plans, widths[1:]):
        seen = np.zeros((n, H), np.int64)
        for rb in range(p.ctas // (p.groups * B)):
            for gr in range(p.groups):
                seen[rb * p.bm:(rb + 1) * p.bm, gr * p.cw:(gr + 1) * p.cw] += 1
        assert (seen == 1).all()
    layers = [dict(W=torch.zeros(ho, hi)) for hi, ho in zip(widths[:-1], widths[1:])]
    assert list(mk.plan_array(n, B, layers, bms)) == [x for p in plans
                                                      for x in (p.bm, p.cc, p.groups)]


@pytest.mark.parametrize("n,B,widths", [(400, 4, (16, 16, 16)), (400, 4, (32, 32, 32, 32)),
                                        (640, 1, (64, 64, 64)), (300, 2, (13, 13, 13))],
                         ids=["flagship", "bench", "n640", "odd-n300"])
def test_k11bf_step_plans_fit_one_instantiation(n, B, widths):
    """K11bf's stage plans: CTAs of 8 or 4 rows, one column a thread, one
    group a layer (the one instantiation of the row pass the step kernel
    builds), their shared memory the bf16 pass's and within the step
    kernel's allowance; their virtual CTAs cover each (row, column) once."""
    from gncde_tpu_torch.ops import fused_step as fs

    plans = fs.step_plans(n, B, widths, bf16=True)
    for p, H in zip(plans, widths[1:]):
        assert p.bm in fs.STEP_BMS and p.cc == 1 and p.groups == 1 and p.cw >= H
        assert p.smem_bytes == mk.row_smem_bytes(n, p.bm, p.cw, H, True)
        assert p.smem_bytes <= STEP_BF16_ALLOWANCE
    layers = [dict(W=torch.zeros(ho, hi)) for hi, ho in zip(widths[:-1], widths[1:])]
    assert fs.step_smem_bytes(n, B, layers, bf16=True) == max(p.smem_bytes for p in plans)
    for phase, p in zip(fs.step_walk(n, B, plans)[1:], plans):
        assert sorted(phase) == [(b, r, 0) for b in range(B) for r in range(-(-n // p.bm))]


# K2's f32 reverse sweep's static shared memory (csrc/bwd_sweep.cuh
# BwdShared: colS, colG, colU, the slices' sums, scratch, zn, dz, inv, the
# row dots, the rows' dvec and v, the warps' rank-term dots).
BWD_STATIC_BYTES = 4 * (3 * 128 + 3 * 256 + 8 + 2 * 16 * 64 + 16 + 16 * 3 + 16 * 2 + 8 * 14)


def _check_bwd_plan(p, n, B, H, tau, bf16=False):
    assert p.bm in (4, 8, 16) and p.cc in (1, 2, 4) and p.cw == 512 * p.cc // p.bm
    assert p.cw in (32, 64, 128)
    assert (p.groups - 1) * p.cw < H <= p.groups * p.cw  # no empty group
    assert p.ctas == -(-n // p.bm) * p.groups * B
    assert p.smem_bytes == mkb.bwd_smem_bytes(n, p.bm, p.cw, H, tau, bf16) <= mkb.BWD_SMEM_MAX
    assert mkb.BWD_SMEM_MAX + BWD_STATIC_BYTES <= SMEM_LIMIT
    assert mkb.BWD_STATIC_BYTES == BWD_STATIC_BYTES


def test_k2_sweep_plan_fits_the_card_at_every_n_and_width():
    """K2's reverse-sweep plan (``bwd_row_plan``, plain Python) for every n
    the kernels serve and widths up to MAX_OUT, with and without dtau's
    operands: a CTA shape the sweep is built for (csrc/bwd_sweep.cuh
    mk_bwd_f32 refuses any other) and shared memory within the card's 227
    KB (the largest n at every width 1 .. 4096, which bounds the rest)."""
    for tau in (False, True):
        for n in range(1, mk.MEGAKERNEL_MAX_N + 1, 3):
            for H in WIDTHS:
                _check_bwd_plan(mkb.bwd_row_plan(n, 4, H, tau), n, 4, H, tau)
        for H in range(1, mk.MAX_OUT + 1, 5):
            n = mk.MEGAKERNEL_MAX_N
            _check_bwd_plan(mkb.bwd_row_plan(n, 1, H, tau), n, 1, H, tau)


@pytest.mark.parametrize("n,B,widths", [(400, 4, (16, 16, 16)), (255, 4, (32, 32, 32, 32, 512)),
                                        (640, 1, (64, 64, 64)), (129, 2, (64, 64, 64, 1024)),
                                        (77, 3, (13, 37, 70))],
                         ids=["flagship", "trade", "n640", "england-n129", "odd-n77"])
@pytest.mark.parametrize("tau", [False, True])
def test_k2_sweep_plan_visits_every_row_block_and_group_once(n, B, widths, tau):
    """The sweep's grid (row blocks, column groups) of every layer covers
    each (row, output column) exactly once, and the layers' partial blocks
    and the several-group scratch are what the launch allocates
    (``bwd_layout``)."""
    plans = mkb.bwd_row_plans(n, B, widths, tau)
    for p, H in zip(plans, widths[1:]):
        seen = np.zeros((n, H), np.int64)
        for rb in range(-(-n // p.bm)):
            for gr in range(p.groups):
                seen[rb * p.bm:(rb + 1) * p.bm, gr * p.cw:(gr + 1) * p.cw] += 1
        assert (seen == 1).all()
    nb = 8
    layers = [dict(W=torch.zeros(ho, hi)) for hi, ho in zip(widths[:-1], widths[1:])]
    lay = mkb.bwd_layout(n, B, layers, nb, tau)
    part = sum(B * -(-n // p.bm) * (2 * hi + ho * hi + ho + 2 * nb + 1)
               for p, hi, ho in zip(plans, widths[:-1], widths[1:]))
    assert lay.part_floats == part
    assert list(lay.plans) == [x for p in plans for x in (p.bm, p.cc, p.groups)]
    assert (lay.work_floats > 0) == any(p.groups > 1 for p in plans)


@pytest.mark.parametrize("n,B,widths", [(400, 4, (16, 16, 16)), (255, 4, (32, 32, 32, 32, 512)),
                                        (640, 1, (64, 64, 64))],
                         ids=["flagship", "trade", "n640"])
@pytest.mark.parametrize("tau", [False, True])
def test_k2bf_sweep_plan_fits_and_takes_the_fewest_waves(n, B, widths, tau):
    """The bf16 sweep's plan (``bwd_row_plan(..., bf16=True)``) for every
    layer of the main paths' stacks, with and without dtau: a CTA shape the
    sweep is built for, its shared memory (``bwd_smem_bytes``, which a card
    test holds to the C side's) within ``BWD_SMEM_MAX``, its grid the rows
    and groups once, and no other CTA height taking fewer waves of resident
    CTAs; the layout sized for it."""
    plans = mkb.bwd_row_plans(n, B, widths, tau, bf16=True)
    for p, H in zip(plans, widths[1:]):
        _check_bwd_plan(p, n, B, H, tau, bf16=True)
        others = []
        for bm in (16, 8, 4):
            try:  # n=640: no 16-row CTA fits
                others.append(mkb.bwd_row_plan(n, B, H, tau, (bm,), bf16=True))
            except ValueError:
                pass
        assert mkb.bwd_waves(p) == min(mkb.bwd_waves(o) for o in others)
    layers = [dict(W=torch.zeros(ho, hi)) for hi, ho in zip(widths[:-1], widths[1:])]
    lay = mkb.bwd_layout(n, B, layers, 8, tau, bf16=True)
    assert list(lay.plans) == [x for p in plans for x in (p.bm, p.cc, p.groups)]
    assert lay.part_floats == sum(B * -(-n // p.bm) * (2 * hi + ho * hi + ho + 17)
                                  for p, hi, ho in zip(plans, widths[:-1], widths[1:]))


@pytest.mark.parametrize("n,B,widths", [(400, 4, (16, 16, 16)), (255, 4, (32, 32, 32, 32, 512))],
                         ids=["flagship", "trade"])
def test_k2_sweep_plan_fills_the_card_at_the_main_path_shapes(n, B, widths):
    """Every layer's sweep runs at least one CTA per SM (132), all in one
    wave, at the flagship and trade shapes without dtau (the main paths'
    calls), but the trade's 512-wide layer: column groups of 16-row CTAs in
    two waves (one CTA an SM, its shared memory), fewer than any other plan
    takes."""
    plans = mkb.bwd_row_plans(n, B, widths, False)
    assert min(p.ctas for p in plans) >= 132
    assert [mkb.bwd_waves(p) for p in plans[:-1]] == [1] * (len(plans) - 1)
    if widths[-1] == 512:
        assert plans[-1].bm == 16 and plans[-1].groups == 4 and mkb.bwd_waves(plans[-1]) == 2
    else:
        assert mkb.bwd_waves(plans[-1]) == 1
    for p, h in zip(plans, widths[1:]):
        others = [mkb.bwd_row_plan(n, B, h, False, (bm,)) for bm in (16, 8, 4)]
        assert mkb.bwd_waves(p) == min(mkb.bwd_waves(o) for o in others)
