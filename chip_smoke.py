"""GPU smoke test of the PyTorch/Hopper port (gncde_tpu_torch).

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each printing one line before the last:
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. build every kernel from gncde_tpu_torch/csrc (K1, K2, the tiled kernels
     K3-K6b, K7, K8/K9 and K10), one nvcc per source, all started together
     (nvcc seconds per source);
  3. K1 (forward vf kernel) against its plain PyTorch version at the
     flagship shape (n=400, B=4, widths 16 -> 16 -> 16), the bench shape
     (widths 32 x 4) and the trade shape (n=255, B=4, widths 32 -> 32 -> 32
     -> 32 -> 512: the CDE-wrapper field of configs/tgb/trade_*, whose last
     layer the kernels sweep in chunks of 64 columns), per-element planes
     and (idx, tau); max abs err <= 1e-4 * max|ref|;
  4. K2 (backward vf kernel) against the plain autograd version at the same
     shapes, with and without the tau cotangent; every cotangent within
     1e-3 * max|ref|;
  5. the main path: ``gncde_tpu_torch.run.dyn.main`` trains the flagship
     config configs/dyn/perm_equiv_gncde.yaml for 3 epochs at full width
     on the card; every train loss must be finite and both kernels must
     have launched;
  6. the tiled kernels K3 (fwd2), K4 (bwd2), K5a (dw2) and K5b (dw) against
     their plain versions at the tgbn-genre shape (n=1505, H 8 and 128,
     B=1) and one small odd shape (n=300, H=5, B=2); max abs err <= 1e-4 *
     max|ref| (the same bf16 operands and B1/B2 roundings on both sides; only
     the order of the f32 sums differs); for K3 also the time of two cuBLAS
     bf16 products on pre-formed B1, B2 as a yardstick (not one call for the
     same function);
  7. the TGB main path: ``gncde_tpu_torch.run.tgb.main`` trains
     configs/tgb/genre_perm_equiv_gncde.yaml for one epoch at full width
     (n=1505, hidden 8, 3 layers) on a tgbn-genre-scale surrogate written by
     tools/fetch_tgb.py (gravity model, seed 2, 1505 nodes, 130,000 edges
     per snapshot) cut from 133 snapshots to 40, in the config's windows of
     10 (800 constant steps each), split 2/1/1 (2 train, 1 validation, 1
     test window); every train loss and the validation NDCG@10 must be
     finite and K3 and K4 must have launched;
  8. the enc_idx kernels K7 (modulate_pair), K6a (pair) and K6b (pair_dw)
     against their plain versions at the tgbn-genre shape (n=1505, H 8 and
     128, B=1) and n=300, H=5, B=2; max abs err <= 1e-5 * max|ref| for K7
     (no reductions), <= 1e-4 for K6a/K6b (f32 sums in another order); for
     K6a also the time of two cuBLAS f32 products on pre-formed B1, B2 as a
     yardstick;
  9. the enc_idx main path: ``gncde_tpu_torch.run.tgb.main`` trains
     configs/tgb/genre_perm_equiv_enc_idx_gncde.yaml for one epoch at full
     width (n=1505, vf hidden 8, 3 layers, idx_dim 8, two modulation MLPs of
     width 8 and depth 2) on the same surrogate cut to 16 snapshots, in
     windows of 3 (5 windows: 3 train, 1 validation, 1 test); every train
     loss and the validation NDCG@10 must be finite, K7, K6a and K6b must
     have launched, and K3 and K4 must not have (enc_idx bypasses them);
 10. the sparse controls' kernels K8 (BCSR SpMM), K9 (BCSR SDDMM) and K10
     (ELL SpMM) against their plain versions at three shapes: the flagship
     (B=4, n=400, bs=128, the flagship data's own union pattern at one t,
     H=16; ELL with that data's K), the scaled point (B=1, n=32768, bs=128,
     a circular +-64 band: kb=3, H=32; ELL K=129) and an odd one (B=2,
     n=300, bs=32, H=5, per-element patterns with padded slots); max abs err
     <= 1e-4 * max|ref| (f32, summation order); beside each, one PyTorch
     library call for the same function as a yardstick (a BSR tensor @ M,
     sparse.sampled_addmm at the block pattern's CSR, a CSR tensor @ M);
 11. the main path with ``sparse_control=true sparse_format=bcsr``: first
     the flagship field at the trainer's init through the BCSR control
     against phase 5's K1 route on the same data, at three times per
     element, max abs err <= 1e-4 * max|ref| (the same function by another
     route), and the gradients of sum(f * W) with respect to the state and
     every field parameter (K9, K8 on the transposed layout against K2),
     each within 1e-3 * max|ref|; then three epochs of the flagship config at full width through
     ``gncde_tpu_torch.run.dyn``: finite losses, K8 and K9 launched, K1/K2
     not, and the first train loss within 5e-2 relative of phase 5's (a
     sanity bound: the adaptive controller puts correct routes up to 1.3%
     apart);
 12. the same with ``sparse_format=ell`` for one epoch: K10 launched, K8,
     K9, K1, K2 not;
 13. the scaled BCSR step of benchmarks/bcsr_scale.py: n=32768, a circular
     +-64 band (4.2 M edges per knot), bs=128, H=32, 3 layers, 3 knots; the
     control built from edge lists (no n x n object anywhere), Heun at dt0
     0.25 (8 evals), one warm-up and three SGD steps at lr 1e-3; finite,
     moving losses, K8 and K9 launched.
Then one JSON line of every kernel (launches on its main path, error, times
and the bound: the larger of the bytes its function must move at 3.35 TB/s
and the products that function needs at the card's peak for their operands'
type). The last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script fails before phase 1.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FLAGSHIP = "configs/dyn/perm_equiv_gncde.yaml"
SHAPES = {
    "flagship": dict(n=400, B=4, widths=(16, 16, 16)),
    "bench": dict(n=400, B=4, widths=(32, 32, 32, 32)),
    "trade": dict(n=255, B=4, widths=(32, 32, 32, 32, 512)),
}
K1_TOL = 1e-4
K2_TOL = 1e-3
TILED_TOL = 1e-4
#: tgbn-genre shapes of the tiled kernels (the config's layer widths 8, 8,
#: and the CDE wrapper's 8 * 8 * 2 = 128) and one small odd shape.
TILED_SHAPES = {"genre-H8": dict(n=1505, H=8, B=1), "genre-H128": dict(n=1505, H=128, B=1),
                "odd": dict(n=300, H=5, B=2)}
MODULATE_TOL = 1e-5
PAIR_TOL = 1e-4
#: Phase 7 cuts the surrogate to 40 snapshots in the config's windows of 10,
#: split to 2 training windows (the fewest that keeps one validation and one
#: test window), so the script stays well inside its time limit.
GENRE_SNAPSHOTS = 40
GENRE_SPLIT = ("dataset.split_ratio=[0.5,0.25,0.25]",)
GENRE_TRAIN_WINDOWS = 2
#: Phase 9 cuts it to 16 snapshots in windows of 3 (the trade configs'
#: window): 3 train, 1 validation, 1 test window.
ENC_IDX_SNAPSHOTS = 16
ENC_IDX_WINDOW = ("dataset.window_size=3", "dataset.stride=3")
ENC_IDX_TRAIN_WINDOWS = 3
SPARSE_TOL = 1e-4
#: The flagship field through a sparse control against phase 5's K1 route,
#: on the flagship data at the trainer's init (relative to max|ref|), and
#: its gradients against K2's (as K2 against its plain version).
SPARSE_VF_TOL = 1e-4
SPARSE_GRAD_TOL = 1e-3
#: First train loss of the sparse main paths against phase 5's (relative). A
#: sanity bound, not the precise check (SPARSE_VF_TOL is): routes whose fields
#: agree to 1e-15 in float64 give first losses 0.93% apart in float64 on the
#: CPU, and the card's K1 and BCSR routes 1.3% apart in float32, because the
#: adaptive controller's reject storms at the graph events amplify rounding.
SPARSE_LOSS_RTOL = 5e-2
#: Epochs of phases 11 and 12 (the flagship's main path through K8/K9, K10).
BCSR_EPOCHS = 3
ELL_EPOCHS = 1
#: benchmarks/bcsr_scale.py's point.
SCALED = dict(n=32768, bw=64, bs=128, H=32, L=3, T=3)
# Published H100 SXM peaks (NVIDIA data sheet) for the bounds.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound(nbytes, *ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations, given as (count, peak) pairs, each over the peak
    for its type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, sum(f / peak for f, peak in ops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; refusing to run")
    return torch


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": 1, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})
    return smi


def phase_build():
    from gncde_tpu_torch.ops import _build

    t0 = time.perf_counter()
    names = _build.sources()
    _build.build(names)
    emit({"phase": 2, "sources": names, "build_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.BUILD_SECONDS)})


def make_inputs(torch, n, B, widths, seed=0, T=8):
    """Per-element planes and (idx, tau), node state and layer params of
    the given widths (input, then each layer's output)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    planes = tuple(t(rng.uniform(-0.05, 0.1, (B, T - 1, n, n))) for _ in range(4))
    idx = torch.tensor(rng.permutation(T - 1)[:B], device=dev)
    tau = t(rng.uniform(0.0, 0.2, B))
    Z = t(rng.normal(size=(B, n, widths[0])))
    layers = []
    for hin, hout in zip(widths[:-1], widths[1:]):
        lim = 1.0 / np.sqrt(hin)
        layers.append(dict(
            norm_w=t(1.0 + 0.1 * rng.normal(size=hin)),
            norm_b=t(0.1 * rng.normal(size=hin)),
            W=t(rng.uniform(-lim, lim, (hout, hin))),
            lin_b=t(rng.uniform(-lim, lim, hout)),
            basis=t(rng.uniform(-1 / 15, 1 / 15, (8, 2))),
        ))
    G = t(rng.normal(size=(B, n, widths[-1])))
    return planes, idx, tau, Z, layers, G


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(torch, got, ref):
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0), scale


def phase_k1(torch, results):
    from gncde_tpu_torch.ops import megakernel as mk

    for label, s in SHAPES.items():
        planes, idx, tau, Z, layers, _ = make_inputs(torch, **s)
        got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers)
        ref = mk.plain_vf_eval(planes, idx, tau, Z, layers)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"K1 {label}: bad output {tuple(got.shape)}")
        err, scale = rel_err(torch, got, ref)
        abs_err = float((got - ref).abs().max())
        ms = time_ms(torch, lambda: mk.megakernel_vf_eval(planes, idx, tau, Z, layers))
        plain_ms = time_ms(torch, lambda: mk.plain_vf_eval(planes, idx, tau, Z, layers))
        emit({"phase": 3, "kernel": "K1", "shape": label, **s,
              "max_abs_err": abs_err, "max_abs_ref": scale, "rel_err": err,
              "ms": ms, "plain_ms": plain_ms})
        if not err <= K1_TOL:
            raise RuntimeError(f"K1 {label}: rel err {err:.3e} > {K1_TOL}")
        results.setdefault("K1", []).append((label, abs_err, ms, plain_ms))


def phase_k2(torch, results):
    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    for label, s in SHAPES.items():
        planes, idx, tau, Z, layers, G = make_inputs(torch, **s)
        for need_tau in (False, True):
            got = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)
            ref = mkb.plain_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)
            torch.cuda.synchronize()
            pairs = [("dZ", got[1], ref[1])]
            if need_tau:
                pairs.append(("dtau", got[0], ref[0]))
            for l, (gl, rl) in enumerate(zip(got[2], ref[2])):
                for name, a, b in zip(("dnorm_w", "dnorm_b", "dW", "dlin_b",
                                       "dbasis"), gl, rl):
                    pairs.append((f"{name}{l}", a, b))
            errs, worst_abs = {}, 0.0
            for name, a, b in pairs:
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise RuntimeError(f"K2 {label} {name}: bad output")
                errs[name], _ = rel_err(torch, a, b)
                worst_abs = max(worst_abs, float((a - b).abs().max()))
            worst = max(errs.values())
            ms = time_ms(torch, lambda: mkb.megakernel_vf_bwd(
                planes, idx, tau, Z, layers, G, need_tau))
            plain_ms = time_ms(torch, lambda: mkb.plain_vf_bwd(
                planes, idx, tau, Z, layers, G, need_tau))
            emit({"phase": 4, "kernel": "K2", "shape": label, **s,
                  "need_tau": need_tau, "max_rel_err": worst,
                  "max_abs_err": worst_abs, "rel_errs": errs,
                  "ms": ms, "plain_ms": plain_ms})
            if not worst <= K2_TOL:
                bad = {k: v for k, v in errs.items() if v > K2_TOL}
                raise RuntimeError(f"K2 {label} need_tau={need_tau}: {bad}")
            results.setdefault("K2", []).append((label, worst_abs, ms, plain_ms))


def phase_train(torch, cache):
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import megakernel_bwd as mkb
    from gncde_tpu_torch.run import dyn

    with tempfile.TemporaryDirectory() as tmp:
        mk.megakernel_vf_eval.launches = 0
        mkb.megakernel_vf_bwd.launches = 0
        t0 = time.perf_counter()
        res = dyn.main([
            "--config", FLAGSHIP,
            "epochs=3", "eval_freq=1", "log_freq=1", "min_epochs=0",
            f"dataset.cache_dir={cache}", f"checkpoint_dir={tmp}/ckpt/",
            "device=cuda", "wandb.mode=disabled",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = mk.megakernel_vf_eval.launches, mkb.megakernel_vf_bwd.launches
    losses = res["train_losses"]
    emit({"phase": 5, "train_losses": losses,
          "train_step_s": res["train_step_s"], "solver_steps": res["solver_steps"],
          "device": res["device"], "k1_launches": k1, "k2_launches": k2,
          "best_validation_loss": res["validation_loss"], "wall_s": wall})
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite or missing train losses: {losses}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"main path ran on {res['device']}, not cuda")
    if k1 <= 0 or k2 <= 0:
        raise RuntimeError(f"kernels not launched on the main path: K1 {k1}, K2 {k2}")
    return {"K1": k1, "K2": k2}, losses


def make_tiled_inputs(torch, n, H, B, seed=0):
    """bf16 planes (B, n, n), bf16 vectors (B, n, H), four f32 slabs
    (B, n, n) and the coefficient vector, from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def bf16(x):
        return torch.tensor(x.astype(np.float32), device=dev).to(torch.bfloat16)

    A = bf16(rng.uniform(0.0, 1.0, (B, n, n)))
    dA = bf16(rng.normal(0.0, 1.0, (B, n, n)))
    M, G = bf16(rng.normal(size=(B, n, H))), bf16(rng.normal(size=(B, n, H)))
    slabs = tuple(torch.tensor(rng.normal(0.0, 0.1, (B, n, n)).astype(np.float32), device=dev)
                  for _ in range(4))
    cvec = torch.tensor([1.03, 0.071, -0.044, 0.052], device=dev)
    return A, dA, M, G, slabs, cvec


def tiled_bound(name, n, H, B):
    """(bound_ms, bound_by) of one tiled kernel call: each input read once,
    each output written once, and the products the function needs (not the
    kernel's own algorithm) at the peak for their operands' type: bf16
    matrix products on bf16 operands, f32 inner products with f32 planes."""
    nn, nh = n * n * B, n * H * B  # plane and vector elements
    if name == "K3":  # bf16 A, dA, M -> f32 rowpart, colpart: B1 M and B2^T M
        return bound(2 * 2 * nn + 2 * nh + 2 * 4 * nh + 16, (4 * nn * H, BF16_FLOPS))
    if name == "K4":  # bf16 A, dA, G, M -> f32 dM parts and dw4: (c_col.(A, dA)) g,
        # (c_row.(A, dA))^T g and P = G M^T, then <A|dA, P>, <A|dA, P^T>
        return bound(2 * 2 * nn + 2 * 2 * nh + 2 * 4 * nh + 16 + 4 * 4 * B,
                     (6 * nn * H, BF16_FLOPS), (8 * nn, F32_FLOPS))
    if name == "K5a":  # bf16 A, dA, G, M -> dw4: P = G M^T, four inner products
        return bound(2 * 2 * nn + 2 * 2 * nh + 4 * 4 * B,
                     (2 * nn * H, BF16_FLOPS), (8 * nn, F32_FLOPS))
    # K5b: four f32 slabs, bf16 G, M -> dw8: P = G M^T, eight inner products
    return bound(4 * 4 * nn + 2 * 2 * nh + 8 * 4 * B,
                 (2 * nn * H, BF16_FLOPS), (16 * nn, F32_FLOPS))


def phase_tiled(torch, results):
    from gncde_tpu_torch.ops import tiled as tt

    for label, s in TILED_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        A, dA, M, G, slabs, cvec = make_tiled_inputs(torch, n, H, B)
        calls = {
            "K3": (lambda: tt.fwd2_call(A, dA, cvec, M),
                   lambda: tt.plain_fwd2(A, dA, cvec, M)),
            "K4": (lambda: tt.bwd2_call(A, dA, cvec, G, M),
                   lambda: tt.plain_bwd2(A, dA, cvec, G, M)),
            "K5a": (lambda: (tt.dw2_call(A, dA, G, M),),
                    lambda: (tt.plain_dw2(A, dA, G, M),)),
            "K5b": (lambda: (tt.dw_call(slabs, G, M),),
                    lambda: (tt.plain_dw(slabs, G, M),)),
        }
        for name, (kernel, plain) in calls.items():
            got, ref, again = kernel(), plain(), kernel()
            torch.cuda.synchronize()
            errs, worst_abs = [], 0.0
            for a, b, c in zip(got, ref, again):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise RuntimeError(f"{name} {label}: bad output {tuple(a.shape)}")
                if not torch.equal(a, c):
                    raise RuntimeError(f"{name} {label}: two launches differ")
                err, _ = rel_err(torch, a, b)
                errs.append(err)
                worst_abs = max(worst_abs, float((a - b).abs().max()))
            ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
            bms, by = tiled_bound(name, n, H, B)
            line = {"phase": 6, "kernel": name, "shape": label, **s,
                    "max_abs_err": worst_abs, "max_rel_err": max(errs), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
            if name == "K3":
                c = cvec.to(torch.bfloat16)
                B1 = c[0] * A + c[1] * dA
                B2t = (c[2] * A + c[3] * dA).transpose(-2, -1)
                line["yardstick_two_cublas_bf16_products_ms"] = time_ms(
                    torch, lambda: (torch.matmul(B1, M), torch.matmul(B2t, M)))
            emit(line)
            if not max(errs) <= TILED_TOL:
                raise RuntimeError(f"{name} {label}: rel err {max(errs):.3e} > {TILED_TOL}")
            results.setdefault(name, {})[label] = (worst_abs, ms, plain_ms, bms, by)


def write_genre_surrogate(out: Path, snapshots: int) -> None:
    """tools/fetch_tgb.py's tgbn-genre surrogate cut to ``snapshots``
    snapshots (the tool is numpy-only, loaded by path). Seed 2's first 16
    snapshots, and so every longer cut, touch all 1505 nodes, the config's
    n (seed 0's pair pool misses a node). The generator is sequential, so a
    cut keeps the first snapshots."""
    tool = Path(__file__).resolve().parent / "tools" / "fetch_tgb.py"
    spec = importlib.util.spec_from_file_location("fetch_tgb", tool)
    fetch_tgb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fetch_tgb)
    fetch_tgb.SCALES["tgbn-genre"]["num_years"] = snapshots
    fetch_tgb.synthetic("tgbn-genre", out, seed=2)


def counters():
    from gncde_tpu_torch.ops import (bcsr, ell_spmm, megakernel, megakernel_bwd, modulate,
                                     pair, tiled)

    return {"K1": megakernel.megakernel_vf_eval, "K2": megakernel_bwd.megakernel_vf_bwd,
            "K3": tiled.fwd2_call, "K4": tiled.bwd2_call, "K5a": tiled.dw2_call,
            "K5b": tiled.dw_call, "K6a": pair.pair_call, "K6b": pair.pair_dw_call,
            "K7": modulate.modulate_pair, "K8": bcsr.bcsr_spmm, "K9": bcsr.bcsr_sddmm,
            "K10": ell_spmm.ell_spmm_call}


def run_tgb(torch, phase, config, snapshots, train_windows, extra=()):
    """One epoch of a TGB config on the genre surrogate through the CLI's
    entry point; returns its result and the launch counts of that run."""
    from gncde_tpu_torch.run import tgb

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_genre_surrogate(Path(tmp) / "data", snapshots)
        data_s = time.perf_counter() - t0
        for f in counters().values():
            f.launches = 0
        t0 = time.perf_counter()
        res = tgb.main([
            "--config", config,
            "dataset.name=tgbn-genre-synth", "dataset.frequency=None",
            f"dataset.data_dir={tmp}/data", f"dataset.cache_dir={tmp}/cache",
            f"checkpoint_dir={tmp}/ckpt/", "epochs=1", "eval_freq=1", "min_epochs=0",
            "device=cuda", "wandb.mode=disabled", *extra,
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters().items()}
    losses = res["train_losses"]
    ndcg = res["validation_metrics"].get("validation_ndcg@10", float("nan"))
    emit({"phase": phase, "config": config, "train_losses": losses,
          "train_step_s": res["train_step_s"],
          "validation_metrics": res["validation_metrics"],
          "best_epoch": res["best_epoch"], "device": res["device"],
          "launches": launches, "surrogate_write_s": data_s, "wall_s": wall})
    if len(losses) != train_windows or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"phase {phase}: non-finite or missing train losses: {losses}")
    if not math.isfinite(ndcg):
        raise RuntimeError(f"phase {phase}: validation NDCG@10 is not finite: {ndcg}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"phase {phase}: ran on {res['device']}, not cuda")
    return launches


def phase_tgb(torch):
    launches = run_tgb(torch, 7, "configs/tgb/genre_perm_equiv_gncde.yaml", GENRE_SNAPSHOTS,
                       GENRE_TRAIN_WINDOWS, GENRE_SPLIT)
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise RuntimeError(f"tiled kernels not launched on the TGB path: {launches}")
    return launches


def phase_enc_idx(torch):
    launches = run_tgb(torch, 9, "configs/tgb/genre_perm_equiv_enc_idx_gncde.yaml",
                       ENC_IDX_SNAPSHOTS, ENC_IDX_TRAIN_WINDOWS, ENC_IDX_WINDOW)
    if min(launches["K7"], launches["K6a"], launches["K6b"]) <= 0:
        raise RuntimeError(f"enc_idx kernels not launched on the enc_idx path: {launches}")
    if launches["K3"] or launches["K4"]:
        raise RuntimeError(f"the enc_idx path launched the Hermite tiled kernels: {launches}")
    return launches


def make_pair_inputs(torch, n, H, B, seed=0):
    """f32 planes (B, n, n), f32 vectors (B, n, H), the coefficient vector,
    a node embedding (n, 8) and the two modulation MLPs of the enc_idx
    config (width 8, depth 2), from ``seed``."""
    import numpy as np

    from gncde_tpu_torch.nn import MLP

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def f(*shape, loc=0.0, scale=1.0):
        return torch.tensor(rng.normal(loc, scale, shape).astype(np.float32), device=dev)

    gen = torch.Generator().manual_seed(seed)
    mlps = [MLP(17, 1, 8, 2, generator=gen).to(dev) for _ in range(2)]
    return dict(A=f(B, n, n, loc=0.1, scale=0.3), dA=f(B, n, n, scale=0.5),
                Mk=f(B, n, H), Mi=f(B, n, H), Gr=f(B, n, H), Gc=f(B, n, H),
                cvec=torch.tensor([1.03, 0.071, -0.044, 0.052], device=dev),
                emb=f(n, 8), mlps=mlps)


def pair_bound(name, n, H, B, w=8, depth=2):
    """(bound_ms, bound_by) of one enc_idx kernel call: each input read once,
    each output written once (f32), and the f32 operations the function
    needs at 67 TFLOP/s."""
    nn, nh = n * n * B, n * H * B
    if name == "K6a":  # A, dA, Mk, Mi -> rowpart, colpart: form B1, B2, two products
        return bound(2 * 4 * nn + 2 * 4 * nh + 2 * 4 * nh + 16,
                     (6 * nn + 4 * nn * H, F32_FLOPS))
    if name == "K6b":  # A, dA, Gr, Mk, Mi, Gc -> dw4: Gr Mk^T, Mi Gc^T, four inner products
        return bound(2 * 4 * nn + 4 * 4 * nh + 4 * 4 * B,
                     (4 * nn * H + 8 * nn, F32_FLOPS))
    # K7: A, dA -> A_m, dA_m; per element and plane: first layer 4w (mul, two
    # adds, relu), (depth-1) hidden layers 2w^2 + w, head 2w.
    per = 4 * w + (depth - 1) * (2 * w * w + w) + 2 * w
    return bound(4 * 4 * nn + 2 * 2 * 4 * n * w, (2 * per * nn, F32_FLOPS))


def phase_pair(torch, results):
    from gncde_tpu_torch.ops import modulate as tmod
    from gncde_tpu_torch.ops import pair as tp

    for label, s in TILED_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        x = make_pair_inputs(torch, n, H, B)
        ma, md = x["mlps"]
        pair_args = (x["A"], x["dA"], x["cvec"], x["Mk"], x["Mi"])
        dw_args = tuple(x[k] for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
        calls = {
            "K6a": (lambda: tp.pair_call(*pair_args), lambda: tp.plain_pair(*pair_args),
                    PAIR_TOL),
            "K6b": (lambda: (tp.pair_dw_call(*dw_args),),
                    lambda: (tp.plain_pair_dw(*dw_args),), PAIR_TOL),
        }
        if label != "genre-H8":  # K7 does not depend on H
            calls["K7"] = (
                lambda: tmod.modulate_pair(x["A"], x["dA"], ma, md, x["emb"]),
                lambda: tmod.plain_modulate_pair(x["A"], x["dA"], ma, md, x["emb"]),
                MODULATE_TOL)
        for name, (kernel, plain, tol) in calls.items():
            with torch.no_grad():
                got, ref, again = kernel(), plain(), kernel()
                torch.cuda.synchronize()
                errs, worst_abs = [], 0.0
                for a, b, c in zip(got, ref, again):
                    if a.shape != b.shape or not torch.isfinite(a).all():
                        raise RuntimeError(f"{name} {label}: bad output {tuple(a.shape)}")
                    if not torch.equal(a, c):
                        raise RuntimeError(f"{name} {label}: two launches differ")
                    err, _ = rel_err(torch, a, b)
                    errs.append(err)
                    worst_abs = max(worst_abs, float((a - b).abs().max()))
                ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
            bms, by = pair_bound(name, n, H, B)
            line = {"phase": 8, "kernel": name, "shape": label, **s,
                    "max_abs_err": worst_abs, "max_rel_err": max(errs), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
            extra = {}
            if name == "K6a":
                c = x["cvec"]
                B1 = c[0] * x["A"] + c[1] * x["dA"]
                B2t = (c[2] * x["A"] + c[3] * x["dA"]).transpose(-2, -1)
                extra["yardstick_two_cublas_f32_products_ms"] = time_ms(
                    torch, lambda: (torch.matmul(B1, x["Mk"]), torch.matmul(B2t, x["Mi"])))
            if name == "K7":
                # The wrapper's input preparation is a dozen small torch ops;
                # the launch alone on prepared inputs, for comparison.
                inputs = tmod.kernel_inputs(ma, md, x["emb"])
                extra["launch_only_ms"] = time_ms(
                    torch, lambda: tmod.launch(x["A"], x["dA"], *inputs))
            emit({**line, **extra})
            if not max(errs) <= tol:
                raise RuntimeError(f"{name} {label}: rel err {max(errs):.3e} > {tol}")
            results.setdefault(name, {})[label] = (worst_abs, ms, plain_ms, bms, by, extra)


def flagship_setup(cache):
    """The flagship config's trainer (for its model and seed) and its
    training dict, from the data cache phase 5 wrote."""
    from gncde_tpu_torch.run import common
    from gncde_tpu_torch.train.trainer import Trainer

    with open(FLAGSHIP) as f:
        cfg = common.apply_overrides(common.safe_load(f.read()),
                                     [f"dataset.cache_dir={cache}"])
    tr = Trainer.from_dict(cfg)
    return tr, tr.dataset.get_training_data()


def flagship_sparse_inputs(torch, cache, H=16, seed=0):
    """The flagship data's own sparse controls at one t per element (train
    dict, bs 128): a BCSR A(t) (its union pattern gives kb) and an ELL A(t)
    (its K), node features M and a cotangent X of width H."""
    import numpy as np

    from gncde_tpu_torch.interp import build_sparse_control

    _, d = flagship_setup(cache)
    ts, coeffs = d["train_t"], d["train_graph_path_coeffs"]
    t = ts[:, ts.shape[1] // 3] + 0.01
    dev = torch.device("cuda")
    b = build_sparse_control("cubic", ts, coeffs, "bcsr", block_size=128).to(dev)
    e = build_sparse_control("cubic", ts, coeffs, "ell").to(dev)
    val, ell = b.adj(t.to(dev)), e.adj(t.to(dev))
    B, n = ts.shape[0], val.layout.n
    rng = np.random.default_rng(seed)
    M, X = (torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=dev)
            for _ in range(2))
    return dict(idx=val.layout.block_idx, blocks=val.blocks, nblocks=val.layout.nblocks,
                indices=ell.indices, values=ell.values, M=M, X=X, n=n, bs=128, H=H, B=B)


def scaled_sparse_inputs(torch, n, bw, bs, H, seed=0):
    """The scaled point: a circular +-bw band at bs (BCSR from the edge
    list, no n x n object) and the same band as an ELL (K = 2 bw + 1)."""
    import numpy as np

    from gncde_tpu_torch.ops import bcsr as tb

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    i = np.repeat(np.arange(n), 2 * bw + 1)
    dst = (i + np.tile(np.arange(-bw, bw + 1), n)) % n
    w = (0.1 * rng.random(i.size)).astype(np.float32)
    m = tb.bcsr_from_edges(i, dst, w, n, bs)
    M, X = (torch.tensor(rng.normal(size=(1, n, H)).astype(np.float32), device=dev)
            for _ in range(2))
    return dict(idx=m.block_idx.to(dev), blocks=m.blocks.to(dev), nblocks=m.nblocks.to(dev),
                indices=torch.tensor(dst.reshape(n, -1).astype(np.int32), device=dev),
                values=torch.tensor(w.reshape(n, -1), device=dev), M=M, X=X, n=n, bs=bs,
                H=H, B=1)


def odd_sparse_inputs(torch, n=300, bs=32, H=5, B=2, K=7, seed=0):
    """Per-element block patterns (bands of different widths and one far
    entry each) widened to one slot count, so padded slots exist; an ELL
    with distinct columns per row and padding (index n) in every row."""
    import numpy as np

    from gncde_tpu_torch.ops import bcsr as tb

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    i, j = np.indices((n, n))
    dense = []
    for b in range(B):
        A = np.where(np.abs(i - j) <= 4 + 20 * b, rng.normal(size=(n, n)), 0.0)
        A[b, n - 1 - b] = 0.5
        dense.append(A.astype(np.float32))
    kb = max(tb.bcsr_from_dense(A, bs).kb for A in dense)
    mats = [tb.bcsr_from_dense(A, bs, kb) for A in dense]
    idx = np.stack([np.sort(np.concatenate([rng.choice(n, K - 2, replace=False),
                                            [n, n]])) for _ in range(B * n)])
    M, X = (torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=dev)
            for _ in range(2))
    return dict(idx=torch.stack([m.block_idx for m in mats]).to(dev),
                blocks=torch.stack([m.blocks for m in mats]).to(dev),
                nblocks=torch.stack([m.nblocks for m in mats]).to(dev),
                indices=torch.tensor(idx.reshape(B, n, K).astype(np.int32), device=dev),
                values=torch.tensor(rng.normal(size=(B, n, K)).astype(np.float32),
                                    device=dev), M=M, X=X, n=n, bs=bs, H=H, B=B)


def _batched(x, core):
    return x if x.dim() == core + 1 else x.unsqueeze(0)


def sparse_library_calls(torch, x):
    """One PyTorch call per kernel for the same function, as yardsticks:
    a BSR tensor @ M (K8), ``sparse.sampled_addmm`` at the stored blocks'
    element CSR (K9), a CSR tensor @ M (K10); the batch as one
    block-diagonal matrix, padded slots and padding entries left out."""
    n, bs, H = x["n"], x["bs"], x["H"]
    idx, blocks, nblocks = _batched(x["idx"], 2), _batched(x["blocks"], 4), _batched(
        x["nblocks"], 1)
    B, nb, kb = idx.shape
    if blocks.shape[0] != B:
        blocks = blocks.expand(B, *blocks.shape[1:])
    N = B * nb * bs
    dev = idx.device
    valid = torch.arange(kb, device=dev) < nblocks.unsqueeze(-1)  # (B, nb, kb)
    cols = (idx.long() + nb * torch.arange(B, device=dev)[:, None, None])[valid]
    crow = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      valid.sum(-1).reshape(-1).cumsum(0)])
    vals = blocks[valid].contiguous()
    Mp = torch.zeros((B, nb * bs, H), device=dev)
    Mp[:, :n] = x["M"]
    Xp = torch.zeros((B, nb * bs, H), device=dev)
    Xp[:, :n] = x["X"]
    Mf, Xf = Mp.reshape(N, H), Xp.reshape(N, H)
    calls = {}
    A_bsr = torch.sparse_bsr_tensor(crow, cols, vals, size=(N, N))
    calls["K8"] = lambda: A_bsr @ Mf
    # K9: every element of a stored block, rows of a block row sharing their
    # column list (sorted: block columns ascend within a block row).
    per_row = valid.sum(-1).reshape(-1) * bs  # entries in each row of a block row
    row_nnz = per_row.repeat_interleave(bs)
    crow9 = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), row_nnz.cumsum(0)])
    blk_cols = (cols[:, None] * bs + torch.arange(bs, device=dev)).reshape(-1)
    starts = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        (per_row).cumsum(0)[:-1]])
    pieces = [blk_cols[s:s + c] for s, c in zip(starts.tolist(), per_row.tolist())]
    col9 = torch.cat([p.repeat(bs) for p in pieces])
    S = torch.sparse_csr_tensor(crow9, col9, torch.zeros(col9.numel(), device=dev),
                                size=(N, N))
    YT = Mf.t().contiguous()
    calls["K9"] = lambda: torch.sparse.sampled_addmm(S, Xf, YT, beta=0.0)
    ind, val = _batched(x["indices"], 2), _batched(x["values"], 2)
    ind = ind.expand(val.shape[0], *ind.shape[1:]).long()
    order = ind.argsort(-1)
    ind, val = ind.gather(-1, order), val.gather(-1, order)
    ok = ind < n
    Bv = ind.shape[0]
    c10 = (ind + n * torch.arange(Bv, device=dev)[:, None, None])[ok]
    crow10 = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        ok.sum(-1).reshape(-1).cumsum(0)])
    A_csr = torch.sparse_csr_tensor(crow10, c10, val[ok].contiguous(), size=(Bv * n, Bv * n))
    Mc = _batched(x["M"], 2).expand(Bv, n, H).reshape(Bv * n, H).contiguous()
    calls["K10"] = lambda: A_csr @ Mc
    return calls


def sparse_bound(name, x):
    """(bound_ms, bound_by) of one call: each input read once, each output
    written once (f32, int32 indices), and the f32 operations this data
    needs (valid slots only; ELL entries whose index is not padding)."""
    n, bs, H = x["n"], x["bs"], x["H"]
    B = x["B"]
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    nh = B * n * H * 4
    if name in ("K8", "K9"):
        from gncde_tpu_torch.ops.bcsr import slot_mask

        kb = x["idx"].shape[-1]
        vs = int(slot_mask(x["idx"], x["nblocks"]).sum()) * (B if x["nblocks"].dim() == 1
                                                             else 1)
        flops = 2 * vs * bs * bs * H
        if name == "K8":
            return bound(nbytes(x["idx"]) + nbytes(x["blocks"]) + 2 * nh, (flops, F32_FLOPS))
        out = B * x["idx"].shape[-2] * kb * bs * bs * 4
        return bound(nbytes(x["idx"]) + 2 * nh + out, (flops, F32_FLOPS))
    nnz = int((x["indices"] < n).sum())
    if x["indices"].dim() == 2:
        nnz *= B
    return bound(nbytes(x["indices"]) + nbytes(x["values"]) + 2 * nh,
                 (2 * nnz * H, F32_FLOPS))


def phase_sparse_kernels(torch, cache, results):
    from gncde_tpu_torch.ops import bcsr as tb
    from gncde_tpu_torch.ops import ell_spmm as tell

    s = SCALED
    cases = {"flagship": lambda: flagship_sparse_inputs(torch, cache),
             "scaled": lambda: scaled_sparse_inputs(torch, s["n"], s["bw"], s["bs"], s["H"]),
             "odd": lambda: odd_sparse_inputs(torch)}
    for label, make in cases.items():
        t0 = time.perf_counter()
        x = make()
        setup_s = time.perf_counter() - t0
        mat = tb.BCSR(x["idx"], x["blocks"], x["n"])
        calls = {
            "K8": (lambda: tb.bcsr_spmm(mat, x["M"]), lambda: tb.bcsr_spmm_plain(mat, x["M"])),
            "K9": (lambda: tb.bcsr_sddmm(x["idx"], x["X"], x["M"], x["bs"]),
                   lambda: tb.bcsr_sddmm_plain(x["idx"], x["X"], x["M"], x["bs"])),
            "K10": (lambda: tell.ell_spmm_call(x["indices"], x["values"], x["M"]),
                    lambda: tell.plain_ell_spmm(x["indices"], x["values"], x["M"])),
        }
        try:
            lib, lib_err = sparse_library_calls(torch, x), None
        except Exception as exc:  # the yardstick only; the kernels are held below
            lib, lib_err = {}, f"{type(exc).__name__}: {exc}"
        for name, (kernel, plain) in calls.items():
            with torch.no_grad():
                got, ref, again = kernel(), plain(), kernel()
                torch.cuda.synchronize()
                if got.shape != ref.shape or not torch.isfinite(got).all():
                    raise RuntimeError(f"{name} {label}: bad output {tuple(got.shape)}")
                if not torch.equal(got, again):
                    raise RuntimeError(f"{name} {label}: two launches differ")
                err, scale = rel_err(torch, got, ref)
                abs_err = float((got - ref).abs().max())
                ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
                library_ms, err_text = None, lib_err
                if name in lib:
                    try:
                        library_ms = time_ms(torch, lib[name])
                    except Exception as exc:
                        err_text = f"{type(exc).__name__}: {exc}"
            bms, by = sparse_bound(name, x)
            shape = {k: x[k] for k in ("n", "bs", "H", "B")}
            shape.update(kb=x["idx"].shape[-1], K=x["indices"].shape[-1])
            emit({"phase": 10, "kernel": name, "shape": label, **shape, "setup_s": setup_s,
                  "max_abs_err": abs_err, "max_abs_ref": scale, "rel_err": err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "library_ms": library_ms, "library_error": err_text})
            if not err <= SPARSE_TOL:
                raise RuntimeError(f"{name} {label}: rel err {err:.3e} > {SPARSE_TOL}")
            results.setdefault(name, {})[label] = (abs_err, ms, plain_ms, bms, by, library_ms,
                                                   shape)
        del x, mat, calls, lib
        torch.cuda.empty_cache()


def route_errors(torch, vf, y, ts, ref_ctrl, ctrl, seed=0):
    """The field ``vf`` through ``ctrl`` against ``ref_ctrl``: the max abs
    err over max|ref| of ``f(t, y)`` at three times per element of ``ts``,
    and a dict of the same for the gradients of ``sum(f * W)`` (W normal
    from ``seed``) with respect to y and every parameter of ``vf``."""

    def run(ctrl_):
        vf.zero_grad(set_to_none=True)
        y_ = y.detach().clone().requires_grad_(True)
        gen = torch.Generator().manual_seed(seed)
        outs, loss = [], 0.0
        for k in (0.17, 0.5, 0.83):
            out = vf(ts[:, 0] + k * (ts[:, -1] - ts[:, 0]), y_, ctrl_)
            loss = loss + (out * torch.randn(out.shape, generator=gen).to(out.device)).sum()
            outs.append(out.detach())
        loss.backward()
        grads = {"y": y_.grad, **{k: p.grad for k, p in vf.named_parameters()}}
        return torch.stack(outs), grads

    ref, ref_grads = run(ref_ctrl)
    got, got_grads = run(ctrl)
    grad_errs = {}
    for k, g_ref in ref_grads.items():
        g = got_grads[k]
        if g is None or g_ref is None:
            if g is not g_ref:
                raise RuntimeError(f"gradient of {k}: one route gives none")
            continue
        grad_errs[k] = rel_err(torch, g, g_ref)[0]
    return rel_err(torch, got, ref)[0], grad_errs


def sparse_route_error(torch, cache, fmt):
    """:func:`route_errors` of the flagship field at the trainer's init
    through the ``fmt`` sparse control (K8/K9 or K10) against the same field
    through phase 5's slim control (K1/K2), at y = the initial linear map of
    the data's y0 and three times per element of the training dict."""
    from gncde_tpu_torch.interp import build_sparse_control
    from gncde_tpu_torch.models.continuous import make_control

    tr, d = flagship_setup(cache)
    dev = torch.device("cuda")
    model = tr.model.build(torch.Generator().manual_seed(tr.seed)).to(dev)
    ts, coeffs = d["train_t"], d["train_graph_path_coeffs"]
    dense = make_control(tr.model.interpolation, ts.to(dev), tuple(c.to(dev) for c in coeffs))
    sparse = build_sparse_control(tr.model.interpolation, ts, coeffs, fmt,
                                  block_size=128).to(dev)
    with torch.no_grad():
        y = model.initial_linear(d["true_y0"].to(dev))
    for f in counters().values():
        f.launches = 0
    errs = route_errors(torch, model.vector_field, y, ts.to(dev), dense, sparse)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters().items()}
    want = ("K1", "K2") + (("K8", "K9") if fmt == "bcsr" else ("K10",))
    if min(launches[k] for k in want) <= 0:
        raise RuntimeError(f"route check through {fmt}: launches {launches}; want {want} > 0")
    del dense, sparse, model
    torch.cuda.empty_cache()
    return errs


def phase_sparse_train(torch, phase, fmt, epochs, cache, first_loss_ref):
    """``epochs`` of the flagship config through the dyn CLI with
    ``sparse_control=true sparse_format=fmt``, after the field check of
    :func:`sparse_route_error`; returns the launch counts of the run."""
    from gncde_tpu_torch.run import dyn

    vf_err, grad_errs = sparse_route_error(torch, cache, fmt)
    with tempfile.TemporaryDirectory() as tmp:
        for f in counters().values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = dyn.main([
            "--config", FLAGSHIP, f"epochs={epochs}", "eval_freq=1", "log_freq=1",
            "min_epochs=0", f"dataset.cache_dir={cache}", f"checkpoint_dir={tmp}/ckpt/",
            "device=cuda", "wandb.mode=disabled", "sparse_control=true",
            f"sparse_format={fmt}", "sparse_block_size=128",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters().items()}
    losses = res["train_losses"]
    rel = abs(losses[0] - first_loss_ref) / abs(first_loss_ref) if losses else float("nan")
    attempts = [a + r for a, r in zip(res["solver_steps"].get("num_accepted_steps", []),
                                      res["solver_steps"].get("num_rejected_steps", []))]
    emit({"phase": phase, "sparse_format": fmt, "vf_rel_err_vs_k1_route": vf_err,
          "grad_rel_errs_vs_k2_route": grad_errs, "train_losses": losses,
          "first_loss_phase5": first_loss_ref, "first_loss_rel_diff": rel,
          "train_step_s": res["train_step_s"], "solver_steps": res["solver_steps"],
          "solver_attempts_last_step": attempts, "control_bytes": res["control_bytes"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "best_validation_loss": res["validation_loss"], "device": res["device"],
          "launches": launches, "wall_s": wall})
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"phase {phase}: non-finite or missing train losses: {losses}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"phase {phase}: ran on {res['device']}, not cuda")
    if not vf_err <= SPARSE_VF_TOL:
        raise RuntimeError(f"phase {phase}: the field through the {fmt} control is "
                           f"{vf_err:.3e} off phase 5's K1 route (> {SPARSE_VF_TOL})")
    bad = {k: v for k, v in grad_errs.items() if not v <= SPARSE_GRAD_TOL}
    if bad:
        raise RuntimeError(f"phase {phase}: gradients through the {fmt} control off phase "
                           f"5's K2 route by more than {SPARSE_GRAD_TOL}: {bad}")
    if not rel <= SPARSE_LOSS_RTOL:
        raise RuntimeError(f"phase {phase}: first loss {losses[0]} vs phase 5's "
                           f"{first_loss_ref}: rel diff {rel:.3e} > {SPARSE_LOSS_RTOL}")
    want = ("K8", "K9") if fmt == "bcsr" else ("K10",)
    never = {"K1", "K2", "K8", "K9", "K10"} - set(want)
    if min(launches[k] for k in want) <= 0 or any(launches[k] for k in never):
        raise RuntimeError(f"phase {phase}: launches {launches}; want {want} > 0 and "
                           f"{sorted(never)} = 0")
    return launches


def phase_scaled(torch):
    """benchmarks/bcsr_scale.py's point as a training step on the card."""
    import numpy as np

    from gncde_tpu_torch.interp import bcsr_control_from_edge_snapshots
    from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField
    from gncde_tpu_torch.solve import ConstantStepSize, ODETerm, SaveAt, diffeqsolve
    from gncde_tpu_torch.train.trainer import tensor_bytes

    s = SCALED
    n, bw, bs, H, L, T = (s[k] for k in ("n", "bw", "bs", "H", "L", "T"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    i = np.repeat(np.arange(n), 2 * bw + 1)
    src, dst = i, (i + np.tile(np.arange(-bw, bw + 1), n)) % n
    snaps = [(src, dst, (0.1 * rng.random(src.size)).astype(np.float32)) for _ in range(T)]
    t0 = time.perf_counter()
    ctrl = bcsr_control_from_edge_snapshots(np.linspace(0.0, 1.0, T, dtype=np.float32),
                                            snaps, n, block_size=bs).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    coeff_bytes = tensor_bytes([ctrl.path.coeffs, ctrl.path.coeffs_T])
    vf = PermEquivGraphVectorField(H, H, H, L, 1, n,
                                   generator=torch.Generator().manual_seed(1)).to(dev)
    y0 = torch.tensor((0.1 * rng.normal(size=(1, n, H))).astype(np.float32), device=dev)

    def step():
        for p in vf.parameters():
            p.grad = None
        sol = diffeqsolve(ODETerm(vf), "Heun", t0=0.0, t1=1.0, dt0=0.25, y0=y0, args=ctrl,
                          stepsize_controller=ConstantStepSize(), saveat=SaveAt(t1=True),
                          max_steps=8)
        loss = sol.ys.square().mean()
        loss.backward()
        with torch.no_grad():
            for p in vf.parameters():
                p -= 1e-3 * p.grad
        return float(loss.detach())

    for f in counters().values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = [step()]  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(3)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    launches = {k: f.launches for k, f in counters().items()}
    emit({"phase": 13, **s, "edges_per_knot": int(src.size), "control_build_s": build_s,
          "coefficient_bytes": coeff_bytes,
          "dense_f32_plane_bytes": 4 * 4 * (T - 1) * n * n, "losses": losses,
          "step_s": step_s, "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    if not all(math.isfinite(v) for v in losses) or len(set(losses)) < len(losses):
        raise RuntimeError(f"phase 13: losses not finite or not moving: {losses}")
    if launches["K8"] <= 0 or launches["K9"] <= 0:
        raise RuntimeError(f"phase 13: K8/K9 not launched: {launches}")
    return launches


def main() -> int:
    torch = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[phase] = time.perf_counter() - t0
        return out

    timed(1, phase_device, torch)
    timed(2, phase_build)
    results = {}
    timed(3, phase_k1, torch, results)
    timed(4, phase_k2, torch, results)
    with tempfile.TemporaryDirectory() as cache:  # phases 5, 10-12 share the flagship data
        dyn_launches, dyn_losses = timed(5, phase_train, torch, cache)
        timed(6, phase_tiled, torch, results)
        tgb_launches = timed(7, phase_tgb, torch)
        timed(8, phase_pair, torch, results)
        enc_launches = timed(9, phase_enc_idx, torch)
        timed(10, phase_sparse_kernels, torch, cache, results)
        bcsr_launches = timed(11, phase_sparse_train, torch, 11, "bcsr", BCSR_EPOCHS, cache,
                              dyn_losses[0])
        ell_launches = timed(12, phase_sparse_train, torch, 12, "ell", ELL_EPOCHS, cache,
                             dyn_losses[0])
    timed(13, phase_scaled, torch)
    emit({"phase_wall_s": walls})

    s = SHAPES["flagship"]
    n, B, w = s["n"], s["B"], s["widths"]
    planes = 4 * 4 * n * n * B  # four f32 interval planes per element
    kernels = []
    for name, src, rep, (bms, by) in (
        # K1: Z -> output, one product C M per layer.
        ("K1", "gncde_tpu_torch/csrc/megakernel_fwd.cu",
         "gncde_tpu/ops/pallas/megakernel.py:277",
         bound(planes + 4 * n * B * (w[0] + w[-1]),
               (sum(2 * n * n * h * B for h in w[1:]), F32_FLOPS))),
        # K2: Z, G -> dZ; per layer the forward recompute C M, C^T g and
        # P = g M^T, then the four basis dots <A|dA, P>, <A|dA, P^T>.
        ("K2", "gncde_tpu_torch/csrc/megakernel_bwd.cu",
         "gncde_tpu/ops/pallas/megakernel_bwd.py:412",
         bound(planes + 4 * n * B * (2 * w[0] + w[-1]),
               (sum((6 * h + 8) * n * n * B for h in w[1:]), F32_FLOPS))),
    ):
        _, err, ms, plain_ms = results[name][0]  # flagship shape
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": dyn_launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by, "library_ms": None,
                        "shape": "flagship"})
    for name, rep in (("K3", "gncde_tpu/ops/pallas/tiled.py:345"),
                      ("K4", "gncde_tpu/ops/pallas/tiled.py:476"),
                      ("K5a", "gncde_tpu/ops/pallas/tiled.py:748"),
                      ("K5b", "gncde_tpu/ops/pallas/tiled.py:275")):
        err, ms, plain_ms, bms, by = results[name]["genre-H128"]
        kernels.append({"name": name, "route": "cuda",
                        "source": "gncde_tpu_torch/csrc/tiled.cu", "replaces": rep,
                        "launches": tgb_launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None, "shape": "genre-H128"})
    for name, src, rep, label in (
        ("K6a", "gncde_tpu_torch/csrc/tiled.cu", "gncde_tpu/ops/pallas/tiled.py:572",
         "genre-H128"),
        ("K6b", "gncde_tpu_torch/csrc/tiled.cu", "gncde_tpu/ops/pallas/tiled.py:638",
         "genre-H128"),
        ("K7", "gncde_tpu_torch/csrc/modulate.cu", "gncde_tpu/ops/pallas/modulate.py:146",
         "genre-H128"),
    ):
        err, ms, plain_ms, bms, by, extra = results[name][label]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": enc_launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None, "shape": "genre (n=1505, B=1)" if name == "K7"
                        else label, **extra})
    for name, src, rep, launches in (
        ("K8", "gncde_tpu_torch/csrc/bcsr.cu", "gncde_tpu/ops/bcsr.py:244", bcsr_launches),
        ("K9", "gncde_tpu_torch/csrc/bcsr.cu", "gncde_tpu/ops/bcsr.py:362", bcsr_launches),
        ("K10", "gncde_tpu_torch/csrc/ell_spmm.cu", "gncde_tpu/ops/pallas/sparse_spmm.py:58",
         ell_launches),
    ):
        err, ms, plain_ms, bms, by, library_ms, shape = results[name]["flagship"]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": library_ms, "shape": f"flagship {shape}"})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
