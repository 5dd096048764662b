"""GPU smoke test of the PyTorch/Hopper port (gncde_tpu_torch).

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each printing one line before the last:
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. build K1, K2, the tiled kernels K3-K6b and K7 from gncde_tpu_torch/csrc,
     one nvcc per source, all started together (nvcc seconds per source);
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
     per snapshot) cut from 133 snapshots to 50: 5 windows of 10, 3 train, 1
     validation, 1 test; every train loss and the validation NDCG@10 must be
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
     have launched, and K3 and K4 must not have (enc_idx bypasses them).
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
GENRE_SNAPSHOTS = 50
#: Phase 9's cut: 16 snapshots in windows of 3 (the trade configs' window).
ENC_IDX_SNAPSHOTS = 16
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
    _build.build(["megakernel_fwd", "megakernel_bwd", "tiled", "modulate"])
    emit({"phase": 2, "build_s": time.perf_counter() - t0,
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


def phase_train(torch):
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import megakernel_bwd as mkb
    from gncde_tpu_torch.run import dyn

    with tempfile.TemporaryDirectory() as tmp:
        mk.megakernel_vf_eval.launches = 0
        mkb.megakernel_vf_bwd.launches = 0
        t0 = time.perf_counter()
        res = dyn.main([
            "--config", "configs/dyn/perm_equiv_gncde.yaml",
            "epochs=3", "eval_freq=1", "log_freq=1", "min_epochs=0",
            f"dataset.cache_dir={tmp}/cache", f"checkpoint_dir={tmp}/ckpt/",
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
    return {"K1": k1, "K2": k2}


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


def write_genre_surrogate(out: Path, snapshots: int = GENRE_SNAPSHOTS) -> None:
    """tools/fetch_tgb.py's tgbn-genre surrogate cut to ``snapshots``
    snapshots (the tool is numpy-only, loaded by path). Seed 2 is the first
    whose first 16 and 50 snapshots touch all 1505 nodes, the config's n
    (seed 0's pair pool misses a node; seed 1's first 50 snapshots miss
    one). The generator is sequential, so a cut keeps the first snapshots."""
    tool = Path(__file__).resolve().parent / "tools" / "fetch_tgb.py"
    spec = importlib.util.spec_from_file_location("fetch_tgb", tool)
    fetch_tgb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fetch_tgb)
    fetch_tgb.SCALES["tgbn-genre"]["num_years"] = snapshots
    fetch_tgb.synthetic("tgbn-genre", out, seed=2)


def counters():
    from gncde_tpu_torch.ops import megakernel, megakernel_bwd, modulate, pair, tiled

    return {"K1": megakernel.megakernel_vf_eval, "K2": megakernel_bwd.megakernel_vf_bwd,
            "K3": tiled.fwd2_call, "K4": tiled.bwd2_call, "K5a": tiled.dw2_call,
            "K5b": tiled.dw_call, "K6a": pair.pair_call, "K6b": pair.pair_dw_call,
            "K7": modulate.modulate_pair}


def run_tgb(torch, phase, config, snapshots, extra=()):
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
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"phase {phase}: non-finite or missing train losses: {losses}")
    if not math.isfinite(ndcg):
        raise RuntimeError(f"phase {phase}: validation NDCG@10 is not finite: {ndcg}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"phase {phase}: ran on {res['device']}, not cuda")
    return launches


def phase_tgb(torch):
    launches = run_tgb(torch, 7, "configs/tgb/genre_perm_equiv_gncde.yaml", GENRE_SNAPSHOTS)
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise RuntimeError(f"tiled kernels not launched on the TGB path: {launches}")
    return launches


def phase_enc_idx(torch):
    launches = run_tgb(torch, 9, "configs/tgb/genre_perm_equiv_enc_idx_gncde.yaml",
                       ENC_IDX_SNAPSHOTS, ("dataset.window_size=3", "dataset.stride=3"))
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


def main() -> int:
    torch = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)
    phase_build()
    results = {}
    phase_k1(torch, results)
    phase_k2(torch, results)
    dyn_launches = phase_train(torch)
    phase_tiled(torch, results)
    tgb_launches = phase_tgb(torch)
    phase_pair(torch, results)
    enc_launches = phase_enc_idx(torch)

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
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
