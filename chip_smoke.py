"""GPU smoke test of the PyTorch/Hopper port (gncde_tpu_torch).

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each printing one line before the last:
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. build K1 and K2 from gncde_tpu_torch/csrc with nvcc (build seconds);
  3. K1 (forward vf kernel) against its plain PyTorch version at the
     flagship shape (n=400, B=4, H=16, L=2) and the bench shape (H=32, L=3),
     per-element planes and (idx, tau); max abs err <= 1e-4 * max|ref|;
  4. K2 (backward vf kernel) against the plain autograd version at the same
     shapes, with and without the tau cotangent; every cotangent within
     1e-3 * max|ref|;
  5. the main path: ``gncde_tpu_torch.run.dyn.main`` trains the flagship
     config configs/dyn/perm_equiv_gncde.yaml for 3 epochs at full width
     on the card; every train loss must be finite and both kernels must
     have launched.
The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA device the script fails before phase 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

SHAPES = {
    "flagship": dict(n=400, B=4, H=16, L=2),
    "bench": dict(n=400, B=4, H=32, L=3),
}
K1_TOL = 1e-4
K2_TOL = 1e-3


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
    for name in ("megakernel_fwd", "megakernel_bwd"):
        _build.load(name)
    emit({"phase": 2, "build_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.BUILD_SECONDS)})


def make_inputs(torch, n, B, H, L, seed=0, T=8):
    """Per-element planes and (idx, tau), node state and layer params."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    planes = tuple(t(rng.uniform(-0.05, 0.1, (B, T - 1, n, n))) for _ in range(4))
    idx = torch.tensor(rng.permutation(T - 1)[:B], device=dev)
    tau = t(rng.uniform(0.0, 0.2, B))
    Z = t(rng.normal(size=(B, n, H)))
    layers = []
    for _ in range(L):
        lim = 1.0 / np.sqrt(H)
        layers.append(dict(
            norm_w=t(1.0 + 0.1 * rng.normal(size=H)),
            norm_b=t(0.1 * rng.normal(size=H)),
            W=t(rng.uniform(-lim, lim, (H, H))),
            lin_b=t(rng.uniform(-lim, lim, H)),
            basis=t(rng.uniform(-1 / 15, 1 / 15, (8, 2))),
        ))
    G = t(rng.normal(size=(B, n, H)))
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


def main() -> int:
    torch = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)
    phase_build()
    results = {}
    phase_k1(torch, results)
    phase_k2(torch, results)
    launches = phase_train(torch)

    kernels = []
    for name, src, rep in (
        ("K1", "gncde_tpu_torch/csrc/megakernel_fwd.cu",
         "gncde_tpu/ops/pallas/megakernel.py:277"),
        ("K2", "gncde_tpu_torch/csrc/megakernel_bwd.cu",
         "gncde_tpu/ops/pallas/megakernel_bwd.py:412"),
    ):
        _, err, ms, plain_ms = results[name][0]  # flagship shape
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
