"""Profile one training step of the PyTorch port on a CUDA card.

    python3 profile_step_torch.py [--num-nodes 400] [--trace step_trace.json]
    python3 profile_step_torch.py --fused-step
    python3 profile_step_torch.py --task tgb [--window 3]

``--task dyn`` (the default) builds ``configs/dyn/perm_equiv_gncde.yaml`` at
full width (hidden 16, 2 layers, batch 4; ``--num-nodes`` cuts the graph)
and generates its training data. ``--task tgb`` builds
``configs/tgb/genre_perm_equiv_gncde.yaml`` at full width (n=1505, hidden 8,
3 layers) on one window of ``chip_smoke.py``'s tgbn-genre surrogate, cut to
``--window`` snapshots (3: a 2-knot body, 100 of the config's 800 constant
steps, so the trace stays small; every step does the same work). It times
the forward + backward of the training loss: the solve under the
checkpointed adjoint, without the optimiser update, so that every run
repeats the same computation. Runs are timed on the host clock, ended by
``torch.cuda.synchronize()``, in the order kernel path (fusion backend
``megakernel``: K1 forward and K2 backward for dyn, K3 forward and K4
backward for tgb), plain path (``dense``), plain, kernel. With
``--fused-step`` (dyn) the kernel path is the fused RK step (K11 forward,
one K2 per stage backward: ``ops.set_fused_step(True)``) and it is
compared with the per-stage K1/K2 path instead of the plain one. One more
kernel-path run is traced with ``torch.profiler``; from the trace's device
events (kernels, copies, memsets) it reports:

* ``device_busy_ms``: the union of the device events' intervals;
* ``device_span_ms``: first device event's start to last device event's end;
* ``busy_share_of_unprofiled_wall``: busy time over the mean unprofiled
  kernel-path wall time (the profiler stretches the host, not the kernels);
* ``busy_share_of_span``: busy time over the traced span;
* the kernels with the most device time, and the kernels' launch counts
  (``launches``: wrapper calls, each counted once; a K3 call whose reduce
  extent is split launches two kernels);
* ``port_kernels``: every kernel of the port's own CUDA sources (by its
  namespace), with its device time and count.

Prints the card (``nvidia-smi`` name and power limit) and then one JSON
object. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = {"dyn": os.path.join(ROOT, "configs", "dyn", "perm_equiv_gncde.yaml"),
           "tgb": os.path.join(ROOT, "configs", "tgb", "genre_perm_equiv_gncde.yaml")}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The namespaces of the kernels in gncde_tpu_torch/csrc.
PORT_KERNEL = re.compile(r"\b(bcsr|ell|fa|fs|k3|md|mk|mkp|tl)::")


def device_events(trace_path: str):
    """(name, start_us, dur_us) of every device event of a Chrome trace."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e.get("name", ""), float(e["ts"]), float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATS]


def busy_and_span(events):
    """Union length of the events' intervals and their span, in us."""
    iv = sorted((s, s + d) for _, s, d in events)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in iv) - iv[0][0]


def dyn_setup(args, tmp, dev):
    """(model, loss closure, data seconds) of the flagship dyn step."""
    from gncde_tpu_torch.models.continuous import make_control
    from gncde_tpu_torch.run.common import apply_overrides, safe_load
    from gncde_tpu_torch.train.trainer import Trainer
    import torch

    with open(CONFIGS["dyn"]) as f:
        cfg = apply_overrides(safe_load(f.read()), [
            f"dataset.cache_dir={tmp}", f"dataset.num_nodes={args.num_nodes}",
            "device=cuda", "wandb.mode=disabled"])
    tr = Trainer.from_dict(cfg)
    t0 = time.perf_counter()
    d = tr.dataset.get_training_data()
    data_s = time.perf_counter() - t0
    ctrl = make_control("cubic", d["train_t"], d["train_graph_path_coeffs"]).to(dev)
    data = (d["train_t"].to(dev), ctrl, d["train_true_y"].to(dev), d["true_y0"].to(dev))
    loss_fn = tr.loss.build()
    model = tr.model.build(torch.Generator().manual_seed(tr.seed)).to(dev)
    return model, lambda: loss_fn(model, data), data_s


def tgb_setup(args, tmp, dev):
    """(model, loss closure, data seconds) of one genre TGB step on the
    first ``args.window`` snapshots of the surrogate."""
    from pathlib import Path

    import torch
    import chip_smoke
    from gncde_tpu_torch.data import tgb, windows
    from gncde_tpu_torch.run.common import apply_overrides, safe_load
    from gncde_tpu_torch.train.windowed import TGBTrainer, _to_device

    t0 = time.perf_counter()
    chip_smoke.write_genre_surrogate(Path(tmp) / "data", args.window)
    edges = tgb.load_tgb_edgelist("tgbn-genre-synth", os.path.join(tmp, "data"))
    snaps = tgb.process_snapshots(edges, "None")[:args.window]
    window = _to_device(windows.process_window_tgb(snaps, "cubic"), dev)
    data_s = time.perf_counter() - t0
    with open(CONFIGS["tgb"]) as f:
        cfg = apply_overrides(safe_load(f.read()), ["device=cuda", "wandb.mode=disabled"])
    tr = TGBTrainer.from_dict(cfg)
    model = tr.model.build(torch.Generator().manual_seed(tr.seed)).to(dev)
    return model, lambda: tr._loss(model, tr._data_tuple(window)), data_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--task", choices=("dyn", "tgb"), default="dyn")
    ap.add_argument("--num-nodes", type=int, default=400, help="dyn: graph size")
    ap.add_argument("--window", type=int, default=3, help="tgb: snapshots per window")
    ap.add_argument("--trace", help="also keep the Chrome trace at this path")
    ap.add_argument("--fused-step", action="store_true",
                    help="dyn: the fused RK step (K11) against the per-stage K1 path")
    args = ap.parse_args()
    if args.fused_step and args.task != "dyn":
        ap.error("--fused-step applies to --task dyn")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_step_torch: no CUDA device visible")
    from gncde_tpu_torch import ops
    from gncde_tpu_torch.ops import fused_step
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import megakernel_bwd as mkb
    from gncde_tpu_torch.ops import tiled

    counters = {"K1": mk.megakernel_vf_eval, "K2": mkb.megakernel_vf_bwd,
                "K3": tiled.fwd2_call, "K4": tiled.bwd2_call,
                "K11": fused_step.fused_step_call}
    # (kernel path, the path it is compared with)
    kernel_path, other_path = ("fused", "megakernel") if args.fused_step else ("megakernel",
                                                                               "dense")

    def use(path):
        ops.set_fused_step(path == "fused")
        ops.set_fusion_backend("dense" if path == "dense" else "megakernel")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")

    with tempfile.TemporaryDirectory() as tmp:
        setup = dyn_setup if args.task == "dyn" else tgb_setup
        model, loss_of, data_s = setup(args, tmp, dev)

        def fwd_bwd():
            model.zero_grad()
            loss = loss_of()
            loss.backward()
            torch.cuda.synchronize()
            return float(loss)

        def timed(path):
            use(path)
            t = time.perf_counter()
            loss = fwd_bwd()
            wall = time.perf_counter() - t
            stats = getattr(model, "last_stats", None)
            return {"wall_s": wall, "loss": loss, "attempts": (
                (stats["num_accepted_steps"] + stats["num_rejected_steps"]).tolist()
                if stats else None)}

        use(kernel_path)
        fwd_bwd()  # warm-up: kernel build and first launches
        runs = {kernel_path: [], other_path: []}
        for path in (kernel_path, other_path, other_path, kernel_path):
            runs[path].append(timed(path))

        use(kernel_path)
        for f in counters.values():
            f.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fwd_bwd()
            prof_wall = time.perf_counter() - t
        trace = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        events = device_events(trace)

    if not events:
        raise RuntimeError("the trace holds no device events")
    busy_us, span_us = busy_and_span(events)
    by_name = {}
    for name, _, dur in events:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + dur, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    own = sorted((kv for kv in by_name.items() if PORT_KERNEL.search(kv[0])),
                 key=lambda kv: -kv[1][0])
    mk_wall = sum(r["wall_s"] for r in runs[kernel_path]) / len(runs[kernel_path])
    print(json.dumps({
        "nvidia_smi": smi, "task": args.task, "kernel_path": kernel_path,
        **({"num_nodes": args.num_nodes} if args.task == "dyn" else {"window": args.window}),
        "data_s": data_s, "fwd_bwd": runs,
        "profiled": {
            "wall_s": prof_wall,
            "device_busy_ms": busy_us / 1e3,
            "device_span_ms": span_us / 1e3,
            "busy_share_of_unprofiled_wall": busy_us / 1e6 / mk_wall,
            "busy_share_of_span": busy_us / span_us,
            "device_events": len(events),
            "launches": {k: f.launches for k, f in counters.items()},
            "top_kernels": [{"name": k[:80], "ms": v[0] / 1e3, "count": v[1]}
                            for k, v in top],
            "port_kernels": [{"name": k[:80], "ms": v[0] / 1e3, "count": v[1]}
                             for k, v in own],
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
