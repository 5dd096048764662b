"""Developer tool: time kernels of the PyTorch port on a CUDA card, with
and without their host work, and compare two checkouts' kernels in one run.
``chip_smoke.py`` gives wrapper times on every run; this tool adds what a
redesign needs beside them: device times, yardsticks, ptxas reports.

    python3 tools/kernel_times_torch.py [--only K3,K4,K6a,K6a-bf,K10] [--splits 1,2,4]
                                        [--root DIR]
    python3 tools/kernel_times_torch.py --only K1,K2,K1d,K2d,K11

Shapes:

* K3: genre-H8, genre-H128 and odd (phase 6); K10: flagship, scaled and odd
  (phase 10);
* K4: genre-H8, genre-H128 (phases 7 and 19) and odd;
* K6a, K6a-bf: genre-H8, genre-H128 (phases 9, 24), trade-H32,
  trade-H512 (phases 23, 25) and odd; K6a-bf with the forward's f32
  vectors and with the backward's bf16 ones;
* K8-ablation, K1-ablation, K1bf-ablation: K8 at the flagship and scaled
  shapes, and K1's f32 row pass and K1bf's bf16 one at the flagship, trade
  and n=640 shapes, with parts of their work dropped or (K1) the products
  as 3xTF32 (``K8_ABLATION``, ``K1_ABLATION``, ``K1BF_ABLATION``; the probe
  instantiations of ``csrc/bcsr.cu`` and ``csrc/row_probe.cu``), and under
  each plan (K8's strip heights, the row pass's CTA heights), device ms
  each;
* K6a-ablation: K6a's f32 sweep at genre-H128 and trade-H512 with one part
  of its work dropped at a time (``K6A_ABLATION``: the MMA, the forming of
  B1/B2, the plane copies, the vector copies, one pass), device ms each;
* K8: flagship, scaled and odd (phase 10), beside cuSPARSE's ``BSR @ M``;
* K1, K2, K1d, K2d: the flagship (n=400, B=4, 16-16-16), trade (n=255,
  B=4, 32x4-512) and n=640 (B=1, 64-64-64) shapes of phases 3, 4 and 17,
  with each launch's device ms in order (``launch_device_ms``: K1's prep
  pass, then layer 1 .. L); K1 and K1d with the row pass's plan and, as
  their yardstick, one cuBLAS f32 bmm per layer on C formed beforehand;
  K2 and K2d with the reverse sweep's plan and, as theirs, two cuBLAS f32
  calls per layer (``chip_smoke.k2_yardstick``);
* K11, K11d: the flagship and bench step shapes of phase 14 (Tsit5; its
  layers must map the state width to itself, so no trade shape), with the
  step kernel's device ms by name (``step_kernel_device_ms``) beside the
  per-stage route's on the same stage inputs (``per_stage_k1_device_ms``:
  its six K1 or K1d launches) and the stages' plans;
* K1bf, K1dbf (flagship, trade), K2bf, K2dbf (flagship, trade, n=640),
  K11bf, K11dbf (step shapes) on bf16 planes; K6b, K6b-bf (genre-H128,
  trade-H512), K7, K7bf (genre and trade planes), K12, K13 (phase 14's
  apply shapes): device ms beside the wrapper ms that ``chip_smoke.py``
  prints, and the outputs for ``--compare``; K1bf and K1dbf also each
  launch's device ms (the prep pass, then layer 1 .. L), the bf16 row
  pass's plan, each layer's M for ``--compare`` and, as their yardstick,
  one cuBLAS bf16 bmm a layer of [B1 | B2^T] formed beforehand with [Mh;
  Mh] (``chip_smoke.k1_bf16_yardstick``); K11bf and K11dbf, as K11, the
  per-stage route's device ms beside the step kernel's; K2bf and K2dbf
  also each launch's device ms (the recompute's prep and row passes, the sweep's
  layers, the reduction: ``launch_device_ms``), the sweep's plan and, as
  their yardstick, two cuBLAS bf16 calls a layer
  (``chip_smoke.k2_yardstick``); K6b and K6b-bf their plan, the one
  PyTorch call that computes their function (``chip_smoke.k6b_library``:
  one ``torch.einsum`` on stacked operands, timed both ways) and, as their
  yardstick, one ``torch.bmm`` of [A; dA] with [Mk | Gc] and the
  multiply-sum with [Gr | Mi] (``chip_smoke.k6b_yardstick``); K11bf and
  K11dbf also forward + backward (``FusedRKStep``: one K2bf a stage),
  wrapper and device ms;
* K2-ablation, K2bf-ablation: K2 (f32) and K2bf at the flagship, trade and
  n=640 shapes with parts of their reverse sweep dropped (``K2_ABLATION``,
  ``csrc/bwd_probe.cu``; ``K2BF_ABLATION``, ``csrc/bwd_bf_probe.cu``), and
  the main path's kernel under each sweep CTA height, without and with
  dtau;
* K6b-ablation: K6b and K6b-bf at genre-H128 and trade-H512 with parts of
  their work dropped (``K6B_ABLATION``, ``gncde_pair_dw_probe``).

It prints one JSON line per kernel and shape:

* ``ms``: CUDA events over 20 back-to-back wrapper calls after 3 warm-ups
  (``chip_smoke.time_ms``, phase 6's and 10's figure). The host's work is
  inside: where the host is slower than the device, this times the host;
* ``device_ms``: the device time of 20 such calls, summed from a
  torch.profiler trace (``chip_smoke.device_ms``), and ``device_by_name``;
* ``plain_ms``, ``bound_ms``, ``bound_by`` as phases 6 and 10 compute them;
* the yardstick, timed both ways: K3's two cuBLAS bf16 products on B1 and B2
  formed beforehand (``yardstick_*``; two calls on pre-formed operands, not
  one call for K3's function); K6a's two cuBLAS products on B1, B2 formed
  beforehand (f32 planes: f32 B and vectors; K6a-bf: the bf16-formed B as
  f32 with the f32 vectors, or bf16 with the bf16 vectors); K4's four bf16
  cuBLAS products ``A g``, ``dA g``, ``A^T g``, ``dA^T g``; K10's ``A_csr @
  M`` (``library_*``, with its cuSPARSE kernels' names). K11 has none;
* ``splits``: K3, K4 and K6a at genre shapes with the reduce extent split in
  S parts (``ops.tiled.fwd2_splits`` or ``mma_splits`` replaced by the
  constant S for the run), where the checkout's kernel has that plan.

Then the ``ptxas -v`` lines (registers, spills, shared memory) of each
timed kernel's entry points, from ``build/gncde_tpu_torch/<lib>.ptxas.log``
(K4 and K6a: ``plane_mma``, or ``tiled`` in an older checkout).

``--root DIR`` times the ``gncde_tpu_torch`` of another checkout (such as a
parent commit unpacked under ``build/``) with this script's helpers, so two
versions can be compared in one run on one card; ``--save DIR`` keeps each
kernel's outputs at each shape (``DIR/outputs.pt``), and ``--compare DIR1
DIR2`` prints, per kernel and shape, whether two saved runs are bitwise
equal and their largest difference. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(root: Path, lib: str, pattern: str):
    """[(entry, used line, stack line)] of ``lib``'s ptxas log for the entry
    points whose mangled name matches ``pattern``."""
    log = root / "build" / "gncde_tpu_torch" / f"{lib}.ptxas.log"
    if not log.exists():
        return [f"{log} missing"]
    out, entry, stack = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, stack = m.group(1), ""
        elif entry and "stack frame" in line:
            stack = line.strip()
        elif entry and "Used" in line:
            if re.search(pattern, entry):
                out.append({"entry": entry, "used": line.split(":", 1)[-1].strip(),
                            "stack": stack})
            entry = None
    return out


def host_us(fn, calls=2000):
    """Microseconds of host time per call of ``fn`` (``calls`` calls)."""
    import time

    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def sweep_plans(s, need_tau=False, bf16=False):
    """The reverse sweep's plan per layer at shape ``s`` (``bf16``: K2bf's)
    from the timed checkout's ``ops.megakernel_bwd``, or None where that
    checkout has none (no ``bwd_row_plans``, or one without ``bf16``)."""
    import inspect

    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    plans = getattr(mkb, "bwd_row_plans", None)
    if plans is None or (bf16 and "bf16" not in inspect.signature(plans).parameters):
        return None
    kw = {"bf16": True} if bf16 else {}
    return [p._asdict() for p in plans(s["n"], s["B"], s["widths"], need_tau, **kw)]


def time_both(cs, torch, fn):
    """``(ms, device ms, device ms by name)``. The device time is None where
    every trace lost events and ``fn`` cannot be captured in a CUDA graph
    (K11 copies its stage nodes from the host): the run goes on, and still
    keeps every kernel's outputs for ``--compare``."""
    try:
        dev, by_name = cs.device_ms(torch, fn)
    except RuntimeError as e:
        dev, by_name = None, {"not measured": str(e)[:90]}
    return cs.time_ms(torch, fn), dev, {k[:90]: v for k, v in by_name.items()}


def k3_lines(cs, torch, splits, saved):
    from gncde_tpu_torch.ops import tiled as tt

    plan = getattr(tt, "fwd2_splits", None)
    for label, s in cs.TILED_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        A, dA, M, _, _, cvec = cs.make_tiled_inputs(torch, n, H, B)
        got, ref = tt.fwd2_call(A, dA, cvec, M), tt.plain_fwd2(A, dA, cvec, M)
        saved[f"K3/{label}"] = [x.cpu() for x in got]
        err = max(cs.rel_err(torch, a, b)[0] for a, b in zip(got, ref))
        ms, dev, by = time_both(cs, torch, lambda: tt.fwd2_call(A, dA, cvec, M))
        c = cvec.to(torch.bfloat16)
        B1 = c[0] * A + c[1] * dA
        B2t = (c[2] * A + c[3] * dA).transpose(-2, -1)
        y_ms, y_dev, y_by = time_both(
            cs, torch, lambda: (torch.matmul(B1, M), torch.matmul(B2t, M)))
        bms, by_ = cs.tiled_bound("K3", n, H, B)
        line = {"kernel": "K3", "shape": label, **s, "rel_err": err, "ms": ms,
                "device_ms": dev, "device_by_name": by,
                "plain_ms": cs.time_ms(torch, lambda: tt.plain_fwd2(A, dA, cvec, M)),
                "bound_ms": bms, "bound_by": by_,
                "yardstick_two_cublas_bf16_products_ms": y_ms,
                "yardstick_device_ms": y_dev, "yardstick_device_by_name": y_by}
        if plan is not None and splits and label.startswith("genre"):
            line["splits"] = {}
            try:
                for S in splits:
                    tt.fwd2_splits = lambda B, n, H, S=S: S
                    got = tt.fwd2_call(A, dA, cvec, M)
                    e = max(cs.rel_err(torch, a, b)[0] for a, b in zip(got, ref))
                    sm, sd, _ = time_both(cs, torch, lambda: tt.fwd2_call(A, dA, cvec, M))
                    line["splits"][S] = {"rel_err": e, "ms": sm, "device_ms": sd}
            finally:
                tt.fwd2_splits = plan
        cs.emit(line)
        del A, dA, M, B1, B2t
        torch.cuda.empty_cache()


def line_of(cs, torch, kernel, label, s, got, ref, kernel_fn, plain_fn, bms, by,
            yardstick=None, yardstick_name=None, saved=None, extra=None):
    """One timing line: errors against the plain version, wrapper and device
    ms, plain ms, bound, (where given) a yardstick timed both ways and
    ``extra`` fields."""
    if saved is not None:
        saved[f"{kernel}/{label}"] = [x.float().cpu() for x in got]
    again = kernel_fn()
    ms, dev, by_name = time_both(cs, torch, kernel_fn)
    line = {"kernel": kernel, "shape": label, **s,
            "rel_err": max(cs.rel_err(torch, a.float(), b.float())[0]
                           for a, b in zip(got, ref)),
            "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
            "ms": ms, "device_ms": dev, "device_by_name": by_name,
            "plain_ms": cs.time_ms(torch, plain_fn), "bound_ms": bms, "bound_by": by}
    if yardstick is not None:
        y_ms, y_dev, y_by = time_both(cs, torch, yardstick)
        line.update({yardstick_name: y_ms, "yardstick_device_ms": y_dev,
                     "yardstick_device_by_name": y_by})
    cs.emit({**line, **(extra or {})})


#: K4's and K6a's shapes (K4 on the genre ones and the odd one only).
PAIR_SHAPES = {"genre-H8": dict(n=1505, H=8, B=1), "genre-H128": dict(n=1505, H=128, B=1),
               "trade-H32": dict(n=255, H=32, B=1), "trade-H512": dict(n=255, H=512, B=1),
               "odd": dict(n=300, H=5, B=2)}


def split_lines(cs, torch, name, label, kernel, plain, splits):
    """K4 or K6a with its reduce extents split in each of ``splits`` parts
    (``ops.tiled.mma_splits`` replaced by the constant for the run): error
    against the plain version and device ms per count."""
    from gncde_tpu_torch.ops import tiled as tt

    plan, ref, out = tt.mma_splits, plain(), {}
    try:
        for S in splits:
            tt.mma_splits = lambda B, nr, nc, H, S=S: S
            got = kernel()
            out[S] = {"rel_err": max(cs.rel_err(torch, a.float(), b.float())[0]
                                     for a, b in zip(got, ref)),
                      "device_ms": cs.device_ms(torch, kernel)[0]}
    finally:
        tt.mma_splits = plan
    cs.emit({"kernel": name, "shape": label, "splits": out})


def k4_lines(cs, torch, saved, splits=()):
    from gncde_tpu_torch.ops import tiled as tt

    for label, s in PAIR_SHAPES.items():
        if label.startswith("trade"):
            continue
        n, H, B = s["n"], s["H"], s["B"]
        A, dA, M, G, _, cvec = cs.make_tiled_inputs(torch, n, H, B)
        kernel = lambda: tt.bwd2_call(A, dA, cvec, G, M)  # noqa: E731
        plain = lambda: tt.plain_bwd2(A, dA, cvec, G, M)  # noqa: E731
        At, dAt = A.transpose(-2, -1), dA.transpose(-2, -1)
        four = lambda: (torch.matmul(A, G), torch.matmul(dA, G),  # noqa: E731
                        torch.matmul(At, G), torch.matmul(dAt, G))
        line_of(cs, torch, "K4", label, s, kernel(), plain(), kernel, plain,
                *cs.tiled_bound("K4", n, H, B), four,
                "yardstick_four_cublas_bf16_products_ms", saved)
        if splits and label.startswith("genre"):
            split_lines(cs, torch, "K4", label, kernel, plain, splits)
        del A, dA, M, G
        torch.cuda.empty_cache()


def k6a_lines(cs, torch, saved, bf16, splits=()):
    from gncde_tpu_torch.ops import pair as tp

    forms = [("K6a-bf", False), ("K6a-bf-bf16-vectors", True)] if bf16 else [("K6a", False)]
    for label, s in PAIR_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        x = cs.make_pair_inputs(torch, n, H, B)
        c = x["cvec"]
        A, dA = (x["A"], x["dA"]) if not bf16 else (x["A"].to(torch.bfloat16),
                                                    x["dA"].to(torch.bfloat16))
        cc = c.to(A.dtype)
        B1, B2t = cc[0] * A + cc[1] * dA, (cc[2] * A + cc[3] * dA).transpose(-2, -1)
        for name, bvec in forms:
            Mk, Mi = (x["Mk"], x["Mi"]) if not bvec else (x["Mk"].to(torch.bfloat16),
                                                          x["Mi"].to(torch.bfloat16))
            P1, P2 = (B1, B2t) if bvec or not bf16 else (B1.float(), B2t.float())
            args = (A, dA, c, Mk, Mi)
            kernel = lambda: tp.pair_call(*args)  # noqa: E731
            plain = lambda: tp.plain_pair(*args)  # noqa: E731
            two = lambda: (torch.matmul(P1, Mk), torch.matmul(P2, Mi))  # noqa: E731
            sizes = dict(plane_bytes=2 if bf16 else 4, vec_bytes=2 if bvec else 4)
            line_of(cs, torch, name, label, s, kernel(), plain(), kernel, plain,
                    *cs.pair_bound(name, n, H, B, **sizes), two,
                    f"yardstick_two_cublas_{'bf16' if bvec else 'f32'}_products_ms", saved)
            if splits and label.startswith("genre"):
                split_lines(cs, torch, name, label, kernel, plain, splits)
        del x, A, dA, B1, B2t
        torch.cuda.empty_cache()


#: The variants of ``gncde_pair_probe`` (csrc/plane_probe.cu, flag D): K6a's
#: f32 sweep with one part of its work dropped.
K6A_ABLATION = {"full": 0, "no_mma": 1, "no_form": 2, "no_plane_copies": 4,
                "no_vector_copies": 8, "copies_only": 3, "loop_only": 15,
                "row_pass_only": 16, "col_pass_only": 32}


def k6a_ablation_lines(cs, torch):
    """K6a on f32 planes at genre-H128 and trade-H512: the device ms of each
    :data:`K6A_ABLATION` variant (the sweep kernel and the parts' sum)."""
    import ctypes

    from gncde_tpu_torch.ops import _build
    from gncde_tpu_torch.ops import tiled as tt

    fn = _build.load("plane_probe").gncde_pair_probe
    P, I = _build.P, _build.I
    fn.argtypes = [P, P, I, I, P, P, P, I, I, P, P, P, I, I, P]
    fn.restype = ctypes.c_int
    for label in ("genre-H128", "trade-H512"):
        s = PAIR_SHAPES[label]
        n, H, B = s["n"], s["H"], s["B"]
        x = cs.make_pair_inputs(torch, n, H, B)
        S = tt.mma_splits(B, n, n, H)
        buf = torch.empty((1 + (S if S > 1 else 0)) * 2 * B * n * H, device="cuda")
        line = {"kernel": "K6a-ablation", "shape": label, **s, "splits": S}
        for name, drop in K6A_ABLATION.items():
            def call(drop=drop):
                _build.check(fn(x["A"].data_ptr(), x["dA"].data_ptr(), n, n,
                                x["cvec"].data_ptr(), x["Mk"].data_ptr(), x["Mi"].data_ptr(),
                                B, H, buf.data_ptr(), buf[B * n * H:].data_ptr(),
                                buf[2 * B * n * H:].data_ptr() if S > 1 else None, S, drop,
                                _build.stream()), "K6a probe")
            line[f"{name}_device_ms"] = cs.device_ms(torch, call)[0]
        cs.emit(line)
        del x, buf
        torch.cuda.empty_cache()


def megakernel_lines(cs, torch, names, saved):
    """K1, K2, K1d, K2d at the flagship, trade and n=640 shapes and K11 at
    the step shapes: wrapper ms beside device ms, and each launch's device
    ms in launch order (K1: prep, layer 1 .. L; K2: prep, the recompute's
    layers 1 .. L-1, the reverse sweep's layers L .. 1, the reduction).
    K1 and K1d also get the row pass's plan, the products' yardstick
    (:func:`chip_smoke.k1_yardstick`: per layer one cuBLAS f32 bmm on C
    formed beforehand; not one call for K1's function) and, where the
    checkout caches its plan arrays (``_plan_array``), the wrapper's ms with
    the plan array rebuilt on every call, as it was before the cache, and
    the host microseconds of one plan array, rebuilt and cached."""
    from gncde_tpu_torch.ops import fused_step as tfs
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import megakernel_bwd as mkb
    from gncde_tpu_torch.solve.tableaus import get_tableau

    for name in ("K1", "K2", "K1d", "K2d"):
        if name not in names:
            continue
        nbasis = 11 if name.endswith("d") else 8
        for label, s in {**{k: cs.SHAPES[k] for k in ("flagship", "trade")},
                         **cs.K1_EDGE}.items():
            planes, idx, tau, Z, layers, G = cs.make_inputs(torch, **s, nbasis=nbasis)
            yardstick = yname = None
            extra = {}
            if name.startswith("K1"):
                kernel = lambda: (mk.megakernel_vf_eval(planes, idx, tau, Z, layers),)  # noqa: E731
                plain = lambda: (mk.plain_vf_eval(planes, idx, tau, Z, layers),)  # noqa: E731
                bms, by = cs.k1_bound(s)
                trace = {}
                mk.megakernel_vf_eval(planes, idx, tau, Z, layers, trace=trace)
                yardstick = cs.k1_yardstick(torch, planes, idx, tau, layers, trace["M"])
                yname = "yardstick_bmm_per_layer_ms"
                saved[f"{name}-M/{label}"] = [m.cpu() for m in trace["M"]]
                extra["plan"] = cs.k1_row_plans(s)
                cached = getattr(mk, "_plan_array", None)
                if cached is not None:
                    try:
                        mk._plan_array = cached.__wrapped__
                        extra["ms_plan_rebuilt_each_call"] = cs.time_ms(torch, kernel)
                        extra["plan_array_host_us_rebuilt"] = host_us(
                            lambda: mk.plan_array(s["n"], s["B"], layers))
                    finally:
                        mk._plan_array = cached
                    extra["plan_array_host_us_cached"] = host_us(
                        lambda: mk.plan_array(s["n"], s["B"], layers))
            else:
                kernel = lambda: mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, False)[1:2]  # noqa: E731
                plain = lambda: mkb.plain_vf_bwd(planes, idx, tau, Z, layers, G, False)[1:2]  # noqa: E731
                bms, by = cs.k2_bound(s)
                trace = {}
                mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, False, trace=trace)
                saved[f"{name}-recompute-M/{label}"] = [m.cpu() for m in trace["M"]]
                yardstick = cs.k2_yardstick(torch, planes, idx, tau, layers, G, trace)
                yname = "yardstick_two_bmm_per_layer_ms"
                extra["plan"] = sweep_plans(s)
            extra["launch_device_ms"] = cs.launch_device_ms(torch, kernel)
            line_of(cs, torch, name, label, s, kernel(), plain(), kernel, plain, bms, by,
                    yardstick, yname, saved=saved, extra=extra)
            del planes, Z, layers, G
            torch.cuda.empty_cache()
    for name in ("K1bf", "K1dbf"):  # the bf16 row pass (outputs kept for --compare)
        if name not in names:
            continue
        nbasis = 11 if name == "K1dbf" else 8
        for label in ("flagship", "trade"):
            s = cs.SHAPES[label]
            planes, idx, tau, Z, layers, _ = cs.make_inputs(torch, **s, nbasis=nbasis)
            planes = tuple(p.to(torch.bfloat16) for p in planes)
            kernel = lambda: (mk.megakernel_vf_eval(planes, idx, tau, Z, layers, True),)  # noqa: E731
            plain = lambda: (mk.plain_vf_eval_bf16(planes, idx, tau, Z, layers),)  # noqa: E731
            trace = {}
            mk.megakernel_vf_eval(planes, idx, tau, Z, layers, True, trace=trace)
            saved[f"{name}-M/{label}"] = [m.cpu() for m in trace["M"]]
            extra = {"plan": cs.k1_row_plans(s, bf16=True),
                     "launch_device_ms": cs.launch_device_ms(torch, kernel)}
            line_of(cs, torch, name, label, s, kernel(), plain(), kernel, plain,
                    *cs.k1_bound(s, True),
                    cs.k1_bf16_yardstick(torch, planes, idx, tau, layers, trace["M"]),
                    "yardstick_bf16_bmm_per_layer_ms", saved=saved, extra=extra)
            del planes, Z, layers
            torch.cuda.empty_cache()
    for name in ("K11", "K11d", "K11bf", "K11dbf"):
        if name not in names:
            continue
        tab = get_tableau("tsit5")
        bf, nbasis = name.endswith("bf"), 11 if name.startswith("K11d") else 8
        for label, s in cs.STEP_SHAPES.items():
            planes, ts, t, y, h, f0, layers = cs.make_step_inputs(torch, **s, nbasis=nbasis)
            if bf:
                planes = tuple(p.to(torch.bfloat16) for p in planes)
            kernel = lambda: tfs.fused_step_call(planes, ts, t, y, h, f0, layers, tab, bf)[:3]  # noqa: E731
            plain = lambda: tfs._step_reference(planes, ts, t, y, h, f0, layers, tab, bf)[:3]  # noqa: E731
            # The step's own kernel (one launch a call at these shapes).
            extra = {"step_kernel_device_ms": cs.named_device_ms(torch, kernel, r"\bfs::step", 1)}
            if bf:  # forward + backward (one K2bf a stage): what K2bf's sweep moves
                extra.update(fwd_bwd_times(cs, torch, tab, nbasis, planes, ts, t, y, h, f0,
                                           layers))
            # What K11 must beat: six K1 (K1d; bf16 K1bf) launches and the
            # stage glue.
            extra.update(per_stage_route(cs, torch, lambda: tfs._step_reference(
                planes, ts, t, y, h, f0, layers, tab, bf,
                stage=lambda *a: mk.megakernel_vf_eval(*a, bf16=bf))[:3], len(layers)))
            extra["plan"] = step_plans(s, bf)
            line_of(cs, torch, name, label, s, kernel(), plain(), kernel, plain,
                    *cs.step_bound(s["n"], s["B"], s["widths"], 6, bf),
                    saved=saved, extra=extra)
            del planes, y, f0, layers
            torch.cuda.empty_cache()


def fwd_bwd_times(cs, torch, tab, nbasis, planes, ts, t, y, h, f0, layers):
    """The bf16 fused step forward and backward (``FusedRKStep``: one K11bf
    launch, then one K2bf a stage) on the gradients of sum(y1 W0 + err W1
    + f1 W2), as ``chip_smoke.check_k11`` takes them: wrapper ms, device
    ms (by name), and the device ms of the backward's K2bf launches alone
    (the kernels of namespace ``mk``)."""
    import numpy as np

    from gncde_tpu_torch.ops import fused_step as tfs

    flat = [p for lp in layers for p in
            (lp["norm_w"], lp["norm_b"], lp["W"], lp["lin_b"], *lp["basis"])]
    rng = np.random.default_rng(1)
    W = [torch.tensor(rng.normal(size=y.shape).astype(np.float32), device=y.device)
         for _ in range(3)]

    def fwd_bwd():
        leaves = [x.detach().clone().requires_grad_(True) for x in (y, f0, *flat)]
        outs = tfs.FusedRKStep.apply(tab, nbasis, True, ts, t, leaves[0], h, leaves[1],
                                     *planes, *leaves[2:])
        torch.autograd.backward(outs[:3], W)
        return [x.grad for x in leaves]

    try:
        ms, dev, by_name = time_both(cs, torch, fwd_bwd)
    except RuntimeError as e:  # a graph capture of autograd may be refused
        ms, dev, by_name = cs.time_ms(torch, fwd_bwd), None, {"not measured": str(e)[:80]}
    return {"fwd_bwd_ms": ms, "fwd_bwd_device_ms": dev,
            "fwd_bwd_mk_device_ms": sum(v for k, v in by_name.items()
                                        if re.search(r"\bmk::", k)) if dev is not None else None,
            "fwd_bwd_device_by_name": by_name}


def step_plans(s, bf16=False):
    """K11's stage plans at shape ``s`` (``bf16``: K11bf's) from the timed
    checkout's ``ops.fused_step``, or None where that checkout has none (no
    ``step_plans``, or one without ``bf16``)."""
    import inspect

    from gncde_tpu_torch.ops import fused_step as tfs

    plans = getattr(tfs, "step_plans", None)
    if plans is None or (bf16 and "bf16" not in inspect.signature(plans).parameters):
        return None
    kw = {"bf16": True} if bf16 else {}
    return [p._asdict() for p in plans(s["n"], s["B"], s["widths"], **kw)]


def per_stage_route(cs, torch, route, L):
    """The per-stage route of one step at K11's inputs (six K1, K1d, K1bf or
    K1dbf launches on the same stage inputs and the torch glue between them):
    its device ms, and the device ms of its 6 (1 + L) K1 launches alone
    (the kernels of namespace ``mk``)."""
    dev, by_name = time_both(cs, torch, route)[1:]
    return {"per_stage_route_device_ms": dev,
            "per_stage_k1_device_ms": cs.named_device_ms(torch, route, r"\bmk::", 6 * (1 + L)),
            "per_stage_route_device_by_name": by_name}


def bf16_bwd_lines(cs, torch, names, saved):
    """K2bf and K2dbf at the flagship, trade and n=640 shapes on bf16 planes:
    the wrapper and device ms (their error is the free-running one against
    the plain bf16 version; chip_smoke.py phase 21 holds them layer by
    layer), each launch's device ms, the sweep's plan and the yardstick."""
    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    for name in ("K2bf", "K2dbf"):
        if name not in names:
            continue
        for label, s in {**{k: cs.SHAPES[k] for k in ("flagship", "trade")},
                         **cs.K1_EDGE}.items():
            planes, idx, tau, Z, layers, G = cs.make_inputs(
                torch, **s, nbasis=11 if name == "K2dbf" else 8)
            planes = tuple(p.to(torch.bfloat16) for p in planes)
            kernel = lambda: mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, False,  # noqa: E731
                                                   True)[1:2]
            plain = lambda: mkb.plain_vf_bwd_bf16(planes, idx, tau, Z, layers, G, False)[1:2]  # noqa: E731
            trace = {}
            mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, False, True, trace=trace)
            saved[f"{name}-recompute-M/{label}"] = [m.cpu() for m in trace["M"]]
            extra = {"plan": sweep_plans(s, False, True),
                     "launch_device_ms": cs.launch_device_ms(torch, kernel)}
            line_of(cs, torch, name, label, s, kernel(), plain(), kernel, plain,
                    *cs.k2_bound(s, True),
                    cs.k2_yardstick(torch, planes, idx, tau, layers, G, trace, True),
                    "yardstick_two_bf16_bmm_per_layer_ms", saved=saved, extra=extra)
            del planes, Z, layers, G
            torch.cuda.empty_cache()


#: K6b's and K7's shapes: genre-H128 (phases 9, 24) and trade-H512 (phases
#: 23, 25); K7 does not depend on H.
K6B_SHAPES = ("genre-H128", "trade-H512")


def enc_idx_lines(cs, torch, names, saved):
    """K6b, K6b-bf (bf16 planes and vectors), K7 and K7bf (bf16 output) at
    :data:`K6B_SHAPES`, and K12, K13 at phase 14's apply shapes: wrapper
    and device ms beside their plain versions and bounds (chip_smoke.py
    phases 8, 14 and 22 give only their wrapper ms)."""
    import numpy as np

    from gncde_tpu_torch.ops import fused_basis as tfb
    from gncde_tpu_torch.ops import modulate as tmod
    from gncde_tpu_torch.ops import pair as tp
    from gncde_tpu_torch.ops import pipeline as tpl

    bf = torch.bfloat16
    for label in K6B_SHAPES:
        s = PAIR_SHAPES[label]
        n, H, B = s["n"], s["H"], s["B"]
        x = cs.make_pair_inputs(torch, n, H, B)
        ma, md = x["mlps"]
        for name in ("K6b", "K6b-bf"):
            if name not in names:
                continue
            low = name == "K6b-bf"
            args = tuple(x[k].to(bf) if low else x[k]
                         for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
            kernel = lambda: (tp.pair_dw_call(*args),)  # noqa: E731
            plain = lambda: (tp.plain_pair_dw(*args),)  # noqa: E731
            sizes = dict(plane_bytes=2, vec_bytes=2) if low else {}
            plan = getattr(tp, "pair_dw_plan", None)  # None in a checkout before it
            with torch.no_grad():
                lib = cs.k6b_library(torch, *args)
                l_ms, l_dev, _ = time_both(cs, torch, lib)
                line_of(cs, torch, name, label, s, kernel(), plain(), kernel, plain,
                        *cs.pair_bound(name, n, H, B, **sizes), cs.k6b_yardstick(torch, *args),
                        "yardstick_bmm_and_multiply_sum_ms", saved,
                        {"plan": plan and plan(B, n, n, H)._asdict(), "library_einsum_ms": l_ms,
                         "library_device_ms": l_dev})
        for name in ("K7", "K7bf"):
            if name not in names:
                continue
            out = bf if name == "K7bf" else torch.float32
            kernel = lambda: tmod.modulate_pair(x["A"], x["dA"], ma, md, x["emb"], out)  # noqa: E731
            plain = lambda: tmod.plain_modulate_pair(x["A"], x["dA"], ma, md, x["emb"], out)  # noqa: E731
            sizes = dict(plane_bytes=2) if name == "K7bf" else {}
            with torch.no_grad():
                line_of(cs, torch, name, label, s, kernel(), plain(), kernel, plain,
                        *cs.pair_bound(name, n, H, B, **sizes), saved=saved)
        del x
        torch.cuda.empty_cache()
    for label, s in cs.APPLY_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        rng = np.random.default_rng(2)
        f = lambda *shape, sc=1.0: torch.tensor(  # noqa: E731
            (sc * rng.normal(size=shape)).astype(np.float32), device="cuda")
        A, dA, M = f(B, n, n, sc=0.1), f(B, n, n, sc=0.1), f(B, n, H)
        dvec, u, sv, w, q = f(B, n), f(B, n), f(B, H), f(B, H), f(2, 2)
        calls = {
            "K12": (lambda: (tfb._pallas_forward(A, dA, M, q, dvec, u, sv, w),),
                    lambda: (tfb.plain_pallas_forward(A, dA, M, q, dvec, u, sv, w),)),
            "K13": (lambda: (tpl.fused_conv_stream(A, dA, M, dvec, u, sv, w, q),),
                    lambda: (tpl.plain_conv_stream(A, dA, M, dvec, u, sv, w, q),)),
        }
        for name, (kernel, plain) in calls.items():
            if name in names:
                with torch.no_grad():
                    line_of(cs, torch, name, label, s, kernel(), plain(), kernel, plain,
                            *cs.apply_bound(n, H, B), saved=saved)
        torch.cuda.empty_cache()


def sparse_cases(cs, torch, cache):
    """Phase 10's three sparse shapes, made on demand."""
    sc = cs.SCALED
    return {"flagship": lambda: cs.flagship_sparse_inputs(torch, cache),
            "scaled": lambda: cs.scaled_sparse_inputs(torch, sc["n"], sc["bw"], sc["bs"],
                                                      sc["H"]),
            "odd": lambda: cs.odd_sparse_inputs(torch)}


def k8_lines(cs, torch, saved):
    """K8 at phase 10's shapes beside cuSPARSE's ``BSR @ M`` (the batch as
    one block-diagonal matrix), both timed both ways; the launch plan where
    the checkout's K8 has one (``ops.bcsr.spmm_plan``)."""
    from gncde_tpu_torch.ops import bcsr as tb

    plan = getattr(tb, "spmm_plan", None)
    with tempfile.TemporaryDirectory() as cache:
        for label, make in sparse_cases(cs, torch, cache).items():
            x = make()
            mat = tb.BCSR(x["idx"], x["blocks"], x["n"])
            kernel = lambda: (tb.bcsr_spmm(mat, x["M"]),)  # noqa: E731
            plain = lambda: (tb.bcsr_spmm_plain(mat, x["M"]),)  # noqa: E731
            s = {k: x[k] for k in ("n", "bs", "H", "B")}
            s["kb"] = x["idx"].shape[-1]
            extra = {}
            if plan is not None:
                B = x["M"].shape[0] if x["M"].dim() == 3 else 1
                extra["plan"] = plan(B, x["idx"].shape[-2], x["bs"], x["H"])._asdict()
            line_of(cs, torch, "K8", label, s, kernel(), plain(), kernel, plain,
                    *cs.sparse_bound("K8", x), cs.sparse_library_calls(torch, x)["K8"],
                    "library_bsr_matmul_ms", saved, extra)
            del x, mat
            torch.cuda.empty_cache()


#: K8's ablation (``gncde_bcsr_spmm_probe``, csrc/bcsr.cu SpmmProbe bits).
K8_ABLATION = {"full": 0, "no_block_copies": 1, "no_m_copies": 2, "no_products": 4,
               "products_only": 3, "skeleton": 7}
#: The f32 row pass's design probes (``gncde_mk_fwd_probe`` in csrc/row_probe.cu,
#: csrc/megakernel_common.cuh RowProbe bits), every row pass of an eval
#: launched with the same bits: parts of the work dropped, or (``tf32_products``)
#: the products as 3xTF32 ``mma.sync`` in place of the f32 FMA loop. ``full``
#: is the main path's kernel through its own entry point.
K1_ABLATION = {"full": 0, "no_plane_reads": 1, "no_forming": 2, "no_products": 4,
               "no_m_copies": 8, "no_column_sums": 16, "no_next_transform": 32,
               "copies_only": 2 | 4 | 16 | 32, "skeleton": 63, "tf32_products": 64}


def k8_probe_call(torch, mat, M, probe):
    """One K8 launch with the ablation bits ``probe`` (the wrapper's
    operands, plan and output)."""
    import ctypes

    from gncde_tpu_torch.ops import _build
    from gncde_tpu_torch.ops import bcsr as tb
    from gncde_tpu_torch.ops.ell_spmm import batch_of, operand

    fn = _build.load("bcsr").gncde_bcsr_spmm_probe
    P, L, I = _build.P, _build.L, _build.I
    fn.argtypes = [P, L, P, L, P, L, P] + [I] * 8 + [P]
    fn.restype = ctypes.c_int
    bs, nb, kb = mat.block_size, mat.nb, mat.kb
    n, H = M.shape[-2:]
    Bk = batch_of((mat.block_idx, 2), (mat.blocks, 4), (M, 2)) or 1
    idx, idx_bs = operand(mat.block_idx, 2, Bk)
    blk, blk_bs = operand(mat.blocks, 4, Bk)
    Mc, m_bs = operand(M, 2, Bk)
    out = torch.empty((Bk, n, H), device=M.device)
    plan = tb.spmm_plan(Bk, nb, bs, H)
    return lambda: _build.check(fn(
        _build.ptr(idx), idx_bs, _build.ptr(blk), blk_bs, _build.ptr(Mc), m_bs,
        _build.ptr(out), Bk, nb, kb, bs, n, H, plan.rb, probe, _build.stream()),
        "K8 probe")


def k8_ablation_lines(cs, torch):
    """K8 at the flagship and n=32768 shapes: the device ms of each
    :data:`K8_ABLATION` variant, and of the default kernel under each strip
    height (``spmm_plan`` forced)."""
    from gncde_tpu_torch.ops import bcsr as tb

    with tempfile.TemporaryDirectory() as cache:
        cases = sparse_cases(cs, torch, cache)
        for label in ("flagship", "scaled"):
            x = cases[label]()
            mat = tb.BCSR(x["idx"], x["blocks"], x["n"])
            line = {"kernel": "K8-ablation", "shape": label}
            for name, bits in K8_ABLATION.items():
                line[f"{name}_device_ms"] = cs.device_ms(torch, k8_probe_call(
                    torch, mat, x["M"], bits))[0]
            plan = tb.spmm_plan
            try:
                for rb in (8, 16, 32):
                    tb.spmm_plan = lambda *a, rb=rb: plan(*a)._replace(rb=rb)
                    line[f"rb{rb}_device_ms"] = cs.device_ms(
                        torch, lambda: tb.bcsr_spmm(mat, x["M"]))[0]
            finally:
                tb.spmm_plan = plan
            cs.emit(line)
            del x, mat
            torch.cuda.empty_cache()


#: The bf16 row pass's probes (``gncde_mk_fwd_bf16_probe``, the RowProbe
#: bits of its bf16 instantiation; ``no_products`` also drops the tiles'
#: rounding to bf16).
K1BF_ABLATION = {k: v for k, v in K1_ABLATION.items() if k != "tf32_products"}


def k1_probe_call(torch, planes, idx, tau, Z, layers, probe, bf16=False):
    """``(call, out)``: one K1 eval (f32 planes, undirected; ``bf16``: K1bf
    on bf16 planes) with every row pass launched with the probe bits
    ``probe`` (the wrapper's operands, plans and buffers), and the buffer it
    writes the output to; bits 0 are the main path's wrapper itself."""
    import ctypes

    from gncde_tpu_torch.ops import _build
    from gncde_tpu_torch.ops import megakernel as mk

    if probe == 0:
        out = [None]

        def wrapper():
            out[0] = mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16)
        wrapper()
        return wrapper, out
    lib = _build.load("row_probe")
    fn = lib.gncde_mk_fwd_bf16_probe if bf16 else lib.gncde_mk_fwd_probe
    P, L, I = _build.P, _build.L, _build.I
    fn.argtypes = [P, P, P, P, L, P, P, P, I, I, I, P, P, P, I, P, P, I, P, I, P]
    fn.restype = ctypes.c_int
    nbasis = mk.basis_size(layers)
    B, n, _ = Z.shape
    bstride, idx32, tau32, dims, ptrs, keep = mk.launch_args(planes, idx, tau, layers)
    plan = mk.plan_array(n, B, layers)
    ldm = mk.scratch_width(layers)
    stats = torch.empty((B, mk.NSTAT, n), device=Z.device)
    mbuf = torch.empty((len(layers), B, n, ldm), device=Z.device)
    out = torch.empty((B, n, layers[-1]["W"].shape[0]), device=Z.device)

    def call():
        _ = keep  # the parameter copies the pointers point into
        _build.check(fn(*[_build.ptr(p) for p in planes], bstride, _build.ptr(idx32),
                        _build.ptr(tau32), _build.ptr(Z), B, n, len(layers),
                        ctypes.cast(dims, P), ctypes.cast(ptrs, P), ctypes.cast(plan, P),
                        int(nbasis == mk.NBASIS_DIRECTED), _build.ptr(stats),
                        _build.ptr(mbuf), ldm, _build.ptr(out), probe, _build.stream()),
                     "K1 probe")
    call()
    return call, [out]


def k1_ablation_lines(cs, torch, bf16=False):
    """K1 (``bf16``: K1bf on bf16 planes) at the flagship, trade and n=640
    shapes: the device ms of each :data:`K1_ABLATION` (:data:`K1BF_ABLATION`)
    variant (in total and per launch), the 3xTF32 variant's error against
    the plain version beside the main path's, and the default kernel's
    device ms under each CTA height (``ROW_BMS`` forced)."""
    from gncde_tpu_torch.ops import megakernel as mk

    name, variants = ("K1bf", K1BF_ABLATION) if bf16 else ("K1", K1_ABLATION)
    for nbasis in (8,):
        for label, s in {**{k: cs.SHAPES[k] for k in ("flagship", "trade")},
                         **cs.K1_EDGE}.items():
            planes, idx, tau, Z, layers, _ = cs.make_inputs(torch, **s, nbasis=nbasis)
            if bf16:
                planes = tuple(p.to(torch.bfloat16) for p in planes)
                ref = mk.plain_vf_eval_bf16(planes, idx, tau, Z, layers)
            else:
                ref = mk.plain_vf_eval(planes, idx, tau, Z, layers)
            line = {"kernel": f"{name}-ablation", "shape": label}
            for var, bits in variants.items():
                call, out = k1_probe_call(torch, planes, idx, tau, Z, layers, bits, bf16)
                if var in ("full", "tf32_products"):
                    torch.cuda.synchronize()
                    line[f"{var}_rel_err"] = cs.rel_err(torch, out[0], ref)[0]
                line[f"{var}_device_ms"] = cs.device_ms(torch, call)[0]
                launches = cs.launch_device_ms(torch, call)
                line[f"{var}_launch_ms"] = launches and [round(x["ms"], 5) for x in launches]
            bms = mk.ROW_BMS
            try:
                for bm in (16, 8, 4):
                    mk.ROW_BMS = (bm,)
                    line[f"bm{bm}_device_ms"] = cs.device_ms(
                        torch, lambda: mk.megakernel_vf_eval(planes, idx, tau, Z, layers,
                                                             bf16))[0]
            finally:
                mk.ROW_BMS = bms
            cs.emit(line)
            del planes, Z, layers
            torch.cuda.empty_cache()


#: K2's reverse-sweep probes (``gncde_mk_bwd_probe`` in csrc/bwd_probe.cu,
#: csrc/bwd_sweep.cuh BwdProbe bits), every sweep launch of a call with the
#: same bits, undirected, without dtau. ``full`` is the main path's kernel
#: through its own entry point.
K2_ABLATION = {"full": 0, "no_plane_reads": 1, "no_forming": 2, "no_products": 4,
               "no_ring": 8, "no_column_sums": 16, "ring_only": 2 | 4 | 16, "skeleton": 31}


def k2_probe_call(torch, planes, idx, tau, Z, layers, G, probe):
    """One K2 call (f32 planes, undirected, no dtau) with every sweep launch
    on the probe bits ``probe`` (the wrapper's operands, plans and buffers);
    bits 0 are the main path's wrapper itself."""
    import ctypes

    from gncde_tpu_torch.ops import _build
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    if probe == 0:
        return lambda: mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, False)
    fn = _build.load("bwd_probe").gncde_mk_bwd_probe
    P, L, I = _build.P, _build.L, _build.I
    fn.argtypes = [P, P, P, P, L, P, P, P, P, I, I, I, P, P, P, P, P, P, P, P, I, P, P, L, P, L,
                   I, P, I, P]
    fn.restype = ctypes.c_int
    B, n, hin0 = Z.shape
    nl = len(layers)
    bstride, idx32, tau32, dims, ptrs, keep = mk.launch_args(planes, idx, tau, layers)
    lay = mkb.bwd_layout(n, B, layers, 8, False)
    ptot = sum(2 * hi + ho * hi + ho + 17 for hi, ho in mkb._layer_sizes(layers))
    ldm = mk.scratch_width(layers)
    f32 = dict(device=Z.device)
    stats = torch.empty((B, mk.NSTAT, n), **f32)
    bufs = [torch.empty((nl, B, n, ldm), **f32) for _ in range(3)]
    dZ = torch.empty((B, n, hin0), **f32)
    part = torch.empty((lay.part_floats,), **f32)
    work = torch.empty((max(lay.work_floats, 1),), **f32)
    red = torch.empty((B, ptot), **f32)
    plan = mk.plan_array(n, B, layers)

    def call():
        _ = keep  # the parameter copies the pointers point into
        _build.check(fn(*[_build.ptr(p) for p in planes], bstride, _build.ptr(idx32),
                        _build.ptr(tau32), _build.ptr(Z), _build.ptr(G), B, n, nl,
                        ctypes.cast(dims, P), ctypes.cast(ptrs, P), ctypes.cast(plan, P),
                        ctypes.cast(lay.plans, P), _build.ptr(stats),
                        *[_build.ptr(x) for x in bufs], ldm, _build.ptr(dZ),
                        _build.ptr(part), part.numel(), _build.ptr(work), work.numel(), ptot,
                        _build.ptr(red), probe, _build.stream()), "K2 probe")
    return call


def k2_ablation_lines(cs, torch):
    """K2 at the flagship, trade and n=640 shapes (undirected, no dtau): the
    device ms of each :data:`K2_ABLATION` variant, in total and per launch,
    and of the main path's kernel on its own plans and under each sweep CTA
    height (``BWD_BMS`` forced), without and with dtau."""
    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    for label, s in {**{k: cs.SHAPES[k] for k in ("flagship", "trade")},
                     **cs.K1_EDGE}.items():
        planes, idx, tau, Z, layers, G = cs.make_inputs(torch, **s)
        line = {"kernel": "K2-ablation", "shape": label,
                "plan": [p._asdict() for p in mkb.bwd_row_plans(s["n"], s["B"], s["widths"],
                                                                 False)]}
        for var, bits in K2_ABLATION.items():
            call = k2_probe_call(torch, planes, idx, tau, Z, layers, G, bits)
            call()
            line[f"{var}_device_ms"] = cs.device_ms(torch, call)[0]
            launches = cs.launch_device_ms(torch, call)
            line[f"{var}_launch_ms"] = launches and [round(x["ms"], 5) for x in launches]
        bms = mkb.BWD_BMS
        try:
            for bm in (None, 16, 8, 4):
                mkb.BWD_BMS = bms if bm is None else (bm,)
                for need_tau in (False, True):
                    key = ("default" if bm is None else f"bm{bm}") + ("_tau" if need_tau else "")
                    try:  # None where no plan of this height fits the layer
                        mkb.bwd_row_plans(s["n"], s["B"], s["widths"], need_tau)
                    except ValueError:
                        line[f"{key}_device_ms"] = None
                        continue
                    line[f"{key}_device_ms"] = cs.device_ms(
                        torch, lambda: mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G,
                                                             need_tau))[0]
        finally:
            mkb.BWD_BMS = bms
        cs.emit(line)
        del planes, Z, layers, G
        torch.cuda.empty_cache()


#: K2bf's reverse-sweep probes (``gncde_mk_bwd_bf16_probe`` in
#: csrc/bwd_bf_probe.cu, the same BwdProbe bits; ``no_products`` also drops
#: the tiles' rounding to bf16), undirected, without dtau. ``full`` is the
#: main path's kernel through its own entry point.
K2BF_ABLATION = {"full": 0, "no_plane_reads": 1, "no_forming": 2, "no_products": 4,
                 "no_ring": 8, "no_column_sums": 16, "skeleton": 31}


def k2bf_probe_call(torch, planes, idx, tau, Z, layers, G, probe):
    """One K2bf call (bf16 planes, undirected, no dtau) with every sweep
    launch on the probe bits ``probe``; bits 0 are the main path's wrapper."""
    import ctypes

    from gncde_tpu_torch.ops import _build
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    if probe == 0:
        return lambda: mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, False, True)
    fn = _build.load("bwd_bf_probe").gncde_mk_bwd_bf16_probe
    P, L, I = _build.P, _build.L, _build.I
    fn.argtypes = [P, P, P, P, L, P, P, P, P, I, I, I, P, P, P, P, P, P, P, I, P, P, L, P, L,
                   I, P, I, P]
    fn.restype = ctypes.c_int
    B, n, hin0 = Z.shape
    nl = len(layers)
    bstride, idx32, tau32, dims, ptrs, keep = mk.launch_args(planes, idx, tau, layers)
    lay = mkb.bwd_layout(n, B, layers, 8, False, True)
    ptot = sum(2 * hi + ho * hi + ho + 17 for hi, ho in mkb._layer_sizes(layers))
    ldm = mk.scratch_width(layers)
    f32 = dict(device=Z.device)
    stats = torch.empty((B, mk.NSTAT, n), **f32)
    bufs = [torch.empty((nl, B, n, ldm), **f32) for _ in range(3)]
    dZ = torch.empty((B, n, hin0), **f32)
    part = torch.empty((lay.part_floats,), **f32)
    work = torch.empty((max(lay.work_floats, 1),), **f32)
    red = torch.empty((B, ptot), **f32)

    def call():
        _ = keep  # the parameter copies the pointers point into
        _build.check(fn(*[_build.ptr(p) for p in planes], bstride, _build.ptr(idx32),
                        _build.ptr(tau32), _build.ptr(Z), _build.ptr(G), B, n, nl,
                        ctypes.cast(dims, P), ctypes.cast(ptrs, P), ctypes.cast(lay.plans, P),
                        _build.ptr(stats), *[_build.ptr(x) for x in bufs], ldm, _build.ptr(dZ),
                        _build.ptr(part), part.numel(), _build.ptr(work), work.numel(), ptot,
                        _build.ptr(red), probe, _build.stream()), "K2bf probe")
    return call


def k2bf_ablation_lines(cs, torch):
    """K2bf at the flagship, trade and n=640 shapes (undirected, no dtau): the
    device ms of each :data:`K2BF_ABLATION` variant, in total and per
    launch, and of the main path's kernel under each sweep CTA height
    (``BWD_BMS`` forced), without and with dtau."""
    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    for label, s in {**{k: cs.SHAPES[k] for k in ("flagship", "trade")},
                     **cs.K1_EDGE}.items():
        planes, idx, tau, Z, layers, G = cs.make_inputs(torch, **s)
        planes = tuple(p.to(torch.bfloat16) for p in planes)
        line = {"kernel": "K2bf-ablation", "shape": label,
                "plan": sweep_plans(s, False, True)}
        for var, bits in K2BF_ABLATION.items():
            call = k2bf_probe_call(torch, planes, idx, tau, Z, layers, G, bits)
            call()
            line[f"{var}_device_ms"] = cs.device_ms(torch, call)[0]
            launches = cs.launch_device_ms(torch, call)
            line[f"{var}_launch_ms"] = launches and [round(x["ms"], 5) for x in launches]
        bms = mkb.BWD_BMS
        try:
            for bm in (None, 16, 8, 4):
                mkb.BWD_BMS = bms if bm is None else (bm,)
                for need_tau in (False, True):
                    key = ("default" if bm is None else f"bm{bm}") + ("_tau" if need_tau else "")
                    try:  # None where no plan of this height fits the layer
                        mkb.bwd_row_plans(s["n"], s["B"], s["widths"], need_tau, bf16=True)
                    except ValueError:
                        line[f"{key}_device_ms"] = None
                        continue
                    line[f"{key}_device_ms"] = cs.device_ms(
                        torch, lambda: mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G,
                                                             need_tau, True))[0]
        finally:
            mkb.BWD_BMS = bms
        cs.emit(line)
        del planes, Z, layers, G
        torch.cuda.empty_cache()


#: K6b's probes (``gncde_pair_dw_probe``, csrc/plane_probe.cu DwDrop flags):
#: the kernel with its products, its vector copies or its plane reads
#: dropped; ``full`` is the main path's kernel.
K6B_ABLATION = {"full": 0, "no_mma": 1, "no_vector_copies": 2, "no_plane_reads": 4,
                "skeleton": 7}


def k6b_ablation_lines(cs, torch):
    """K6b and K6b-bf at genre-H128 and trade-H512 on their plan: the device
    ms of each :data:`K6B_ABLATION` variant (the kernel and the slots'
    sum)."""
    import ctypes

    from gncde_tpu_torch.ops import _build
    from gncde_tpu_torch.ops import pair as tp

    fn = _build.load("plane_probe").gncde_pair_dw_probe
    P, I = _build.P, _build.I
    fn.argtypes = [P, P, I, I, P, P, P, P, I, I, I, I, P, P, I, P]
    fn.restype = ctypes.c_int
    for label in K6B_SHAPES:
        s = PAIR_SHAPES[label]
        n, H, B = s["n"], s["H"], s["B"]
        x = cs.make_pair_inputs(torch, n, H, B)
        plan = tp.pair_dw_plan(B, n, n, H)
        part = torch.empty((B, plan.parts, 4), device="cuda")
        dw = torch.empty((B, 4), device="cuda")
        for bf16 in (False, True):
            dt = torch.bfloat16 if bf16 else torch.float32
            a = [x[k].to(dt) for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc")]
            line = {"kernel": "K6b-ablation", "shape": label, **s, "bf16": bf16,
                    "plan": plan._asdict()}
            for name, drop in K6B_ABLATION.items():
                def call(drop=drop):
                    _build.check(fn(a[0].data_ptr(), a[1].data_ptr(), n, n, a[2].data_ptr(),
                                    a[3].data_ptr(), a[4].data_ptr(), a[5].data_ptr(), B, H,
                                    int(bf16), plan.splits, part.data_ptr(), dw.data_ptr(),
                                    drop, _build.stream()), "K6b probe")
                line[f"{name}_device_ms"] = cs.device_ms(torch, call)[0]
            cs.emit(line)
        del x
        torch.cuda.empty_cache()


def k10_lines(cs, torch, saved):
    from gncde_tpu_torch.ops import ell_spmm as tell

    with tempfile.TemporaryDirectory() as cache:
        for label, make in sparse_cases(cs, torch, cache).items():
            x = make()
            kernel = lambda: tell.ell_spmm_call(x["indices"], x["values"], x["M"])  # noqa: E731
            got = kernel()
            saved[f"K10/{label}"] = [got.cpu()]
            ref = tell.plain_ell_spmm(x["indices"], x["values"], x["M"])
            lib = cs.sparse_library_calls(torch, x)["K10"]
            ms, dev, by = time_both(cs, torch, kernel)
            l_ms, l_dev, l_by = time_both(cs, torch, lib)
            bms, by_ = cs.sparse_bound("K10", x)
            cs.emit({"kernel": "K10", "shape": label,
                     **{k: x[k] for k in ("n", "H", "B")}, "K": x["indices"].shape[-1],
                     "rel_err": cs.rel_err(torch, got, ref)[0], "ms": ms, "device_ms": dev,
                     "device_by_name": by,
                     "plain_ms": cs.time_ms(torch, lambda: tell.plain_ell_spmm(
                         x["indices"], x["values"], x["M"])),
                     "bound_ms": bms, "bound_by": by_, "library_ms": l_ms,
                     "library_device_ms": l_dev, "library_device_by_name": l_by})
            del x
            torch.cuda.empty_cache()


def compare(dir1, dir2) -> int:
    """One JSON line: per saved kernel and shape, bitwise equal or not and
    the largest absolute difference of the two runs' outputs."""
    import torch

    a, b = (torch.load(Path(d) / "outputs.pt") for d in (dir1, dir2))
    out = {}
    for key in sorted(set(a) & set(b)):
        out[key] = {"bitwise": all(torch.equal(x, y) for x, y in zip(a[key], b[key])),
                    "max_abs_diff": max(float((x - y).abs().max())
                                        for x, y in zip(a[key], b[key]))}
    print(json.dumps({"compare": [dir1, dir2], **out}), flush=True)
    return 0


def kernel_lines(cs, torch, only, splits, saved):
    """The lines of every kernel in ``only``, each kernel's outputs kept in
    ``saved``."""
    if "K3" in only:
        k3_lines(cs, torch, splits, saved)
    if "K4" in only:
        k4_lines(cs, torch, saved, splits)
    if "K6a" in only:
        k6a_lines(cs, torch, saved, False, splits)
    if "K6a-bf" in only:
        k6a_lines(cs, torch, saved, True, splits)
    if "K6a-ablation" in only:
        k6a_ablation_lines(cs, torch)
    if "K8" in only:
        k8_lines(cs, torch, saved)
    if "K8-ablation" in only:
        k8_ablation_lines(cs, torch)
    if "K1-ablation" in only:
        k1_ablation_lines(cs, torch)
    if "K1bf-ablation" in only:
        k1_ablation_lines(cs, torch, bf16=True)
    if "K10" in only:
        k10_lines(cs, torch, saved)
    megakernel_lines(cs, torch, only, saved)
    bf16_bwd_lines(cs, torch, only, saved)
    enc_idx_lines(cs, torch, only, saved)
    if "K2-ablation" in only:
        k2_ablation_lines(cs, torch)
    if "K2bf-ablation" in only:
        k2bf_ablation_lines(cs, torch)
    if "K6b-ablation" in only:
        k6b_ablation_lines(cs, torch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="K3,K4,K6a,K6a-bf,K10",
                    help="comma-separated: K3, K4, K6a, K6a-bf, K8, K10, K1, K2, K1d, K2d, "
                         "K11, K11d, K1bf, K1dbf, K2bf, K2dbf, K11bf, K11dbf, K6b, K6b-bf, "
                         "K7, K7bf, K12, K13, K6a-ablation, K8-ablation, K1-ablation, "
                         "K1bf-ablation, K2-ablation, K2bf-ablation, K6b-ablation")
    ap.add_argument("--splits", default="",
                    help="K3, K4, K6a: split counts to time at the genre shapes, e.g. 1,2,4")
    ap.add_argument("--root", default=str(HERE), help="checkout whose gncde_tpu_torch runs")
    ap.add_argument("--save", help="directory to keep the kernels' outputs in")
    ap.add_argument("--compare", nargs=2, metavar="DIR", help="compare two saved runs")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = load_chip_smoke()
    torch = cs.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import gncde_tpu_torch

    only = args.only.split(",")
    splits = [int(s) for s in args.splits.split(",") if s]
    cs.emit({"root": str(root), "package": gncde_tpu_torch.__file__, "nvidia_smi": smi})
    saved = {}
    try:
        kernel_lines(cs, torch, only, splits, saved)
    finally:  # what ran is kept for --compare, even if a later line fails
        if args.save:
            Path(args.save).mkdir(parents=True, exist_ok=True)
            torch.save(saved, Path(args.save) / "outputs.pt")
    ptx = {}
    tiled = "|".join(p for k, p in (("K3", "fwd2"), ("K4", "bwd2"), ("K6a", "pair"),
                                     ("K6a-bf", "pair")) if k in only)
    if tiled:  # a parent checkout may still hold K4 and K6a in tiled.cu
        ptx["tiled"] = ptxas_lines(root, "tiled", tiled)
    if any(k in only for k in ("K4", "K6a", "K6a-bf", "K6b", "K6b-bf", "K6b-ablation")):
        ptx["plane_mma"] = ptxas_lines(root, "plane_mma", r".")
    if any(k in only for k in ("K6b", "K6b-bf")):  # a parent checkout's K6b
        ptx["tiled_pair_dw"] = ptxas_lines(root, "tiled", "pair_dw")
    for lib, ks in (("megakernel_fwd", ("K1", "K1d", "K1bf", "K1dbf")),
                    ("megakernel_bwd", ("K2", "K2d", "K2bf", "K2dbf")),
                    ("megakernel_bwd_bf", ("K2bf", "K2dbf")),
                    ("bwd_probe", ("K2-ablation",)),
                    ("bwd_bf_probe", ("K2bf-ablation",)),
                    ("plane_probe", ("K6a-ablation", "K6b-ablation")),
                    ("row_probe", ("K1-ablation", "K1bf-ablation")),
                    ("fused_step", ("K11", "K11d", "K11bf", "K11dbf"))):
        if any(k in only for k in ks):
            ptx[lib] = ptxas_lines(root, lib, r".")
    if "K8" in only:
        ptx["bcsr"] = ptxas_lines(root, "bcsr", r"spmm")
    if "K10" in only:
        ptx["ell_spmm"] = ptxas_lines(root, "ell_spmm", r"ell")
    cs.emit({"ptxas": ptx})
    return 0


if __name__ == "__main__":
    sys.exit(main())
