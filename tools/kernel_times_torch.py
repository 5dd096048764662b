"""Developer tool: time K3 (tiled fwd2) and K10 (ELL SpMM) of the PyTorch
port on a CUDA card, with and without their host work, and compare two
checkouts' kernels in one run. ``chip_smoke.py`` phases 6 and 10 give the
same times on every run; this tool adds what a redesign of these two
kernels needs beside them.

    python3 tools/kernel_times_torch.py [--only K3,K10] [--splits 1,2,4] [--root DIR]

At ``chip_smoke.py``'s shapes (K3: genre-H8, genre-H128 and odd, phase 6;
K10: flagship, scaled and odd, phase 10) it prints one JSON line per kernel
and shape:

* ``ms``: CUDA events over 20 back-to-back wrapper calls after 3 warm-ups
  (``chip_smoke.time_ms``, phase 6's and 10's figure). The host's work is
  inside: where the host is slower than the device, this times the host;
* ``device_ms``: the device time of 20 such calls, summed from a
  torch.profiler trace (``chip_smoke.device_ms``), and ``device_by_name``;
* ``plain_ms``, ``bound_ms``, ``bound_by`` as phases 6 and 10 compute them;
* the yardstick, timed both ways: K3's two cuBLAS bf16 products on B1 and B2
  formed beforehand (``yardstick_*``; two calls on pre-formed operands, not
  one call for K3's function), K10's ``A_csr @ M`` (``library_*``, with its
  cuSPARSE kernels' names);
* ``splits``: K3 at genre shapes with the reduce extent split in S parts
  (``ops.tiled.fwd2_splits`` replaced by the constant S for the run), where
  the checkout's K3 has that plan.

Then the ``ptxas -v`` lines (registers, spills, shared memory) of each
timed kernel's entry points, from ``build/gncde_tpu_torch/<lib>.ptxas.log``.

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


def time_both(cs, torch, fn):
    dev, by_name = cs.device_ms(torch, fn)
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


def k10_lines(cs, torch, saved):
    from gncde_tpu_torch.ops import ell_spmm as tell

    sc = cs.SCALED
    with tempfile.TemporaryDirectory() as cache:
        cases = {"flagship": lambda: cs.flagship_sparse_inputs(torch, cache),
                 "scaled": lambda: cs.scaled_sparse_inputs(torch, sc["n"], sc["bw"],
                                                           sc["bs"], sc["H"]),
                 "odd": lambda: cs.odd_sparse_inputs(torch)}
        for label, make in cases.items():
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="K3,K10", help="comma-separated: K3, K10")
    ap.add_argument("--splits", default="", help="K3: split counts to time, e.g. 1,2,4")
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
    if "K3" in only:
        k3_lines(cs, torch, splits, saved)
    if "K10" in only:
        k10_lines(cs, torch, saved)
    if args.save:
        Path(args.save).mkdir(parents=True, exist_ok=True)
        torch.save(saved, Path(args.save) / "outputs.pt")
    ptx = {}
    if "K3" in only:
        ptx["tiled"] = ptxas_lines(root, "tiled", r"fwd2")
    if "K10" in only:
        ptx["ell_spmm"] = ptxas_lines(root, "ell_spmm", r"ell")
    cs.emit({"ptxas": ptx})
    return 0


if __name__ == "__main__":
    sys.exit(main())
