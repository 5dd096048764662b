"""Times the megakernel design probes P1-P6 on the card::

    python -m gncde_tpu_torch.run.mk_probe            # every variant, n=400 H=32 L=3 B=16
    python -m gncde_tpu_torch.run.mk_probe --only P4,P5/v4mm --blocks 5
    python -m gncde_tpu_torch.run.mk_probe --device cpu --n 24 --batch 2 --evals 3

The probes' own setting (``benchmarks/mk_probe*.py``): a field of random
weights (n nodes, width H, L layers), T = 12 knots on [0, 1], a path
``uniform(B, T, n, n) * 0.1`` turned into Hermite coefficient stacks stored in
bf16, a state ``normal * 0.1``. Every variant of
:data:`gncde_tpu_torch.ops.mk_probe.VARIANTS` runs ``--evals`` chained evals
``y <- y + 1e-3 out`` at ``t = linspace(0.01, 0.99, evals)`` (P3 ``red*``
also form their reductions operand per eval, as ``mk_probe4.py`` does in its
scan; P2 ``fixedslice`` takes interval 3 of every element's stack, sliced
once); P6 runs ``--steps`` chained Tsit5 steps at ``h = 0.9 / steps`` from
``t = 0.02``. A block (one chain) is timed with CUDA events; the median of
``--blocks`` blocks is printed with its min-max band, per variant, in the
JAX scripts' words: ms per run, us per element-eval (P6: per element-step
too) and ``n^2 L`` edges per second, beside the relative distance of the
final state from P2 ``current``'s (the production K1bf). The last line is
one JSON object of every result. On the card unless ``--device cpu``;
there it runs the plain versions and times them on the host clock.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
import typing as tp

import torch

from ..interp.paths import backward_hermite_coefficients
from ..models.vector_fields import PermEquivGraphVectorField
from ..ops import megakernel as mk
from ..ops import mk_probe as mp
from ..ops.tiled import cubic_plane_reductions
from ..solve.tableaus import get_tableau


def make_case(n, H, L, B, T, device) -> tp.Dict[str, tp.Any]:
    """The probes' inputs on ``device``, made from seed 0: bf16 coefficient
    stacks (B, T-1, n, n), knots (B, T), the layer parameters, the state and
    the plane reductions P3 ``red`` weights."""
    gen = torch.Generator().manual_seed(0)
    vf = PermEquivGraphVectorField(H, H, H, L, 1, n, generator=gen)
    layers = [{k: v.detach().to(device) for k, v in lp.items()} for lp in mk.layer_params(vf)]
    ts = torch.linspace(0.0, 1.0, T).expand(B, T).contiguous().to(device)
    path = (torch.rand((B, T, n, n), generator=gen) * 0.1).to(device)
    planes = tuple(c.to(torch.bfloat16).contiguous()
                   for c in backward_hermite_coefficients(ts, path))
    del path
    y0 = (torch.randn((B, n, H), generator=gen) * 0.1).to(device)
    return dict(planes=planes, ts=ts, layers=layers, y0=y0,
                reductions=cubic_plane_reductions(planes), n=n, H=H, L=L, B=B, T=T)


def eval_chain(v: mp.Variant, case, evals: int) -> tp.Callable[[], torch.Tensor]:
    """One block of ``evals`` chained evals of an eval variant."""
    ts, B = case["ts"], case["B"]
    t = torch.linspace(0.01, 0.99, evals, device=ts.device)
    nodes = [mk.interval(ts, t[k].repeat(B)) for k in range(evals)]
    planes = case["planes"]
    if v.key == "P2/fixedslice":
        planes = tuple(p[:, 3:4].contiguous() for p in planes)
        nodes = [(torch.zeros_like(idx), tau) for idx, tau in nodes]

    def run():
        y = case["y0"]
        for idx, tau in nodes:
            kw = {}
            if v.needs_red:
                kw["rvec"] = mp.red_operand(planes, idx, tau, case["reductions"])
            y = y + 1e-3 * v(planes, idx, tau, y, case["layers"], **kw)
        return y
    return run


def step_chain(v: mp.Variant, case, steps: int) -> tp.Callable[[], torch.Tensor]:
    """One block of ``steps`` chained Tsit5 steps at the fixed h of
    ``mk_probe7.py`` (its first FSAL derivative one K1bf eval)."""
    tab = get_tableau("tsit5")
    ts, B = case["ts"], case["B"]
    h = torch.full((B,), 0.9 / steps, device=ts.device)
    t_grid = [torch.full((B,), 0.02 + k * 0.9 / steps, device=ts.device) for k in range(steps)]

    def run():
        y, layers = case["y0"], case["layers"]
        f = mk.megakernel_vf_eval(case["planes"], *mk.interval(ts, t_grid[0]), y, layers,
                                  bf16=True)
        for t in t_grid:
            y, _, f, _ = v(case["planes"], ts, t, y, h, f, layers, tab)
        return y
    return run


def time_blocks(fn, blocks: int, cuda: bool):
    """Seconds per block (after one warm-up block), and the last output."""
    out = fn()
    times = []
    for _ in range(blocks):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
    return times, out


def select(only: tp.Optional[str]) -> tp.List[mp.Variant]:
    """The variants named by ``--only`` (probes ``P4`` or keys ``P5/v4mm``;
    all without it)."""
    out = list(mp.VARIANTS.values())
    if only:
        want = [w.strip() for w in only.split(",") if w.strip()]
        out = [v for v in out if v.key in want or v.probe in want]
        if not out:
            raise SystemExit(f"--only {only!r} names no variant of {sorted(mp.VARIANTS)}")
    # P2 current (the production K1bf) first: the others report their distance to it.
    return sorted(out, key=lambda v: v.key != "P2/current")


def main(argv=None) -> tp.Dict[str, tp.Any]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    shape = mp.PROBE_SHAPE
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--n", type=int, default=shape["n"])
    parser.add_argument("--hidden", type=int, default=shape["H"])
    parser.add_argument("--layers", type=int, default=shape["L"])
    parser.add_argument("--batch", type=int, default=shape["B"])
    parser.add_argument("--evals", type=int, default=50)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--blocks", type=int, default=3)
    parser.add_argument("--only", default=None, help="comma-separated probes or keys")
    args = parser.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("mk_probe: no CUDA device visible (pass --device cpu for the "
                         "plain versions)")
    device = torch.device(args.device)
    n, H, L, B = args.n, args.hidden, args.layers, args.batch
    case = make_case(n, H, L, B, shape["T"], device)
    label = torch.cuda.get_device_name(0) if cuda else "cpu (plain versions, host clock)"
    print(f"device: {label}  n={n} H={H} L={L} B={B} T={shape['T']} evals={args.evals} "
          f"steps={args.steps} blocks={args.blocks}", flush=True)
    results, finals = {}, {}
    base = mp.VARIANTS["P2/current"]
    with torch.no_grad():
        for v in select(args.only):
            step = v.kind == "step"
            run = step_chain(v, case, args.steps) if step else eval_chain(v, case, args.evals)
            times, out = time_blocks(run, args.blocks, cuda)
            finals[v.key] = out
            dt = statistics.median(times)
            evals = B * (args.steps * 6 if step else args.evals)
            per_eval = dt / evals
            r = dict(ms_per_run=dt * 1e3, ms_band=[min(times) * 1e3, max(times) * 1e3],
                     us_per_eval=per_eval * 1e6, gedges_s=n * n * L / per_eval / 1e9,
                     blocks=len(times))
            line = (f"{v.key}: {dt * 1e3:.3f} ms/run ({min(times) * 1e3:.3f}-"
                    f"{max(times) * 1e3:.3f}), {per_eval * 1e6:.3f} us/eval, "
                    f"{r['gedges_s']:.1f} Gedges/s")
            if step:
                r["us_per_step_elem"] = dt / (B * args.steps) * 1e6
                line += f", {r['us_per_step_elem']:.1f} us/step/elem"
            if v.kind == "eval" and base.key in finals:
                ref = finals[base.key]
                r["rel_dev_vs_current"] = float((out - ref).abs().max() / ref.abs().max())
                line += f", rel dev vs P2/current {r['rel_dev_vs_current']:.3e}"
            results[v.key] = r
            print(line, flush=True)
    print(json.dumps({"device": label, "shape": dict(n=n, H=H, L=L, B=B, T=shape["T"]),
                      "evals": args.evals, "steps": args.steps, "results": results}),
          flush=True)
    return results


if __name__ == "__main__":
    main()
