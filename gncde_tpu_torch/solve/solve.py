"""Batched, differentiable ODE/CDE integration.

Counterpart of ``gncde_tpu/solve/solve.py``. The JAX loss vmaps the whole
solve over the batch; here the batch is a leading dim written out and
every element keeps its own ``t``, ``h``, accept/reject decision, step
counts and save grid. ``vf(t, y, args)`` takes ``t`` of shape ``(B,)`` and
``y`` of shape ``(B, ...)``.

* Step control is diffrax's ``PIDController`` (I-control by default) with
  Hairer's initial step when ``dt0`` is None. Every controller decision is
  detached, as in the JAX package: gradients flow only through the RK
  stages and the dense output.
* A finished element takes a dummy step with ``h = 1`` whose result is
  masked away (``torch.where``), so the batch moves in lockstep.
* ``adjoint="checkpointed"`` wraps chunks of ``inner = ceil(sqrt(max_steps))``
  steps in ``torch.utils.checkpoint``; ``"full"`` keeps every step's graph;
  ``"none"`` runs under ``no_grad`` with per-step buffered saves.
* The JAX scan always runs ``outer * inner`` attempts and masks the tail.
  This loop stops as soon as every element is done (or at that cap): the
  skipped attempts are no-ops, so the outputs are the same.
* Dense output for the differentiable paths: a (t, y, f) history of every
  attempt, Hermite-interpolated onto the save grid in one post-pass.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
from torch.utils.checkpoint import checkpoint

from .tableaus import ButcherTableau, get_tableau


class ODETerm:
    """Wraps a vector field ``vf(t, y, args) -> dy/dt``."""

    def __init__(self, vf):
        self.vf = vf

    def __call__(self, t, y, args):
        return self.vf(t, y, args)


@dataclasses.dataclass(frozen=True)
class SaveAt:
    ts: tp.Optional[torch.Tensor] = None  # (S,) or (B, S)
    t1: bool = False


@dataclasses.dataclass(frozen=True)
class PIDController:
    """diffrax-compatible defaults (I-control: pcoeff=0, icoeff=1)."""

    rtol: float = 1e-3
    atol: float = 1e-6
    safety: float = 0.9
    factormin: float = 0.2
    factormax: float = 10.0
    pcoeff: float = 0.0
    icoeff: float = 1.0


@dataclasses.dataclass(frozen=True)
class ConstantStepSize:
    pass


@dataclasses.dataclass
class Solution:
    ts: tp.Optional[torch.Tensor]
    ys: torch.Tensor
    stats: tp.Dict[str, torch.Tensor]
    success: torch.Tensor


def _bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-element ``(B,)`` (or ``(B, S)``) value broadcast against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _rk_step(tab: ButcherTableau, vf, t, y, h, args, f0):
    """One explicit RK step; returns (y1, err, f1) with FSAL reuse of f0.

    An FSAL step is first offered to the vector field's ``fused_rk_step``
    hook (one K11 launch per step when the megakernel serves the field,
    ``ops/fused_step.py``); a None return falls through to the stage loop."""
    if tab.fsal:
        inner = getattr(vf, "vf", vf)  # unwrap ODETerm; bare fields pass through
        hook = getattr(inner, "fused_rk_step", None)
        if hook is not None:
            fused = hook(tab, t, y, h, args, f0)
            if fused is not None:
                return fused
    hb = _bc(h, y)
    ks = []
    for i in range(tab.num_stages):
        if i == 0:
            ki = f0
        else:
            acc = None
            for j, aij in enumerate(tab.a[i]):
                if aij == 0.0:
                    continue
                term = aij * ks[j]
                acc = term if acc is None else acc + term
            yi = y if acc is None else y + hb * acc
            ki = vf(t + tab.c[i] * h, yi, args)
        ks.append(ki)

    acc = None
    for i, bi in enumerate(tab.b):
        if bi == 0.0:
            continue
        term = bi * ks[i]
        acc = term if acc is None else acc + term
    y1 = y + hb * acc

    if tab.b_err:
        eacc = None
        for i, bi in enumerate(tab.b_err):
            if bi == 0.0:
                continue
            term = bi * ks[i]
            eacc = term if eacc is None else eacc + term
        err = hb * eacc
    else:
        err = torch.zeros_like(y)
    f1 = ks[-1] if tab.fsal else vf(t + h, y1, args)
    return y1, err, f1


def _hermite_eval(theta, h, y0, f0, y1, f1):
    """Cubic Hermite dense output on one step; theta in [0, 1]."""
    t2 = theta * theta
    t3 = t2 * theta
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + theta
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return h00 * y0 + h10 * h * f0 + h01 * y1 + h11 * h * f1


def _rms(x: torch.Tensor) -> torch.Tensor:
    return (x * x).flatten(1).mean(1).sqrt()


@torch.no_grad()
def _initial_step(vf, t0, y0, args, f0, rtol, atol, error_order):
    """Hairer-Norsett-Wanner automatic initial step size, per element."""
    scale = atol + rtol * y0.abs()
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                     0.01 * d0 / d1)
    y1 = y0 + _bc(h0, y0) * f0
    f1 = vf(t0 + h0, y1, args)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dmax) ** (1.0 / error_order))
    return torch.minimum(100.0 * h0, h1)


def _chunk_sizes(max_steps: int) -> tp.Tuple[int, int]:
    inner = max(1, int(math.ceil(math.sqrt(max_steps))))
    outer = int(math.ceil(max_steps / inner))
    return outer, inner


class _Core(tp.NamedTuple):
    t: torch.Tensor
    y: torch.Tensor
    f: torch.Tensor
    h: torch.Tensor
    n_acc: torch.Tensor
    n_rej: torch.Tensor
    just_rejected: torch.Tensor
    prev_inv: torch.Tensor


def _where(mask, a, b):
    return torch.where(_bc(mask, a), a, b)


def _step_core(tab, vf, args, ctrl, t1, core: _Core):
    """One attempt for every element; returns (new_core, aux)."""
    t, y, f, h, n_acc, n_rej, just_rejected, prev_inv = core
    done = t >= t1
    h_clip = torch.clamp(torch.minimum(h, t1 - t), min=0.0)
    h_eff = torch.where(done, torch.ones_like(h_clip), h_clip)

    y1, err, f1 = _rk_step(tab, vf, t, y, h_eff, args, f)

    with torch.no_grad():
        if ctrl is not None:
            scale = ctrl.atol + ctrl.rtol * torch.maximum(y.abs(), y1.abs())
            q = err / scale
            err_ratio = (q * q).flatten(1).mean(1).sqrt()
            finite = torch.isfinite(err_ratio)
            accept = (err_ratio <= 1.0) & finite
            inv = torch.where(err_ratio == 0.0, torch.full_like(err_ratio, math.inf),
                              1.0 / err_ratio)
            k_exp = 1.0 / tab.error_order
            raw = ctrl.safety * inv ** (ctrl.icoeff * k_exp)
            if ctrl.pcoeff != 0.0:
                raw = raw * (inv / prev_inv) ** (ctrl.pcoeff * k_exp)
            factor = torch.clamp(raw, ctrl.factormin, ctrl.factormax)
            factor = torch.where(finite, factor, torch.full_like(factor, ctrl.factormin))
            factor = torch.where(just_rejected, torch.clamp(factor, max=1.0), factor)
            h_next = h_eff * factor
        else:
            accept = torch.ones_like(done)
            h_next = h

        accept = accept & ~done
        is_last = h >= (t1 - t)
        t_new = torch.where(accept, torch.where(is_last, t1, t + h_eff), t)
        h_new = torch.where(done, h, h_next)
        rejected_now = ~accept & ~done
        n_acc = n_acc + accept.to(n_acc.dtype)
        n_rej = n_rej + rejected_now.to(n_rej.dtype)
        jr_new = torch.where(done, just_rejected, rejected_now)
        if ctrl is not None:
            pi_new = torch.where(done, prev_inv, torch.clamp(inv, 1e-10, 1e10))
        else:
            pi_new = prev_inv

    y_new = _where(accept, y1, y)
    f_new = _where(accept, f1, f)
    new_core = _Core(t_new, y_new, f_new, h_new, n_acc, n_rej, jr_new, pi_new)
    aux = (t, h_eff, y, f, y1, f1, accept, t_new)
    return new_core, aux


def diffeqsolve(terms, solver, t0, t1, dt0, y0: torch.Tensor, args=None,
                stepsize_controller=None, saveat: tp.Optional[SaveAt] = None,
                max_steps: int = 1024, adjoint: str = "checkpointed") -> Solution:
    """Integrate ``dy/dt = vf(t, y, args)`` per batch element from t0 to t1.

    ``y0`` is ``(B, ...)``; ``t0``, ``t1`` and ``dt0`` are scalars or
    ``(B,)``; ``saveat.ts`` is ``(S,)`` or ``(B, S)``. Returns ys of shape
    ``(B, S, ...)`` (or ``(B, ...)`` for ``SaveAt(t1=True)``).
    """
    if adjoint not in ("checkpointed", "full", "none"):
        raise ValueError(
            f"adjoint must be 'checkpointed', 'full' or 'none'; got {adjoint!r}")
    tab = get_tableau(solver)
    vf = terms.vf if isinstance(terms, ODETerm) else terms
    if stepsize_controller is None:
        stepsize_controller = PIDController()
    if saveat is None:
        saveat = SaveAt(t1=True)
    ctrl = stepsize_controller if isinstance(stepsize_controller, PIDController) else None

    B = y0.shape[0]
    dev, dtype = y0.device, torch.promote_types(y0.dtype, torch.float32)

    def per_elem(x):
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        return x.expand(B).clone() if x.dim() == 0 else x.clone()

    t0, t1 = per_elem(t0), per_elem(t1)

    if adjoint == "none":
        with torch.no_grad():
            return _solve_buffered(tab, vf, args, ctrl, t0, t1, dt0, y0, saveat,
                                   max_steps)

    f0 = vf(t0, y0, args)
    if ctrl is not None:
        h_init = (_initial_step(vf, t0, y0, args, f0, ctrl.rtol, ctrl.atol,
                                tab.error_order)
                  if dt0 is None else per_elem(dt0))
    else:
        if dt0 is None:
            raise ValueError("ConstantStepSize requires dt0")
        h_init = per_elem(dt0)

    zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
    core = _Core(t0, y0, f0, h_init.detach(), zeros_i, zeros_i.clone(),
                 torch.zeros(B, dtype=torch.bool, device=dev),
                 torch.ones(B, dtype=dtype, device=dev))
    outer, inner = _chunk_sizes(max_steps)
    collect = saveat.ts is not None

    def chunk(*flat):
        c = _Core(*flat)
        ts_, ys_, fs_ = [], [], []
        for _ in range(inner):
            if bool((c.t >= t1).all()):
                break
            c, aux = _step_core(tab, vf, args, ctrl, t1, c)
            if collect:
                ts_.append(aux[7])
                ys_.append(c.y)
                fs_.append(c.f)
        if collect and ts_:
            return (*c, torch.stack(ts_), torch.stack(ys_), torch.stack(fs_))
        return tuple(c)

    t_hist, y_hist, f_hist = [t0[None]], [y0[None]], [f0[None]]
    for _ in range(outer):
        if bool((core.t >= t1).all()):
            break
        if adjoint == "checkpointed":
            out = checkpoint(chunk, *core, use_reentrant=False)
        else:
            out = chunk(*core)
        core = _Core(*out[:8])
        if len(out) > 8:
            t_hist.append(out[8])
            y_hist.append(out[9])
            f_hist.append(out[10])

    if collect:
        ts_save = _save_grid(saveat.ts, B, dtype, dev)
        ys = _dense_output(torch.cat(t_hist), torch.cat(y_hist), torch.cat(f_hist),
                           ts_save)
    else:
        ys = core.y
    stats = {"num_accepted_steps": core.n_acc, "num_rejected_steps": core.n_rej}
    return Solution(ts=saveat.ts, ys=ys, stats=stats, success=core.t >= t1)


def _save_grid(ts, B, dtype, dev):
    ts = torch.as_tensor(ts, dtype=dtype, device=dev)
    return ts.unsqueeze(0).expand(B, -1) if ts.dim() == 1 else ts


def _dense_output(t_hist, y_hist, f_hist, ts_save):
    """Hermite-interpolate each element's step history onto its save grid.

    t_hist: (S+1, B); y_hist, f_hist: (S+1, B, ...); ts_save: (B, Ns).
    """
    S1 = t_hist.shape[0]
    th = t_hist.T.contiguous()  # (B, S+1), non-decreasing per element
    j = torch.searchsorted(th, ts_save.contiguous(), right=False).clamp(1, S1 - 1)
    t_s, t_e = th.gather(1, j - 1), th.gather(1, j)
    seg_h = t_e - t_s
    pos = seg_h > 0
    theta = torch.where(pos, (ts_save - t_s) / torch.where(pos, seg_h, torch.ones_like(seg_h)),
                        torch.zeros_like(seg_h))
    rows = torch.arange(th.shape[0], device=th.device)[:, None]
    yb, fb = y_hist.transpose(0, 1), f_hist.transpose(0, 1)  # (B, S+1, ...)
    y0, y1 = yb[rows, j - 1], yb[rows, j]
    f0, f1 = fb[rows, j - 1], fb[rows, j]
    return _hermite_eval(_bc(theta, y0), _bc(seg_h, y0), y0, f0, y1, f1)


def _solve_buffered(tab, vf, args, ctrl, t0, t1, dt0, y0, saveat, max_steps):
    """Non-differentiable loop with masked per-step saves (adjoint="none").

    An element stops once it reaches t1 or ``max_steps`` attempts; like the
    vmapped JAX ``while_loop``, a stopped element's state is frozen.
    """
    B = y0.shape[0]
    dev, dtype = y0.device, t0.dtype
    f0 = vf(t0, y0, args)
    if ctrl is not None:
        h_init = (_initial_step(vf, t0, y0, args, f0, ctrl.rtol, ctrl.atol,
                                tab.error_order)
                  if dt0 is None else torch.as_tensor(dt0, dtype=dtype, device=dev).expand(B))
    else:
        if dt0 is None:
            raise ValueError("ConstantStepSize requires dt0")
        h_init = torch.as_tensor(dt0, dtype=dtype, device=dev).expand(B).clone()
    ts_save = (_save_grid(saveat.ts, B, dtype, dev) if saveat.ts is not None
               else t1[:, None])
    ys = torch.where(_bc(ts_save <= t0[:, None], y0[:, None]),
                     y0[:, None].expand((B, ts_save.shape[1]) + y0.shape[1:]),
                     torch.zeros((), dtype=y0.dtype, device=dev))
    zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
    core = _Core(t0, y0, f0, h_init, zeros_i, zeros_i.clone(),
                 torch.zeros(B, dtype=torch.bool, device=dev),
                 torch.ones(B, dtype=dtype, device=dev))
    while True:
        active = (core.t < t1) & (core.n_acc + core.n_rej < max_steps)
        if not bool(active.any()):
            break
        new, aux = _step_core(tab, vf, args, ctrl, t1, core)
        t, h_eff, y, f, y1, f1, accept, t_new = aux
        theta = (ts_save - t[:, None]) / h_eff[:, None]
        smask = (ts_save > t[:, None]) & (ts_save <= t_new[:, None]) & accept[:, None]
        y_interp = _hermite_eval(_bc(theta, ys), _bc(h_eff[:, None], ys),
                                 y[:, None], f[:, None], y1[:, None], f1[:, None])
        ys = torch.where(_bc(smask & active[:, None], ys), y_interp, ys)
        core = _Core(*(_where(active, a, b) for a, b in zip(new, core)))
    if saveat.ts is None:
        ys = ys[:, 0]
    stats = {"num_accepted_steps": core.n_acc, "num_rejected_steps": core.n_rej}
    return Solution(ts=saveat.ts, ys=ys, stats=stats, success=core.t >= t1)
