"""Control-path interpolation for matrix-valued signals.

Counterpart of ``gncde_tpu/interp/paths.py``. The time axis is the last
axis of ``ts`` and the matching axis of ``ys``: ``ts`` is ``(T,)`` or
``(B, T)`` and ``ys`` is ``(T, *channels)`` or ``(B, T, *channels)``. A
batched path evaluates at a per-element time ``t`` of shape ``(B,)``
against its per-element knots, since irregularly sampled trajectories each
have their own grid.

Hermite coefficients follow the backward-difference scheme of the JAX
package: on interval i, with h = t[i+1] - t[i],

    y(t[i] + tau) = a + b tau + c tau^2 + d tau^3,   a = y[i], b = f[i],
    c = (3 (y[i+1]-y[i])/h - 2 f[i] - f[i+1]) / h,
    d = (f[i] + f[i+1] - 2 (y[i+1]-y[i])/h) / h^2,

with f[i] = (y[i]-y[i-1]) / (t[i]-t[i-1]) and f[0] = f[1]; zero-length
intervals inherit the previous slope.
"""

from __future__ import annotations

import torch


def _tshape(ts: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """``ts`` broadcast to ``ys``'s shape along the time axis."""
    extra = ys.dim() - ts.dim()
    return ts.reshape(ts.shape + (1,) * extra).expand(ys.shape)


def fill_nan_linear(ts: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Replace NaNs along the time axis by linear interpolation between
    finite knots; leading/trailing NaNs take the nearest finite value."""
    tdim = ts.dim() - 1
    T = ys.shape[tdim]
    finite = torch.isfinite(ys)
    if bool(finite.all()):
        return ys
    pos_shape = [1] * ys.dim()
    pos_shape[tdim] = T
    pos = torch.arange(T, device=ys.device).reshape(pos_shape).expand(ys.shape)
    prev_pos = torch.where(finite, pos, -1).cummax(tdim).values
    next_pos = torch.where(finite, pos, T).flip(tdim).cummin(tdim).values.flip(tdim)
    t_full = _tshape(ts, ys)
    has_prev, has_next = prev_pos >= 0, next_pos < T
    nan = torch.tensor(float("nan"), dtype=ys.dtype, device=ys.device)
    prev_vals = torch.where(has_prev, ys.gather(tdim, prev_pos.clamp(0, T - 1)), nan)
    next_vals = torch.where(has_next, ys.gather(tdim, next_pos.clamp(0, T - 1)), nan)
    t_first = t_full.narrow(tdim, 0, 1).expand(ys.shape)
    t_last = t_full.narrow(tdim, T - 1, 1).expand(ys.shape)
    prev_ts = torch.where(has_prev, t_full.gather(tdim, prev_pos.clamp(0, T - 1)), t_first)
    next_ts = torch.where(has_next, t_full.gather(tdim, next_pos.clamp(0, T - 1)), t_last)

    denom = next_ts - prev_ts
    zero = denom == 0
    w = torch.where(zero, torch.zeros_like(denom),
                    (t_full - prev_ts) / torch.where(zero, torch.ones_like(denom), denom))
    interp = prev_vals + w * (next_vals - prev_vals)
    interp = torch.where(torch.isnan(prev_vals), next_vals, interp)
    interp = torch.where(torch.isnan(next_vals), prev_vals, interp)
    return torch.where(finite, ys, interp)


def linear_interpolation(ts: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Coefficients for :class:`LinearInterpolation` (NaN-filled knots)."""
    return fill_nan_linear(ts, ys)


def backward_hermite_coefficients(ts: torch.Tensor, ys: torch.Tensor):
    """``(d, c, b, a)``, each ``(..., T-1, *channels)``."""
    tdim = ts.dim() - 1
    ys = fill_nan_linear(ts, ys)
    T = ys.shape[tdim]
    tdiff = ts[..., 1:] - ts[..., :-1]
    lo, hi = ys.narrow(tdim, 0, T - 1), ys.narrow(tdim, 1, T - 1)
    h = tdiff.reshape(tdiff.shape + (1,) * (ys.dim() - ts.dim()))
    safe_h = torch.where(h == 0, torch.ones_like(h), h)
    raw_slope = (hi - lo) / safe_h
    if bool((h != 0).all()):
        slope = raw_slope
    else:
        # Forward-fill the slope over zero-length intervals (initial carry 0).
        valid = (h != 0).expand(raw_slope.shape)
        pos_shape = [1] * ys.dim()
        pos_shape[tdim] = T - 1
        pos = torch.arange(T - 1, device=ys.device).reshape(pos_shape).expand(
            raw_slope.shape)
        last = torch.where(valid, pos, -1).cummax(tdim).values
        slope = torch.where(last >= 0,
                            raw_slope.gather(tdim, last.clamp(0, T - 2)),
                            torch.zeros_like(raw_slope))
    h = safe_h
    f = torch.cat([slope.narrow(tdim, 0, 1), slope], dim=tdim)
    f0, f1 = f.narrow(tdim, 0, T - 1), f.narrow(tdim, 1, T - 1)
    a = lo
    b = f0
    c = (3.0 * slope - 2.0 * f0 - f1) / h
    d = (f0 + f1 - 2.0 * slope) / (h * h)
    return d, c, b, a


def interval_index(ts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Index i with ts[i] <= t < ts[i+1], clipped to [0, T-2], per element."""
    idx = torch.searchsorted(ts, t.unsqueeze(-1).to(ts.dtype), right=True)
    return (idx.squeeze(-1) - 1).clamp(0, ts.shape[-1] - 2)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i]`` (unbatched) or ``x[b, idx[b]]`` (batched) along the time axis."""
    if idx.dim() == 0:
        return x[idx]
    return x[torch.arange(idx.shape[0], device=idx.device), idx]


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Knot values or coefficients stored in bfloat16 (``fusion_precision:
    bf16``), upcast: the path is evaluated in f32, as JAX promotes them (torch
    would keep ``3.0 * d`` in bf16); other dtypes pass unchanged."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-element scalar ``v`` (shape ``()`` or ``(B,)``) against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


class LinearInterpolation:
    """Piecewise-linear control path."""

    def __init__(self, ts: torch.Tensor, ys: torch.Tensor):
        self.ts = ts.contiguous()
        self.ys = ys

    def _interval(self, t):
        # Step back over zero-length (repeated-knot) padding intervals.
        i = interval_index(self.ts, t)
        t_i = self.ts.gather(-1, i.unsqueeze(-1)).squeeze(-1)
        t_n = self.ts.gather(-1, (i + 1).unsqueeze(-1)).squeeze(-1)
        i_back = interval_index(self.ts, torch.nextafter(t_i, t_i - 1.0))
        return torch.where(t_n == t_i, i_back, i)

    def _ends(self, t):
        i = self._interval(t)
        t0 = self.ts.gather(-1, i.unsqueeze(-1)).squeeze(-1)
        t1 = self.ts.gather(-1, (i + 1).unsqueeze(-1)).squeeze(-1)
        return i, t0, t1

    def evaluate(self, t):
        i, t0, t1 = self._ends(t)
        same = t1 == t0
        h = torch.where(same, torch.ones_like(t0), t1 - t0)
        w = torch.where(same, torch.zeros_like(t0), (t - t0) / h)
        y0, y1 = _f32(_take(self.ys, i)), _f32(_take(self.ys, i + 1))
        return y0 + _bcast(w, y0) * (y1 - y0)

    def derivative(self, t):
        i, t0, t1 = self._ends(t)
        same = t1 == t0
        h = torch.where(same, torch.ones_like(t0), t1 - t0)
        scale = torch.where(same, torch.zeros_like(t0), 1.0 / h)
        y0, y1 = _f32(_take(self.ys, i)), _f32(_take(self.ys, i + 1))
        return (y1 - y0) * _bcast(scale, y0)


class CubicInterpolation:
    """Hermite-cubic control path; ``coeffs`` is ``(d, c, b, a)``, float32 or
    (``fusion_precision: bf16``) bfloat16, evaluated in f32 either way."""

    def __init__(self, ts: torch.Tensor, coeffs):
        self.ts = ts.contiguous()
        self.coeffs = tuple(coeffs)

    def _at(self, t):
        i = interval_index(self.ts, t)
        tau = t - self.ts.gather(-1, i.unsqueeze(-1)).squeeze(-1)
        return i, tau

    def evaluate(self, t):
        d, c, b, a = self.coeffs
        i, tau = self._at(t)
        di, ci, bi, ai = (_f32(_take(x, i)) for x in (d, c, b, a))
        tau = _bcast(tau, di)
        return ((di * tau + ci) * tau + bi) * tau + ai

    def derivative(self, t):
        d, c, b, a = self.coeffs
        i, tau = self._at(t)
        di, ci, bi = (_f32(_take(x, i)) for x in (d, c, b))
        tau = _bcast(tau, di)
        return (3.0 * di * tau + 2.0 * ci) * tau + bi


class MatrixControl:
    """Slim adjacency control with an implicit unit-gradient time channel.

    Holds only the adjacency (value) channel of reference-layout stacked
    ``[time, value]`` coefficients; vector fields probe ``tgrad_is_unit``.
    ``red`` optionally carries the per-trajectory plane reductions of the
    tiled regime (``ops/tiled.py`` ``PlaneReductions``).
    """

    tgrad_is_unit = True

    def __init__(self, path, red=None):
        self.path = path
        self.red = red

    @classmethod
    def from_stacked(cls, interpolation: str, ts, coeffs):
        if interpolation == "linear":
            return cls(LinearInterpolation(ts, coeffs[..., -1].contiguous()))
        return cls(CubicInterpolation(
            ts, tuple(c[..., -1].contiguous() for c in coeffs)))

    def to(self, device) -> "MatrixControl":
        p = self.path
        red = None if self.red is None else type(self.red)(*(r.to(device) for r in self.red))
        if isinstance(p, CubicInterpolation):
            return MatrixControl(CubicInterpolation(
                p.ts.to(device), tuple(c.to(device) for c in p.coeffs)), red)
        return MatrixControl(LinearInterpolation(p.ts.to(device), p.ys.to(device)), red)

    def adj(self, t):
        return self.path.evaluate(t)

    def dadj(self, t):
        return self.path.derivative(t)

    evaluate = adj
    derivative = dadj
