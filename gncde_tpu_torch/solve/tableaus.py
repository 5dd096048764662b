"""Explicit Runge--Kutta Butcher tableaus.

Counterpart of ``gncde_tpu/solve/tableaus.py`` for the explicit methods:
Tsit5 (Tsitouras 2011, the pair diffrax uses), Dopri5, Bosh3, Euler and
Heun. ``b_err`` holds the error-estimate weights (b - b_hat), so the
embedded error is ``h * sum_i b_err[i] * k[i]``. The ESDIRKs and Dopri8 are
not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import typing as tp


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    name: str
    c: tuple
    a: tuple  # lower-triangular rows: a[i] has i entries
    b: tuple
    b_err: tuple  # empty => no embedded error estimate
    order: int
    error_order: int  # controller exponent is 1 / error_order
    fsal: bool

    @property
    def num_stages(self) -> int:
        return len(self.c)


TSIT5 = ButcherTableau(
    name="tsit5",
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    a=(
        (),
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.071584973281401, -0.028269050394068383),
        (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774),
    ),
    b=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
       -3.290069515436081, 2.324710524099774, 0.0),
    b_err=(-0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
           -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
           0.015151515151515152),
    order=5,
    error_order=5,
    fsal=True,
)

DOPRI5 = ButcherTableau(
    name="dopri5",
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    b_err=(35 / 384 - 5179 / 57600, 0.0, 500 / 1113 - 7571 / 16695,
           125 / 192 - 393 / 640, -2187 / 6784 + 92097 / 339200,
           11 / 84 - 187 / 2100, -1 / 40),
    order=5,
    error_order=5,
    fsal=True,
)

BOSH3 = ButcherTableau(
    name="bosh3",
    c=(0.0, 1 / 2, 3 / 4, 1.0),
    a=((), (1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    b=(2 / 9, 1 / 3, 4 / 9, 0.0),
    b_err=(2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    order=3,
    error_order=3,
    fsal=True,
)

EULER = ButcherTableau(name="euler", c=(0.0,), a=((),), b=(1.0,), b_err=(),
                       order=1, error_order=2, fsal=False)

HEUN = ButcherTableau(name="heun", c=(0.0, 1.0), a=((), (1.0,)), b=(1 / 2, 1 / 2),
                      b_err=(-1 / 2, 1 / 2), order=2, error_order=2, fsal=False)

_TABLEAUS: tp.Dict[str, ButcherTableau] = {}
for _tab in (TSIT5, DOPRI5, BOSH3, EULER, HEUN):
    _TABLEAUS[_tab.name] = _tab
    _TABLEAUS[_tab.name.capitalize()] = _tab  # reference method names


def get_tableau(name) -> ButcherTableau:
    if isinstance(name, ButcherTableau):
        return name
    if name not in _TABLEAUS:
        raise ValueError(
            f"Unknown or unported solver {name!r}; have {sorted(set(_TABLEAUS))}")
    return _TABLEAUS[name]
