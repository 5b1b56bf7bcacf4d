"""Wind-tunnel data (.wtd) file parsing -> tunnel conditions.

Format: free text; a line whose first token is a bare ``#`` is a column-name
header, and the NEXT line carries the values.  Columns of interest: MACH ALPHA
BETA PHI PTOT TTF PS Q TCAVG RNU STRUTZ.

Parity: cpp/lib/non_cv_upsp.cpp:read_tunnel_conditions and
python/upsp/cam_cal_utils/parsers.py (read_wind_tunnel_data); studied, not
copied.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class TunnelConditions:
    """Tunnel state for one datapoint.  Temperatures degF, pressures psf."""

    alpha: float = math.nan
    beta: float = math.nan
    phi: float = math.nan
    mach: float = math.nan
    rey: float = math.nan  # million/ft
    ptot: float = math.nan
    qbar: float = math.nan
    ttot: float = math.nan
    ps: float = math.nan
    tcavg: float = math.nan
    strutz: float = math.nan
    test_id: str = ""
    run: int = 0
    seq: int = 0


_COLUMN_MAP = {
    "ALPHA": "alpha",
    "BETA": "beta",
    "PHI": "phi",
    "MACH": "mach",
    "RNU": "rey",
    "PTOT": "ptot",
    "Q": "qbar",
    "TTF": "ttot",
    "PS": "ps",
    "TCAVG": "tcavg",
    "STRUTZ": "strutz",
}


def read_wtd(filename: str) -> TunnelConditions:
    """Read the first header/value pair of a WTD file."""
    cond = TunnelConditions()
    with open(filename, "r") as f:
        lines = iter(f.readlines())
    for line in lines:
        terms = line.split()
        if terms and terms[0] == "#":
            try:
                vals = next(lines).split()
            except StopIteration:
                break
            if len(vals) != len(terms) - 1:
                raise ValueError(f"failed to parse '{filename}': column/value mismatch")
            for name, val in zip(terms[1:], vals):
                attr = _COLUMN_MAP.get(name)
                if attr is not None:
                    try:
                        setattr(cond, attr, float(val))
                    except ValueError:
                        pass
            break
    return cond


def model_temperature(
    cond: TunnelConditions,
    recovery_factor: float = 0.896,
    gamma: float = 1.4,
    f_to_r: float = 459.67,
) -> float:
    """Estimate model wall temperature (degF).

    Adiabatic-wall recovery estimate from total temperature and Mach
    (psp_process.cpp:2285-2309): convert TTF to Rankine, static temperature
    T_inf = Ttot / (1 + (g-1)/2 M^2), wall = r*(Ttot - T_inf) + T_inf.  A
    measured thermocouple average (TCAVG) supersedes the estimate.
    """
    ttot_r = cond.ttot + f_to_r
    t_inf = ttot_r / (1.0 + (gamma - 1.0) * 0.5 * cond.mach * cond.mach) - f_to_r
    wall = recovery_factor * (cond.ttot - t_inf) + t_inf
    if not math.isnan(cond.tcavg):
        return cond.tcavg
    return wall
