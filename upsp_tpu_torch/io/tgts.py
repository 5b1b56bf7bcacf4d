"""Target (.tgts) file parsing.

The tgts file is whitespace-separated text with ``*Section`` headers.  Each data
row is::

    idx  x y z  nx ny nz  diameter  zone j k  name

Targets under ``*Targets`` are classified by their name suffix: ``st`` (sharpie
dot), ``mK`` (masked kulite, visible), ``pK`` (painted kulite, invisible).
Fiducials live under ``*Fiducials``.

Behavior parity: python/upsp/cam_cal_utils/parsers.py:7-96 and
cpp/lib (read_psp_target_file); studied, not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass
class Target:
    """One painted/taped marker on the model surface (tunnel coordinates)."""

    idx: int
    xyz: np.ndarray  # (3,)
    norm: np.ndarray  # (3,)
    diameter: float
    zones: tuple
    name: str
    target_type: str
    uv: Optional[np.ndarray] = None  # (2,) image-plane position once projected

    @staticmethod
    def type_of(name: str) -> str:
        if "st" in name:
            return "dot"
        if "mK" in name:
            return "kulite"
        if "pK" in name:
            return "painted_kulite"
        return name


def read_tgts(
    path: str,
    output_target_types: Optional[Union[str, Sequence[str]]] = None,
    section: str = "*Targets",
) -> List[Target]:
    """Read targets from a tgts file section (default ``*Targets``)."""
    if output_target_types is not None and isinstance(output_target_types, str):
        output_target_types = [output_target_types]

    targets: List[Target] = []
    current = None
    with open(path, "r") as f:
        for raw in f:
            line = raw.split()
            if len(line) <= 1:
                current = line[0] if len(line) == 1 else None
                continue
            if current != section:
                continue
            name = line[-1]
            ttype = Target.type_of(name)
            if output_target_types is not None and ttype not in output_target_types:
                continue
            targets.append(
                Target(
                    idx=int(line[0]),
                    xyz=np.array([float(v) for v in line[1:4]], np.float64),
                    norm=np.array([float(v) for v in line[4:7]], np.float64),
                    diameter=float(line[7]),
                    zones=(int(line[8]), int(line[9]), int(line[10])),
                    name=name,
                    target_type=ttype,
                )
            )
    return targets


def read_tgts_header(path: str) -> Dict[str, str]:
    """Parse ``#KEY: value`` comment-header lines (GRID_FILE, GRID_TOLERANCE...)."""
    out: Dict[str, str] = {}
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line.startswith("#"):
                break
            if ":" in line:
                key, _, val = line[1:].partition(":")
                out[key.strip()] = val.strip()
    return out


def targets_as_arrays(targets: Sequence[Target]):
    """Stack targets into (N,3) xyz, (N,3) norm, (N,) diameter arrays."""
    if not targets:
        return (
            np.zeros((0, 3), np.float64),
            np.zeros((0, 3), np.float64),
            np.zeros((0,), np.float64),
        )
    xyz = np.stack([t.xyz for t in targets])
    nrm = np.stack([t.norm for t in targets])
    dia = np.array([t.diameter for t in targets])
    return xyz, nrm, dia
