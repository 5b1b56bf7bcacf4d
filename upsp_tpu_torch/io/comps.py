"""Active-component CSV parsing + node masking.

Reproduces upsp_files::read_active_comp_file (cpp/utils/file_readers.cpp:12-50
— studied, not copied) and the psp_process node-masking pass that follows it
(cpp/exec/psp_process.cpp:1459-1487): a CSV with a header line and
``component,active`` rows; every node whose primary component is listed with
active == 0 becomes a non-data node (excluded from projection/output).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def read_active_comp_file(path: str) -> Dict[int, bool]:
    """Parse the active-component CSV: header line, then ``comp,active`` rows.

    ``active`` follows the reference's |stoi| semantics: any nonzero value
    (including negatives) means active; 0 means inactive.
    """
    comps: Dict[int, bool] = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines[1:]:  # first line is the header
        if not line.strip():
            continue
        terms = line.split(",")
        try:
            comp = int(terms[0])
            active = abs(int(terms[1]))
        except (ValueError, IndexError) as e:
            raise ValueError(f"Cannot parse active component csv file: {line!r}") from e
        comps[comp] = active != 0
    return comps


def apply_active_comps(model, path: str) -> int:
    """Mask nodes of inactive components as non-data; returns count masked.

    Errors if the file lists more components than the grid has, exactly like
    the reference's validation (psp_process.cpp:1466-1471).
    """
    comps = read_active_comp_file(path)
    n_grid_comps = int(np.unique(model.components).size)
    if len(comps) > n_grid_comps:
        raise ValueError(
            "Number of components in active component file cannot be greater "
            f"than the number of components in the grid ({len(comps)} > "
            f"{n_grid_comps})"
        )
    inactive = np.array(
        [c for c, active in comps.items() if not active], dtype=np.int64
    )
    if inactive.size == 0:
        return 0
    mask = np.isin(model.components, inactive)
    model.set_node_nondata(mask)
    return int(mask.sum())
