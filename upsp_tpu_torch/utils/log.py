"""Leveled logging setup (cpp/include/logging.h role).

Port of ``upsp_tpu/utils/log.py``, which asks jax for the process index;
here the rank comes from ``torch.distributed`` when a process group is up.
"""

from __future__ import annotations

import logging
import sys

_LEVELS = {
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}


def set_level(level: str = "info", rank0_only: bool = True) -> logging.Logger:
    """Configure the ``upsp_tpu`` logger; non-zero ranks log warnings+ only."""
    logger = logging.getLogger("upsp_tpu")
    lvl = _LEVELS.get(level.lower(), logging.INFO)
    if rank0_only:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_rank():
            lvl = max(lvl, logging.WARNING)
    logger.setLevel(lvl)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
    return logger
