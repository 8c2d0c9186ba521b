"""The package's log channel (port of ``cylon_tpu/utils/logging.py``).

``log`` is the ``cylon_tpu_torch`` logger; :func:`set_log_level` takes a
glog-style int (0 = INFO .. 3 = FATAL), a ``logging`` level int or a level
name.  The default level is ``CYLON_TPU_TORCH_LOG`` or WARNING.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("cylon_tpu_torch")

_GLOG_LEVELS = {0: logging.INFO, 1: logging.WARNING, 2: logging.ERROR,
                3: logging.CRITICAL}


def set_log_level(level) -> None:
    """Set the channel's level.  A bool is refused: it is an int, and
    ``True`` would silently mean glog level 1."""
    if isinstance(level, bool):
        raise TypeError(
            "set_log_level expects a glog int (0-3), logging int, or level "
            f"name — got {level!r} (bool would alias glog level {int(level)})")
    if isinstance(level, str):
        lv = getattr(logging, level.upper())
    elif level in _GLOG_LEVELS:
        lv = _GLOG_LEVELS[level]
    else:
        lv = int(level)
    log.setLevel(lv)


if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(levelname).1s cylon_tpu_torch %(asctime)s] %(message)s",
        "%H:%M:%S"))
    log.addHandler(_h)
    set_log_level(os.environ.get("CYLON_TPU_TORCH_LOG", "WARNING"))
