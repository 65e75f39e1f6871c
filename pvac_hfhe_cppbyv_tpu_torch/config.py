"""Debug configuration (reference: include/pvac/core/config.hpp:9-21).

Debug level comes from the ``PVAC_DBG`` or ``HFHE_DBG`` environment variable
(0 = silent, 1 = info, 2 = verbose), and can be overridden at runtime.
"""
from __future__ import annotations

import os


def _init_debug_level() -> int:
    for var in ("PVAC_DBG", "HFHE_DBG"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return max(0, min(2, int(v)))
            except ValueError:
                pass
    return 0


_g_dbg = _init_debug_level()


def get_debug_level() -> int:
    return _g_dbg


def set_debug_level(level: int) -> None:
    global _g_dbg
    _g_dbg = max(0, min(2, int(level)))


def dbg(level: int, msg: str) -> None:
    if _g_dbg >= level:
        print(msg, flush=True)
