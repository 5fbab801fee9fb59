"""Device-resident scalar cache.

Every ``jnp.int32(v)`` constructed per query is a fresh host→device
transfer ahead of the search dispatch. Search-time scalars (max_scans,
entry points, nprobe) take a handful of distinct values, so cache them on
device by value. What this saves per query on the GPU has not been
measured (see ROADMAP).
"""

from __future__ import annotations

import threading

import jax.numpy as jnp

_CACHE: dict[int, "jnp.ndarray"] = {}
_LOCK = threading.Lock()
_MAX_ENTRIES = 4096


def device_i32(value: int):
    """A cached device int32 scalar for `value`."""
    v = int(value)
    got = _CACHE.get(v)
    if got is not None:
        return got
    arr = jnp.int32(v)
    with _LOCK:
        if len(_CACHE) >= _MAX_ENTRIES:
            _CACHE.clear()
        _CACHE[v] = arr
    return arr

