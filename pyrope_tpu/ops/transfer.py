"""Chunked host->device transfers.

A corpus moves to the device as ~8 MB ``jax.device_put`` chunks instead
of one ``jnp.asarray(big_host_array)``: per-chunk dtype conversion
recycles one small host buffer through the allocator, where staging a
fresh full-size host copy (np.pad, astype of the whole slab) would
first-touch every page of it. Padding is therefore done device-side (a
zeros part in the concatenate), never via a host ``np.pad`` copy. Whether
chunking also speeds the copy itself on this host-device link has not been
measured (see ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# ~8 MB per chunk: big enough to amortize per-transfer dispatch cost,
# small enough that the per-chunk conversion buffer stays allocator-hot.
DEFAULT_CHUNK_BYTES = 8 << 20


def upload_rows(
    x: np.ndarray,
    *,
    dtype=None,
    pad_to: Optional[int] = None,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> jax.Array:
    """Upload a row-major [N, ...] host array as pipelined chunks.

    Returns a single device array of shape [pad_to or N, ...] (zero-padded
    rows at the tail), dtype ``dtype`` (default: x.dtype). The result is
    NOT fetched back; callers fence as usual.

    Aliasing: on backends where ``jax.device_put`` is zero-copy (the CPU
    backend), same-dtype chunks may ALIAS the caller's host memory — callers
    must treat ``x`` as frozen until the next sync (index locking already
    guarantees this: slabs are replaced, never written in place, while a
    device view is live).
    """
    x = np.asarray(x)
    n = x.shape[0]
    out_dtype = x.dtype if dtype is None else jnp.dtype(dtype)
    npad = n if pad_to is None else max(int(pad_to), n)
    if n == 0:
        return jnp.zeros((npad,) + x.shape[1:], out_dtype)
    rowbytes = max(x.nbytes // n, 1)
    step = max(int(chunk_bytes) // rowbytes, 1)
    parts = []
    for s in range(0, n, step):
        blk = x[s : s + step]
        if blk.dtype != out_dtype:
            blk = blk.astype(out_dtype)
        parts.append(jax.device_put(blk))
    if npad > n:
        parts.append(jnp.zeros((npad - n,) + x.shape[1:], out_dtype))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)
