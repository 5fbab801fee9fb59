"""Device-side slab construction.

Index builds permute the corpus cluster-major. The r1 implementation
permuted on host and re-uploaded the slab, a second full upload per
build (VERDICT r1 #3). Here the permuted
slab is a device-side ``take`` of the buffer k-means already uploaded
(ops/kmeans.kmeans_build): out-of-bounds pad indices become zero rows via
``mode="fill"``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pad_order(order: np.ndarray, npad: int, oob: int) -> jax.Array:
    """Permutation padded to ``npad`` with out-of-bounds indices; the fill
    mode of the takes below turns those rows into zeros."""
    out = np.full(npad, oob, np.int32)
    out[: order.size] = order
    return jnp.asarray(out)


@jax.jit
def take_slab(x: jax.Array, idx: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Permuted slab + fp32 row sqnorms (zero rows for pad indices)."""
    xp = jnp.take(x, idx, axis=0, mode="fill", fill_value=0)
    xf = xp.astype(jnp.float32)
    return xp, jnp.sum(xf * xf, axis=-1)


@functools.partial(jax.jit, static_argnames=("dtype",))
def take_slab_cast(
    x: jax.Array, idx: jax.Array, *, dtype: str
) -> tuple[jax.Array, jax.Array]:
    """Permuted slab stored as ``dtype`` (e.g. bf16 rerank slab) + fp32
    sqnorms computed BEFORE the cast so L2 terms stay exact."""
    xp = jnp.take(x, idx, axis=0, mode="fill", fill_value=0)
    sq = jnp.sum(xp * xp, axis=-1)
    return xp.astype(jnp.dtype(dtype)), sq


@jax.jit
def take_rows(x: jax.Array, idx: jax.Array) -> jax.Array:
    """Plain permuted take (codes slab etc.)."""
    return jnp.take(x, idx, axis=0, mode="fill", fill_value=0)


@jax.jit
def take_slab_sq8res(
    x: jax.Array, idx: jax.Array, cents: jax.Array, crow: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Permuted slab stored as residual-SQ8: r = x[idx] − cents[crow],
    per-row affine uint8 codes (min/scale over the row's own residual
    range). Returns (codes u8 [npad, D], mins, scales, sqnorm fp32 [npad]).

    ``sqnorm`` is ‖x̂‖² of the RECONSTRUCTION x̂ = c + min + scale·code, so
    L2 off this slab is exact up to storage rounding — the same convention
    as take_slab_cast's bf16 twin (rerank_exact semantics). Pad rows
    (out-of-bounds idx) encode −c; they are alive=False everywhere."""
    xp = jnp.take(x, idx, axis=0, mode="fill", fill_value=0)
    xf = xp.astype(jnp.float32)
    c = jnp.take(cents, crow, axis=0)
    r = xf - c
    mn = jnp.min(r, axis=1)
    mx = jnp.max(r, axis=1)
    scale = jnp.maximum(mx - mn, 1e-12) / 255.0
    code = jnp.clip(jnp.round((r - mn[:, None]) / scale[:, None]), 0.0, 255.0)
    xhat = c + mn[:, None] + scale[:, None] * code
    sq = jnp.sum(xhat * xhat, axis=-1)
    return code.astype(jnp.uint8), mn, scale, sq
