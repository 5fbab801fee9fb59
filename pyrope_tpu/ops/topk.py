"""Top-k selection and merge utilities.

The reference keeps a per-query min-heap while scanning rows
(ref: BruteForceVectorIndex.cs:291,333-334 PriorityQueue). On the device we
select over the whole masked score matrix with ``jax.lax.top_k``, and merge
partial top-k sets (head/tail, per-shard) by concatenating then
re-selecting.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG_INF = jnp.float32(-jnp.inf)


def parse_selection(selection: str) -> tuple[str, float]:
    """'exact' | 'approx[:<recall>]' | 'hybrid[:<R>]' -> (mode, param):
    approx's param is its recall target; hybrid's is the shortlist width R
    (0 = auto: max(64, 4k)).

    'hybrid' = the fused scan+top-k kernel (ops/pallas_scan.py) scans bf16
    operands and keeps the top R, then an fp32-HIGHEST rerank of the R rows
    restores exact scores/order at bf16 scan cost (the PQ-refine pattern
    applied to the exact path); indexes route it before reaching
    masked_topk."""
    if selection == "exact":
        return selection, 1.0
    if selection.startswith("approx"):
        _, _, rt = selection.partition(":")
        return "approx", float(rt) if rt else 0.95
    if selection.startswith("hybrid"):
        _, _, r = selection.partition(":")
        return "hybrid", float(r) if r else 0.0
    raise ValueError(
        f"selection must be exact|approx[:recall]|hybrid[:R], got {selection!r}"
    )


def masked_topk(
    scores: jax.Array,
    mask: jax.Array | None,
    k: int,
    selection: str = "exact",
) -> tuple[jax.Array, jax.Array]:
    """Top-k of scores[b, n] over valid columns.

    mask: [N] or [B, N] bool — True = candidate is live. Masked-out entries
    get -inf scores (callers detect missing hits via -inf).

    selection: 'exact' uses ``lax.top_k``; 'approx[:recall]' uses
    ``lax.approx_max_k``. On the GPU approx_max_k lowers to an exact
    sort-based top-k, so 'approx' returns exact results there and gains
    nothing over 'exact' (its recall target only matters on backends with
    a partial-reduce implementation).

    Returns (values [B, k], indices [B, k]) sorted descending.
    """
    if mask is not None:
        scores = jnp.where(mask, scores, NEG_INF)
    k_eff = min(k, scores.shape[-1])
    mode, recall_target = parse_selection(selection)
    if mode == "approx" and scores.shape[-1] > 1024:
        vals, idx = jax.lax.approx_max_k(scores, k_eff, recall_target=recall_target)
    else:
        vals, idx = jax.lax.top_k(scores, k_eff)
    if k_eff < k:
        pad = k - k_eff
        vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        idx = jnp.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
    # Invalidate indices of -inf entries so hosts can drop them.
    idx = jnp.where(jnp.isfinite(vals), idx, -1)
    return vals, idx


@functools.lru_cache(maxsize=None)
def _chunk_exact_fn(metric, k_eff: int):
    """Jitted per-chunk scorer for chunked_exact_topk (fp32 HIGHEST)."""

    @jax.jit
    def fn(xc, sqc, alivec, qd):
        from pyrope_tpu.ops.distance import score_matrix

        scores = score_matrix(qd, xc.astype(jnp.float32), metric, x_sqnorm=sqc)
        return masked_topk(scores, alivec[None, :], k_eff, "exact")

    return fn


def chunked_exact_topk(
    x: jax.Array,
    sqnorm: jax.Array,
    alive: jax.Array,
    q: jax.Array,
    k: int,
    metric,
    chunk_rows: int = 1 << 20,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k over a device slab, chunked over corpus rows.

    Verification-grade ground truth at scales where the one-shot XLA path's
    [B, N] score transient would not fit HBM (10M x b256 fp32 = 10 GB): each
    chunk scores [B, chunk_rows] with fp32-HIGHEST matmuls (the exact-path
    invariant), selects top-k on device, and the per-chunk winners merge on
    host. Returns HOST (values [B, k], slab-row indices [B, k]) sorted
    descending; -inf/-1 mark missing hits.

    Independent of the Pallas fused kernel by construction (XLA
    score_matrix + lax.top_k), so it can serve as its cross-check.
    """
    import numpy as np

    from pyrope_tpu.types import Metric

    metric = Metric.parse(metric)
    n = x.shape[0]
    b = q.shape[0]
    best_v = np.full((b, k), -np.inf, np.float32)
    best_i = np.full((b, k), -1, np.int64)
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        # per-chunk k clamp: a short TAIL chunk (n % chunk_rows < k) would
        # otherwise feed lax.top_k a k larger than its row count (ADVICE r3)
        fn = _chunk_exact_fn(metric, min(k, e - s))
        vals, idx = fn(x[s:e], sqnorm[s:e], alive[s:e], q)
        vals = np.asarray(vals)
        idx = np.asarray(idx, np.int64)
        idx = np.where(idx >= 0, idx + s, -1)
        cand_v = np.concatenate([best_v, vals], axis=1)
        cand_i = np.concatenate([best_i, idx], axis=1)
        order = np.argsort(-cand_v, axis=1, kind="stable")[:, :k]
        best_v = np.take_along_axis(cand_v, order, axis=1)
        best_i = np.take_along_axis(cand_i, order, axis=1)
    return best_v, best_i


def merge_topk(
    vals_a: jax.Array,
    idx_a: jax.Array,
    vals_b: jax.Array,
    idx_b: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Merge two per-query top-k candidate sets (ids in a shared id space).

    Used for Delta head+tail merge and cross-shard reduction
    (ref: DeltaVectorIndex.cs:76-122 merge; §5.8 of SURVEY for the shard
    all-gather merge).
    """
    vals = jnp.concatenate([vals_a, vals_b], axis=-1)
    idx = jnp.concatenate([idx_a, idx_b], axis=-1)
    mvals, pos = jax.lax.top_k(vals, min(k, vals.shape[-1]))
    midx = jnp.take_along_axis(idx, pos, axis=-1)
    midx = jnp.where(jnp.isfinite(mvals), midx, -1)
    return mvals, midx
