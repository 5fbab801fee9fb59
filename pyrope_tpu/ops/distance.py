"""Batched score kernels.

The reference computes one distance per (query, row) pair in SIMD loops
(ref: Vector/VectorMath.cs — DotProduct :8-37, L2Squared :39-70, Cosine
:102-125, unsafe unrolled variants :128-253). On the device the whole
[B, N] score matrix is one matmul; L2 uses the ‖q‖² + ‖x‖² − 2·q·x expansion so the
only O(B·N·D) work is the dot-product matmul.

Score convention (higher is better), matching the reference
(ref: BruteForceVectorIndex.cs:350-356):
    L2     -> -squared_distance
    IP     -> dot(q, x)
    COSINE -> dot(q, x) / (‖q‖·‖x‖)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pyrope_tpu.types import Metric


def score_convention(metric: Metric) -> str:
    """Human-readable score semantics for a metric."""
    return {
        Metric.L2: "-l2_squared",
        Metric.INNER_PRODUCT: "dot",
        Metric.COSINE: "cosine_similarity",
    }[Metric.parse(metric)]


def row_sqnorms(x: jax.Array) -> jax.Array:
    """Per-row squared norms ‖x‖² (fp32)."""
    xf = x.astype(jnp.float32)
    return jnp.sum(xf * xf, axis=-1)


def score_matrix(
    q: jax.Array,
    x: jax.Array,
    metric: Metric,
    *,
    x_sqnorm: jax.Array | None = None,
    compute_dtype: jnp.dtype | None = None,
) -> jax.Array:
    """Scores[b, n] for every query row against every corpus row.

    q: [B, D], x: [N, D]. Returns [B, N] float32, higher = better.
    ``x_sqnorm``: optional precomputed ‖x‖² [N] (fp32) — the analog of the
    reference's precomputed norms for cosine (ref: BruteForceVectorIndex.cs
    stores norms alongside vectors).
    ``compute_dtype``: dtype the matmul operands are cast to (e.g. bf16 for
    tensor-core throughput); accumulation is always fp32.
    """
    metric = Metric.parse(metric)
    if compute_dtype is not None:
        qm = q.astype(compute_dtype)
        xm = x.astype(compute_dtype)
        precision = None
    else:
        qm, xm = q, x
        # A default-precision fp32 matmul may run in TF32 on the GPU (~1e-3
        # relative error) — unacceptable for an *exact* index. Pin full fp32.
        precision = jax.lax.Precision.HIGHEST

    dots = jnp.dot(qm, xm.T, preferred_element_type=jnp.float32, precision=precision)

    if metric == Metric.INNER_PRODUCT:
        return dots
    if metric == Metric.L2:
        qq = row_sqnorms(q)
        xx = x_sqnorm if x_sqnorm is not None else row_sqnorms(x)
        d2 = qq[:, None] - 2.0 * dots + xx[None, :]
        # Clamp tiny negative values from cancellation so score <= 0.
        return -jnp.maximum(d2, 0.0)
    if metric == Metric.COSINE:
        qn = jnp.sqrt(row_sqnorms(q))
        xx = x_sqnorm if x_sqnorm is not None else row_sqnorms(x)
        xn = jnp.sqrt(xx)
        denom = jnp.maximum(qn[:, None] * xn[None, :], 1e-12)
        return dots / denom
    raise ValueError(f"unknown metric {metric}")


def rerank_exact(
    x: jax.Array,
    sqnorm: jax.Array,
    q: jax.Array,
    cand_rows: jax.Array,
    k: int,
    metric: Metric,
) -> tuple[jax.Array, jax.Array]:
    """Gather shortlisted rows and re-score them exactly; final top-k.

    The refinement stage the reference's IVF-PQ lacks (its ADC scores are
    final, ref: IvfPqVectorIndex.cs:152-199 — the source of its recall
    ceiling). On the device this is one [B, R, D] gather + one einsum — cheap next
    to the ADC scan, and it converts quantization error into ranking noise
    only within the shortlist.

    x: [N_pad, D] raw rows (fp32 or bf16 storage), sqnorm: [N_pad] fp32
    ‖x‖² of the ORIGINAL fp32 rows, q: [B, D] fp32 (pre-normalized for
    cosine), cand_rows: [B, R] int32 slab rows, -1 = missing.
    Returns ([B, k] scores, [B, k] rows), -inf/-1 for missing.
    """
    metric = Metric.parse(metric)
    safe = jnp.maximum(cand_rows, 0)
    vecs = jnp.take(x, safe, axis=0).astype(jnp.float32)     # [B, R, D]
    qf = q.astype(jnp.float32)
    # operands are fp32 here (even off a bf16 slab, post-cast) — pin HIGHEST
    # or a default-precision fp32 matmul may silently demote the "exact"
    # rerank to TF32 (CLAUDE.md invariant)
    dots = jnp.einsum("brd,bd->br", vecs, qf,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    if metric == Metric.L2:
        qq = jnp.sum(qf * qf, axis=-1)
        sq = jnp.take(sqnorm, safe, axis=0)                  # [B, R]
        scores = -jnp.maximum(qq[:, None] - 2.0 * dots + sq, 0.0)
    elif metric == Metric.INNER_PRODUCT:
        scores = dots
    else:  # COSINE
        qn = jnp.sqrt(jnp.sum(qf * qf, axis=-1))
        xn = jnp.sqrt(jnp.maximum(jnp.take(sqnorm, safe, axis=0), 1e-24))
        scores = dots / jnp.maximum(qn[:, None] * xn, 1e-12)
    scores = jnp.where(cand_rows >= 0, scores, -jnp.inf)
    vals, sel = jax.lax.top_k(scores, min(k, scores.shape[-1]))
    rows = jnp.take_along_axis(cand_rows, sel, axis=-1)
    rows = jnp.where(jnp.isfinite(vals), rows, -1)
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        rows = jnp.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
    return vals, rows


def rerank_exact_sq8res(
    codes: jax.Array,
    mins: jax.Array,
    scales: jax.Array,
    crow: jax.Array,
    cents: jax.Array,
    sqnorm: jax.Array,
    q: jax.Array,
    cand_rows: jax.Array,
    k: int,
    metric: Metric,
) -> tuple[jax.Array, jax.Array]:
    """``rerank_exact`` off a residual-SQ8 slab: x̂ = c[crow] + min + s·code.

    The memory-lean rerank storage (VERDICT r4 #2): per-row uint8 residual
    codes + (min, scale) reconstruct the row to within the CLUSTER radius's
    quantization step — measured r@10 0.9906 vs bf16's 0.9625 on the
    1M-clustered regime at 1/4 the fp32 slab bytes (2026-08-20 isolation
    experiment, perfect-shortlist rescore). Scoring runs fp32 HIGHEST on
    the reconstruction; ``sqnorm`` is ‖x̂‖² of the SAME reconstruction so
    L2 is exact up to storage rounding (the rerank_exact convention).

    codes: [N_pad, D] uint8, mins/scales/sqnorm: [N_pad] fp32,
    crow: [N_pad] int32 cluster-of-row, cents: [Kp, D] fp32.
    """
    metric = Metric.parse(metric)
    safe = jnp.maximum(cand_rows, 0)
    c8 = jnp.take(codes, safe, axis=0).astype(jnp.float32)     # [B, R, D]
    mn = jnp.take(mins, safe, axis=0)[..., None]               # [B, R, 1]
    sc = jnp.take(scales, safe, axis=0)[..., None]
    cc = jnp.take(cents, jnp.take(crow, safe, axis=0), axis=0) # [B, R, D]
    vecs = cc + mn + sc * c8
    qf = q.astype(jnp.float32)
    dots = jnp.einsum("brd,bd->br", vecs, qf,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    if metric == Metric.L2:
        qq = jnp.sum(qf * qf, axis=-1)
        sq = jnp.take(sqnorm, safe, axis=0)                    # [B, R]
        scores = -jnp.maximum(qq[:, None] - 2.0 * dots + sq, 0.0)
    elif metric == Metric.INNER_PRODUCT:
        scores = dots
    else:  # COSINE
        qn = jnp.sqrt(jnp.sum(qf * qf, axis=-1))
        xn = jnp.sqrt(jnp.maximum(jnp.take(sqnorm, safe, axis=0), 1e-24))
        scores = dots / jnp.maximum(qn[:, None] * xn, 1e-12)
    scores = jnp.where(cand_rows >= 0, scores, -jnp.inf)
    vals, sel = jax.lax.top_k(scores, min(k, scores.shape[-1]))
    rows = jnp.take_along_axis(cand_rows, sel, axis=-1)
    rows = jnp.where(jnp.isfinite(vals), rows, -1)
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        rows = jnp.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
    return vals, rows


def normalize_rows(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    """L2-normalize rows (cosine pre-normalization,
    ref: HnswVectorIndex.cs:69-85 normalizes at insert)."""
    n = jnp.sqrt(jnp.sum(x.astype(jnp.float32) ** 2, axis=-1, keepdims=True))
    return (x / jnp.maximum(n, eps)).astype(x.dtype)
