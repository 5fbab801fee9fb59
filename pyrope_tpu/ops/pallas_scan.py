"""Fused corpus scan + running top-k: one Pallas kernel, Triton route.

The XLA path (ops/distance.score_matrix + mask + lax.top_k) writes the
[B, N] score matrix to device memory and reads it back to select. This
kernel never materializes it: each block holds a tile of queries and
a contiguous range of slab rows ("split-N"), streams that range through a
loop of row tiles, scores each tile with one ``pl.dot`` and keeps the
block's running top-k in registers. Blocks run in parallel and in no
order; each writes its own sorted [bt, kslots] candidate list, and one
``lax.top_k`` over the [B, splits * kslots] candidates finishes the
selection.

One kernel serves both callers:

- flat scan: a row survives iff it is alive and ``row < max_scans``;
- dense IVF scan: additionally ``pos[row] < allowed[query, crow[row]]`` —
  a per-row lookup of the row's cluster in the query's probe table, which
  holds each probed list's scan budget (0 = not probed). That is exactly
  ``index/ivf_flat.dense_probe_mask``, evaluated per tile instead of as a
  [B, N] mask.

Semantics match ops/topk.masked_topk(..., selection="exact"): scores
follow the engine convention (L2 -> -d², IP -> dot; cosine callers
pre-normalize rows and use IP), equal scores prefer the lower slab row
(lax.top_k's rule), and missing hits report score -inf and index -1.
bf16 slabs score bf16 x bf16 on the tensor cores with fp32 accumulation;
fp32 slabs score with the IEEE fp32 dot (``Precision.HIGHEST``).

Where it runs: the hybrid selection's bf16 shortlist scan
(index/flat._hybrid_search_fn, index/ivf_flat._ivf_dense_pallas_hybrid_fn),
where it beat XLA's bf16 matmul + top_k by 3-13x on the H100 at the
kernel-phase shapes of chip_smoke.py (scripts/kernel_bench.py repeats the
measurement). Exact fp32 scans stay on XLA: Triton lowers the IEEE fp32
dot to CUDA-core FMAs, which lost to cuBLAS + top_k at k=10 (PERF.md,
"Kernel decisions"). fp32 slabs still run here, at Precision.HIGHEST, for
the interpret-mode tests.

Slabs of any size address correctly: row and column indices are int32,
and Pallas's Triton lowering forms a ref's offsets in 64 bits once the
array exceeds 4 GiB.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pyrope_tpu.types import Metric
from pyrope_tpu.utils.shapes import next_pow2

ROW_TILE = 128        # slab rows scored per loop step (one pl.dot)
MAX_BATCH_TILE = 64   # queries per block
MAX_COL_TILE = 128    # feature columns per pl.dot (wider rows loop over chunks)
TARGET_BLOCKS = 512   # enough blocks in flight to fill every SM several times
NUM_WARPS = 4

NEG_INF = -3.4e38     # finite "masked" sentinel (kernels capture python floats)
_FILL = 3.4e38        # value of the slots beyond k: never the running worst


def interpret_mode() -> bool:
    """Whether Pallas kernels run in the interpreter: only on the CPU
    backend (the tests). On the GPU they compile through Triton. Any other
    backend has no route and raises rather than silently interpreting."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas route for backend {backend!r} (supported: gpu, or cpu "
        "in interpret mode)"
    )


def _plan(b: int, n: int, d: int, kslots: int) -> dict:
    """Static tiling: batch tile, column chunks, and the split of the slab
    into per-block row ranges (whole row tiles)."""
    bt = max(16, min(MAX_BATCH_TILE, next_pow2(b)))
    if kslots > 64:
        bt = min(bt, 32)  # the [bt, kslots] running list lives in registers
    dk = max(16, min(MAX_COL_TILE, next_pow2(d)))
    tiles = max(1, -(-n // ROW_TILE))
    nb = -(-b // bt)
    splits = max(1, min(tiles, -(-TARGET_BLOCKS // nb)))
    tiles_per = -(-tiles // splits)
    splits = -(-tiles // tiles_per)
    return {"bt": bt, "dk": dk, "nk": -(-d // dk), "nb": nb,
            "splits": splits, "tiles_per": tiles_per}


def _scan_kernel(ms_ref, q_ref, qq_ref, x_ref, sq_ref, alive_ref, *refs,
                 k: int, kslots: int, metric: Metric, n: int, d: int,
                 bt: int, dk: int, nk: int, tiles_per: int, ivf: bool):
    if ivf:
        crow_ref, pos_ref, allowed_ref, vals_ref, idx_ref = refs
    else:
        vals_ref, idx_ref = refs
    qrows = pl.program_id(0) * bt + jnp.arange(bt, dtype=jnp.int32)
    row0 = pl.program_id(1) * (tiles_per * ROW_TILE)
    x_dtype = x_ref.dtype
    prec = jax.lax.Precision.HIGHEST if x_dtype == jnp.float32 else None

    def q_chunk(c):
        cols = c * dk + jnp.arange(dk, dtype=jnp.int32)
        qc = plgpu.load(q_ref.at[qrows[:, None], cols[None, :]])
        return qc.astype(x_dtype)

    q_hoisted = q_chunk(0) if nk == 1 else None
    qq = qq_ref[qrows][:, None] if metric == Metric.L2 else None
    if not ivf:
        ms = ms_ref[0]
    slot = jax.lax.broadcasted_iota(jnp.int32, (bt, kslots), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (bt, ROW_TILE), 1)

    def tile(t, carry):
        rv, ri = carry
        r0 = row0 + t * ROW_TILE
        rows = r0 + jnp.arange(ROW_TILE, dtype=jnp.int32)
        inb = rows < n
        dots = jnp.zeros((bt, ROW_TILE), jnp.float32)
        for c in range(nk):
            cols = c * dk + jnp.arange(dk, dtype=jnp.int32)
            xm = inb[:, None] & (cols < d)[None, :]
            xt = plgpu.load(x_ref.at[rows[:, None], cols[None, :]],
                            mask=xm, other=0)
            qc = q_hoisted if nk == 1 else q_chunk(c)
            dots += jax.lax.dot_general(
                qc, xt.astype(x_dtype), (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32, precision=prec,
            )
        live = plgpu.load(alive_ref.at[rows], mask=inb, other=False)
        if ivf:
            crow = plgpu.load(crow_ref.at[rows], mask=inb, other=0)
            pos = plgpu.load(pos_ref.at[rows], mask=inb, other=0)
            budget = plgpu.load(
                allowed_ref.at[qrows[:, None], crow[None, :]],
                mask=inb[None, :], other=0)
            valid = live[None, :] & (pos[None, :] < budget)
        else:
            valid = (live & (rows < ms))[None, :]
        if metric == Metric.L2:
            sq = plgpu.load(sq_ref.at[rows], mask=inb, other=0.0)
            scores = -jnp.maximum(qq - 2.0 * dots + sq[None, :], 0.0)
        else:
            scores = dots
        scores = jnp.where(valid, scores, NEG_INF)

        # Insert the tile's entries, best first, while some query's best
        # remaining entry beats its running worst. Tile rows are higher
        # than every row already held, so a tie never displaces.
        def insert(c):
            sc, rv, ri, best, worst, _ = c
            am = jnp.min(jnp.where(sc == best, col, ROW_TILE), axis=1,
                         keepdims=True)
            worst_i = jnp.max(jnp.where(rv == worst, ri, -2), axis=1,
                              keepdims=True)
            ws = jnp.min(jnp.where((rv == worst) & (ri == worst_i), slot,
                                   kslots), axis=1, keepdims=True)
            put = (best > worst) & (slot == ws)
            rv = jnp.where(put, best, rv)
            ri = jnp.where(put, r0 + am, ri)
            sc = jnp.where(col == am, NEG_INF, sc)
            best = jnp.max(sc, axis=1, keepdims=True)
            worst = jnp.min(rv, axis=1, keepdims=True)
            go = jnp.max(jnp.where(best > worst, 1, 0)) > 0
            return sc, rv, ri, best, worst, go

        best = jnp.max(scores, axis=1, keepdims=True)
        worst = jnp.min(rv, axis=1, keepdims=True)
        go = jnp.max(jnp.where(best > worst, 1, 0)) > 0
        _, rv, ri, _, _, _ = jax.lax.while_loop(
            lambda c: c[5], insert, (scores, rv, ri, best, worst, go))
        return rv, ri

    rv = jnp.where(slot < k, NEG_INF, _FILL)
    ri = jnp.full((bt, kslots), -1, jnp.int32)
    rv, ri = jax.lax.fori_loop(0, tiles_per, tile, (rv, ri))

    # Emit the block's list sorted by (score desc, row asc), so that
    # lax.top_k's lower-position rule over the concatenated lists of all
    # splits is also the lower-row rule.
    rv = jnp.where(slot < k, rv, NEG_INF)
    ri = jnp.where(slot < k, ri, -1)
    big = jnp.iinfo(jnp.int32).max

    def emit(j, c):
        rv, ov, oi = c
        m = jnp.max(rv, axis=1, keepdims=True)
        mi = jnp.min(jnp.where(rv == m, ri, big), axis=1, keepdims=True)
        ov = jnp.where(slot == j, m, ov)
        oi = jnp.where(slot == j, mi, oi)
        rv = jnp.where((rv == m) & (ri == mi), -jnp.inf, rv)
        return rv, ov, oi

    _, ov, oi = jax.lax.fori_loop(
        0, k, emit, (rv, jnp.full((bt, kslots), NEG_INF, jnp.float32),
                     jnp.full((bt, kslots), -1, jnp.int32)))
    vals_ref[...] = ov
    idx_ref[...] = oi


@functools.lru_cache(maxsize=None)
def _build(metric: Metric, k: int, b: int, n: int, d: int, ivf: bool,
           interpret: bool):
    kslots = max(16, next_pow2(k))
    p = _plan(b, n, d, kslots)
    bt = p["bt"]
    kernel = functools.partial(
        _scan_kernel, k=k, kslots=kslots, metric=metric, n=n, d=d, bt=bt,
        dk=p["dk"], nk=p["nk"], tiles_per=p["tiles_per"], ivf=ivf,
    )
    out_block = pl.BlockSpec((bt, kslots), lambda i, s: (i, s))
    width = p["splits"] * kslots
    call = pl.pallas_call(
        kernel,
        grid=(p["nb"], p["splits"]),
        out_specs=[out_block, out_block],
        out_shape=[
            jax.ShapeDtypeStruct((p["nb"] * bt, width), jnp.float32),
            jax.ShapeDtypeStruct((p["nb"] * bt, width), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name=f"fused_scan_topk_{'ivf' if ivf else 'flat'}",
    )
    return call, p


def _fused_topk(q, x, sqnorm, alive, k, metric, ms, ivf_tables):
    """Pad the query batch to the block tile, run the kernel, merge the
    per-split candidate lists. Traceable (callers jit around it)."""
    metric = Metric.parse(metric)
    if metric == Metric.COSINE:
        raise ValueError("pre-normalize rows and use IP for cosine")
    b, d = q.shape
    n = x.shape[0]
    if x.shape[1] != d:
        raise ValueError(f"dim mismatch: q {q.shape} vs slab {x.shape}")
    ivf = ivf_tables is not None
    interpret = interpret_mode()
    call, p = _build(metric, k, b, n, d, ivf, interpret)
    bp = p["nb"] * p["bt"]
    qf = q.astype(jnp.float32)
    dpad = p["nk"] * p["dk"]
    qp = jnp.pad(qf, ((0, bp - b), (0, dpad - d)))
    qq = jnp.sum(qp * qp, axis=-1)
    ms = jnp.reshape(jnp.asarray(ms, jnp.int32), (1,))
    args = [ms, qp, qq, x, sqnorm, alive]
    if ivf:
        crow, pos, allowed = ivf_tables
        allowed = jnp.pad(allowed.astype(jnp.int32), ((0, bp - b), (0, 0)))
        args += [crow.astype(jnp.int32), pos.astype(jnp.int32), allowed]
    cand_v, cand_i = call(*args)
    vals, pos_ = jax.lax.top_k(cand_v[:b], k)
    idx = jnp.take_along_axis(cand_i[:b], pos_, axis=1)
    idx = jnp.where(vals > NEG_INF, idx, -1)
    vals = jnp.where(idx < 0, -jnp.inf, vals)
    return vals, idx


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def pallas_flat_topk(q, x, sqnorm, alive, max_scans, k: int,
                     metric: Metric = Metric.L2):
    """Fused masked flat scan + exact top-k. q [B, D], x [N, D] fp32/bf16
    slab, sqnorm [N] fp32, alive [N] bool; rows at or past ``max_scans``
    (int or traced int32 scalar: shard_map bodies pass a per-shard budget)
    are skipped. Returns ([B, k] scores, [B, k] rows), -inf/-1 missing."""
    return _fused_topk(q, x, sqnorm, alive, k, metric, max_scans, None)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def pallas_ivf_topk(q, x, sqnorm, alive, crow, pos, allowed, k: int,
                    metric: Metric = Metric.L2):
    """Fused dense-mask IVF scan + exact top-k over a cluster-major slab.

    crow [N] cluster of each row, pos [N] its position inside its list,
    allowed [B, Kp] int32 per-query scan budget of each list (0 for lists
    the query does not probe; see ``index/ivf_flat.probe_budget_table``).
    Returns ([B, k], [B, k]) with the masked_topk missing-hit convention."""
    return _fused_topk(q, x, sqnorm, alive, k, metric, 0,
                       (crow, pos, allowed))
