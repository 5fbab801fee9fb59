"""Device-bootstrapped HNSW construction.

The incremental builder (native/hnsw_builder.cc — the reference's insert
algorithm, ref: HnswVectorIndex.cs:106-162) is inherently sequential:
insert i depends on the graph after i−1, so a 1M-row build walks ONE host
core while the device idles. This module replaces construction with a bulk
pipeline where every distance evaluation is a device matmul:

1. coarse k-means over the corpus (device, ops/kmeans.py)
2. layer-0 candidates: every node's top-R neighbors within its ``nprobe``
   nearest clusters — the corpus queried against itself through the IVF
   probe-scan kernel (ops shared with index/ivf_flat.py)
3. diversity-heuristic neighbor selection (HNSW paper Alg. 4, the same rule
   the incremental builders apply) VECTORIZED over nodes: candidate→node
   and candidate-pairwise scores are batched einsums, the sequential
   keep/reject walk becomes an unrolled mask loop over candidate ranks
4. symmetrization: reverse edges unioned in (host, vectorized numpy), then
   a second device selection pass prunes each union back to max degree —
   bulk KNN graphs are directed, and beam search needs in-links to reach
   low-degree nodes
5. upper layers: exact KNN among the level-l subset (geometrically shrinking:
   ~n/m^l nodes) + the same selection/symmetrization

The result is the same data structure the incremental builders produce
(adj0 [n, 2m], adj_up per level [n, m], entry, top level) and is searched
by the identical batched beam. Construction differs from insertion-order
builds (candidates come from cluster probes, not from searching a partial
graph), so graphs are not byte-identical — parity is measured in recall:
tests/test_hnsw.py compares bootstrap vs incremental recall on the same
corpus, and the hnsw1m_clustered bench row carries the measured number.
"""

from __future__ import annotations

import functools
import logging
import time

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

from pyrope_tpu.ops.kmeans import kmeans_build
from pyrope_tpu.ops.scalars import device_i32
from pyrope_tpu.types import Metric

# layer-0 candidate pool per node (before selection; ~2x the layer-0
# degree — measured recall lever: 48 -> 64 gained +0.03 at 100k clustered
# while nprobe 8 -> 16 gained nothing), and clusters probed per node
DEFAULT_KNN_R = 64
DEFAULT_NPROBE = 8
CHUNK = 4096


def _scores_to_node(x, sqnorm, node_ids, cand_ids, metric: Metric):
    """score(cand -> node) [C, R]; -inf for invalid (-1) or self."""
    nv = jnp.take(x, node_ids, axis=0)                       # [C, D]
    cv = jnp.take(x, jnp.maximum(cand_ids, 0), axis=0)       # [C, R, D]
    dots = jnp.einsum("crd,cd->cr", cv, nv,
                      preferred_element_type=jnp.float32)
    if metric == Metric.L2:
        nn = jnp.take(sqnorm, node_ids)[:, None]
        cc = jnp.take(sqnorm, jnp.maximum(cand_ids, 0), axis=0)
        s = -jnp.maximum(nn - 2.0 * dots + cc, 0.0)
    else:
        s = dots
    bad = (cand_ids < 0) | (cand_ids == node_ids[:, None])
    return jnp.where(bad, -jnp.inf, s)


@functools.lru_cache(maxsize=None)
def _select_fn(metric: Metric, r: int, deg: int):
    """Jitted: sort candidates best-first, run the diversity heuristic with
    keep-pruned backfill (mirrors native select_heuristic / the Python
    _select_neighbors), return up to ``deg`` neighbor ids per node."""

    @jax.jit
    def fn(x, sqnorm, node_ids, cand_ids):
        s = _scores_to_node(x, sqnorm, node_ids, cand_ids, metric)
        svals, sel = jax.lax.top_k(s, r)                     # best-first
        cand = jnp.take_along_axis(cand_ids, sel, axis=1)    # [C, R]
        valid = jnp.isfinite(svals)
        cand = jnp.where(valid, cand, -1)

        cv = jnp.take(x, jnp.maximum(cand, 0), axis=0)       # [C, R, D]
        pd = jnp.einsum("crd,csd->crs", cv, cv,
                        preferred_element_type=jnp.float32)
        if metric == Metric.L2:
            cc = jnp.take(sqnorm, jnp.maximum(cand, 0), axis=0)
            pw = -jnp.maximum(cc[:, :, None] - 2.0 * pd + cc[:, None, :], 0.0)
        else:
            pw = pd

        c = cand.shape[0]
        # Alg. 4 walk over candidate ranks (fori_loop: unrolling r≈50 ranks
        # would bloat the compile): keep e iff e is
        # closer to the node than to every already-kept neighbor
        def walk(rank, carry):
            kept, kcount = carry
            pw_r = jax.lax.dynamic_index_in_dim(pw, rank, 1, keepdims=False)
            s_r = jax.lax.dynamic_index_in_dim(svals, rank, 1, keepdims=True)
            v_r = jax.lax.dynamic_index_in_dim(valid, rank, 1, keepdims=False)
            closer_to_kept = jnp.any(kept & (pw_r > s_r), axis=1)
            take = v_r & ~closer_to_kept & (kcount < deg)
            kept = jax.lax.dynamic_update_index_in_dim(
                kept, take, rank, 1
            )
            return kept, kcount + take.astype(jnp.int32)

        def backfill(rank, carry):  # keepPrunedConnections, rank order
            kept, kcount = carry
            k_r = jax.lax.dynamic_index_in_dim(kept, rank, 1, keepdims=False)
            v_r = jax.lax.dynamic_index_in_dim(valid, rank, 1, keepdims=False)
            take = v_r & ~k_r & (kcount < deg)
            kept = jax.lax.dynamic_update_index_in_dim(
                kept, k_r | take, rank, 1
            )
            return kept, kcount + take.astype(jnp.int32)

        kept = jnp.zeros((c, r), bool)
        kcount = jnp.zeros((c,), jnp.int32)
        kept, kcount = jax.lax.fori_loop(0, r, walk, (kept, kcount))
        kept, kcount = jax.lax.fori_loop(0, r, backfill, (kept, kcount))

        # pack kept candidates left, preserving best-first order (pad with
        # -1 when the pool is narrower than the requested degree)
        iota = jax.lax.broadcasted_iota(jnp.int32, (c, r), 1)
        key = jnp.where(kept, iota, r + iota)
        d_eff = min(deg, r)
        order = jnp.argsort(key, axis=1)[:, :d_eff]
        out = jnp.take_along_axis(cand, order, axis=1)
        ok = jnp.take_along_axis(kept, order, axis=1)
        out = jnp.where(ok, out, -1)
        if d_eff < deg:
            out = jnp.pad(out, ((0, 0), (0, deg - d_eff)), constant_values=-1)
        return out

    return fn


def _chunked_select(x, sqnorm, node_ids: np.ndarray, cand: np.ndarray,
                    deg: int, metric: Metric) -> np.ndarray:
    """Run _select_fn over fixed-size chunks (static shapes; tail padded)."""
    n, r = cand.shape
    chunk = min(CHUNK, n)
    fn = _select_fn(metric, r, deg)
    out = np.empty((n, deg), np.int32)
    # dispatch every chunk asynchronously, fetch afterwards: a blocking
    # per-chunk np.asarray turns each chunk into a full host round trip
    # (~245 serialized round trips per pass at 1M rows)
    pending = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        if e - s == chunk:
            nb, cb = node_ids[s:e], cand[s:e]
        else:  # fresh tail buffers: reuse would race the async upload
            nb = np.zeros(chunk, np.int32)
            cb = np.full((chunk, r), -1, np.int32)
            nb[: e - s] = node_ids[s:e]
            cb[: e - s] = cand[s:e]
        pending.append((s, e, fn(x, sqnorm, jnp.asarray(nb), jnp.asarray(cb))))
    for s, e, res in pending:
        out[s:e] = np.asarray(res)[: e - s]
    return out


def _descend_candidates(adj: np.ndarray, j: int = 2) -> np.ndarray:
    """One NN-descent expansion: each node's current neighbors plus the
    first ``j`` neighbors of each neighbor. Cluster-probe candidates see
    only the local neighborhood; descent pulls in two-hop candidates that
    the incremental builder's adaptive ef_construction search would have
    found, which is where its recall edge comes from."""
    n, deg = adj.shape
    nn = adj[np.maximum(adj, 0), :j]                # [n, deg, j], no [n,deg,deg]
    nn[adj < 0] = -1
    return np.concatenate([adj, nn.reshape(n, deg * j)], axis=1)


def _graft_components(adj: np.ndarray, xperm, sqnorm, n: int,
                      metric: Metric) -> np.ndarray:
    """Connect stray graph components to the main one.

    A bulk KNN graph is only locally linked: an isolated cluster can form
    its own component, and every query whose truth lives there scores 0 —
    incremental HNSW never has this failure because early inserts lay
    long-range links while the graph is sparse. Detect (weak) components,
    then for each stray component bridge its representative bidirectionally
    to its nearest node in the main component (one masked device scan for
    all representatives at once)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    deg = adj.shape[1]
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = adj.reshape(-1)
    ok = dst >= 0
    g = sp.coo_matrix(
        (np.ones(int(ok.sum()), np.int8), (src[ok], dst[ok])), shape=(n, n)
    )
    ncomp, labels = connected_components(g, directed=True, connection="weak")
    if ncomp <= 1:
        return adj
    counts = np.bincount(labels, minlength=ncomp)
    main = int(np.argmax(counts))
    comp_ids, first_idx = np.unique(labels, return_index=True)
    reps = first_idx[comp_ids != main].astype(np.int32)
    logger.info("hnsw_bootstrap grafting %d stray components", reps.size)

    in_main = np.zeros(xperm.shape[0], bool)
    in_main[:n] = labels == main

    # slab as jit arg, not closure (HLO-constant / HTTP 413 — see knn_block)
    @jax.jit
    def nearest_in_main(xperm, sqnorm, rep_ids, mask):
        q = jnp.take(xperm, rep_ids, axis=0).astype(jnp.bfloat16)
        dots = jnp.dot(q, xperm.astype(jnp.bfloat16).T,
                       preferred_element_type=jnp.float32)
        if metric == Metric.L2:
            s = -(jnp.take(sqnorm, rep_ids)[:, None] - 2.0 * dots
                  + sqnorm[None, :])
        else:
            s = dots
        return jnp.argmax(jnp.where(mask[None, :], s, -jnp.inf), axis=1)

    nn = np.asarray(
        nearest_in_main(xperm, sqnorm, jnp.asarray(reps), jnp.asarray(in_main))
    )
    out = adj.copy()
    for rep, tgt in zip(reps.tolist(), nn.tolist()):
        for a, b in ((rep, tgt), (tgt, rep)):
            row = out[a]
            slot = np.flatnonzero(row < 0)
            row[slot[0] if slot.size else deg - 1] = b
    return out


def _symmetrize(adj: np.ndarray, n: int, rev_cap: int) -> np.ndarray:
    """Union each node's out-edges with up to ``rev_cap`` reverse edges
    (vectorized CSR grouping; duplicates collapsed to -1 — the follow-up
    device selection re-sorts by score, so order need not be preserved)."""
    deg = adj.shape[1]
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = adj.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    ds, ss = dst[order], src[order]
    counts = np.bincount(ds, minlength=n)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    pos = np.arange(ds.size, dtype=np.int64) - offs[ds]
    keep = pos < rev_cap
    in_adj = np.full((n, rev_cap), -1, np.int32)
    in_adj[ds[keep], pos[keep]] = ss[keep]
    union = np.concatenate([adj, in_adj], axis=1)
    su = np.sort(union, axis=1)
    su[:, 1:][su[:, 1:] == su[:, :-1]] = -1       # dedup
    su[su == np.arange(n, dtype=np.int32)[:, None]] = -1  # drop self
    return su


def _fill_tail_slots(row: np.ndarray, take: list[int]) -> None:
    """Write ``take`` into ``row`` in place: free (-1) slots first, then the
    tail-most OCCUPIED slots. Skips slots already claimed in this call —
    free slots frequently sit at the row tail, so blind ``m-1-j`` indexing
    would overwrite a link written a previous iteration (the highway-slot
    collision: two of four cross-cluster links silently lost on exactly the
    routing-backbone nodes)."""
    free = np.flatnonzero(row < 0)
    slots = list(free[: len(take)])
    if len(take) > len(slots):
        used = set(slots)
        slots += [s for s in range(len(row) - 1, -1, -1)
                  if s not in used][: len(take) - len(slots)]
    for slot, t in zip(slots, take):
        row[slot] = t


def _layer0_candidates(xperm, sqnorm, cents: np.ndarray, offsets: np.ndarray,
                       lens: np.ndarray, n: int, l_pad: int, knn_r: int,
                       nprobe: int, metric: Metric) -> np.ndarray:
    """Top-(R) KNN of the (permuted) corpus against itself.

    Key asymmetry vs the serving probe-scan kernel: queries here ARE corpus
    rows, and rows of one cluster share (approximately) one probe set — so
    probes are resolved PER CLUSTER (nearest clusters by centroid), and
    each (cluster chunk) x (probed cluster) pair is one dense contiguous
    matmul. No per-query gather replication: total traffic is
    n·nprobe·l_pad rows of pure matmul work. The centroid-level probe
    approximation costs a little candidate precision at cluster borders;
    the diversity-selection stage absorbs it (R ≈ 3x the out-degree).
    """

    k = knn_r + 1  # self lands in the list; selection masks it
    kc = cents.shape[0]
    qb = min(CHUNK, xperm.shape[0])  # slab is always >= 256 (slab_pad)
    d = xperm.shape[1]

    # per-cluster probe sets by centroid L2 (own cluster ranks first)
    cc = np.einsum("kd,kd->k", cents, cents)
    cd2 = cc[:, None] - 2.0 * (cents @ cents.T) + cc[None, :]
    np_eff = min(nprobe, kc)
    probe_sets = np.argsort(cd2, axis=1, kind="stable")[:, :np_eff].astype(np.int32)

    # Plan every block up front and ship the probe/block tables to the
    # device ONCE: the per-cluster `jnp.asarray(offsets[probe_sets[c]])`
    # pattern this replaces issued ~2 fresh H2D uploads per cluster plus a
    # blocking D2H per block — ~1.5k serializing round trips at 1M rows. Blocks index device-resident tables by a small reused block id,
    # dispatch asynchronously, and results are fetched after the full
    # dispatch.
    #
    # Blocks are also TIERED by their probe set's max list length: list
    # lengths are skewed on clustered corpora (the bench corpus pads
    # l_pad to the global max while most lists are several times shorter),
    # and the probe matmul's cost is the padded length — one compiled
    # variant per power-of-two tier keeps the scan proportional to real
    # list mass instead of nb * l_pad_max (before tiering this phase
    # dominated the 1M build).
    blocks: list[tuple[int, int, int, int]] = []  # (s, e, q_off, cluster)
    for c in range(kc):
        if lens[c] == 0:
            continue
        start, end = int(offsets[c]), int(offsets[c] + lens[c])
        for s in range(start, end, qb):
            e = min(s + qb, end)
            q_off = s if e - s == qb else max(e - qb, 0)
            blocks.append((s, e, q_off, c))
    probe_offs_d = jnp.asarray(offsets[probe_sets])          # [kc, np_eff]
    probe_lens_d = jnp.asarray(lens[probe_sets])             # [kc, np_eff]
    blk_qoff_d = jnp.asarray(
        np.array([b[2] for b in blocks], np.int32))          # [nb]
    blk_c_d = jnp.asarray(np.array([b[3] for b in blocks], np.int32))

    # NB: the slab MUST be a jit argument, not a closure — closed-over
    # device arrays are embedded as HLO constants, so a 1M x 128 slab would
    # be copied into the compiled program.
    @functools.lru_cache(maxsize=None)
    def knn_block_fn(tier: int):
        @jax.jit
        def knn_block(xperm, sqnorm, probe_offs, probe_lens,
                      blk_qoff, blk_c, bi):
            q_off = blk_qoff[bi]
            offs_probe = probe_offs[blk_c[bi]]
            lens_probe = probe_lens[blk_c[bi]]
            q = jax.lax.dynamic_slice(xperm, (q_off, 0), (qb, d))
            qsq = jax.lax.dynamic_slice(sqnorm, (q_off,), (qb,))
            qf = q.astype(jnp.bfloat16)
            # one [qb, D] x [D, P*tier] matmul over the concatenated probe
            # slices + ONE selection op: the previous per-probe merge ran 8
            # sort-based top_k's per block, which dominated the phase (the
            # matmuls are a rounding error at these shapes). approx_max_k
            # (PartialReduce) fuses into the matmul epilogue; candidate
            # recall_target 0.98 is absorbed by the diversity-selection /
            # descent / symmetrize stages downstream (A/B'd at 1M).
            xs = jnp.concatenate([
                jax.lax.dynamic_slice(xperm, (offs_probe[p], 0), (tier, d))
                for p in range(np_eff)
            ], axis=0)                                       # [P*tier, D]
            ssq = jnp.concatenate([
                jax.lax.dynamic_slice(sqnorm, (offs_probe[p],), (tier,))
                for p in range(np_eff)
            ], axis=0)
            dots = jnp.dot(qf, xs.astype(jnp.bfloat16).T,
                           preferred_element_type=jnp.float32)
            if metric == Metric.L2:
                s = -jnp.maximum(qsq[:, None] - 2.0 * dots + ssq[None, :], 0.0)
            else:
                s = dots
            t_i = jax.lax.broadcasted_iota(jnp.int32, (np_eff, tier), 1)
            valid = (t_i < lens_probe[:, None]).reshape(1, -1)
            rows = (offs_probe[:, None] + t_i).reshape(-1)   # [P*tier]
            s = jnp.where(valid, s, -jnp.inf)
            vals, ci = jax.lax.approx_max_k(s, k, recall_target=0.98)
            return jnp.where(jnp.isfinite(vals), jnp.take(rows, ci), -1)

        return knn_block

    # tier = max probed list length, rounded up to a power-of-two multiple
    # of 128 and capped at l_pad (slices stay in-bounds: the slab is padded
    # by a full l_pad tail, see slab_pad)
    probe_max = lens[probe_sets].max(axis=1)                 # [kc]
    tiers = np.array([
        min(128 * (1 << max(-(-int(pm) // 128) - 1, 0).bit_length()), l_pad)
        for pm in np.maximum(probe_max, 1)
    ], np.int64)
    results = [
        knn_block_fn(int(tiers[c]))(
            xperm, sqnorm, probe_offs_d, probe_lens_d,
            blk_qoff_d, blk_c_d, device_i32(bi))
        for bi, (_s, _e, _q, c) in enumerate(blocks)
    ]
    out = np.empty((n, k), np.int32)
    for (s, e, q_off, _c), res in zip(blocks, results):
        out[s:e] = np.asarray(res)[s - q_off : s - q_off + (e - s)]
    return out


def _subset_knn(x, sqnorm, subset: np.ndarray, k: int, metric: Metric,
                chunk: int = 2048) -> np.ndarray:
    """Exact KNN (global ids) among a subset of rows: [ns, k]."""
    ns = subset.shape[0]
    sub_dev = jnp.asarray(subset)
    sv = jnp.take(x, sub_dev, axis=0)                        # [ns, D]
    ssq = jnp.take(sqnorm, sub_dev)

    # subset slab as jit arg, not closure (HLO-constant / HTTP 413)
    @jax.jit
    def score_chunk(sv, ssq, sub_dev, qi):
        q = jnp.take(sv, qi, axis=0)
        dots = jnp.einsum("cd,nd->cn", q.astype(jnp.bfloat16),
                          sv.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
        if metric == Metric.L2:
            s = -(jnp.take(ssq, qi)[:, None] - 2.0 * dots + ssq[None, :])
        else:
            s = dots
        _, idx = jax.lax.top_k(s, min(k, ns))
        return jnp.take(sub_dev, idx)                        # global ids

    out = np.full((ns, k), -1, np.int32)
    keff = min(k, ns)
    pending = []
    for s in range(0, ns, chunk):
        e = min(s + chunk, ns)
        qi = np.arange(s, e, dtype=np.int32)
        if e - s < chunk:
            qi = np.pad(qi, (0, chunk - (e - s)))
        pending.append((s, e, score_chunk(sv, ssq, sub_dev, jnp.asarray(qi))))
    for s, e, res in pending:
        out[s:e, :keff] = np.asarray(res)[: e - s]
    return out


def bootstrap_build(
    vecs: np.ndarray,
    levels: np.ndarray,
    m: int,
    metric: Metric,
    *,
    knn_r: int = DEFAULT_KNN_R,
    nprobe: int = DEFAULT_NPROBE,
    descent_rounds: int = 1,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray, int, int, np.ndarray]:
    """Build the full HNSW layer stack on device.

    vecs [n, D] float32 (cosine rows pre-normalized by the caller), levels
    [n] int32 pre-drawn. Returns (adj0 [n, 2m], adj_up [max_level, n, m],
    entry, top_level, levels) in the INPUT row space — levels may differ
    from the input by cluster-representative promotions to level 1 (every
    k-means cluster is guaranteed a routing-layer node).
    """
    from pyrope_tpu.index.ivf_flat import slab_pad
    from pyrope_tpu.ops.slab import pad_order, take_slab
    from pyrope_tpu.utils.shapes import round_up

    n, dim = vecs.shape
    sm = Metric.INNER_PRODUCT if metric == Metric.COSINE else metric
    nlist = int(np.clip(n // 1000, 16, 4000))
    nlist = min(nlist, n)
    t_start = time.perf_counter()

    def _mark(stage: str) -> None:
        logger.info("hnsw_bootstrap %s at %.1fs", stage,
                    time.perf_counter() - t_start)

    # ---- coarse partition + cluster-major device slab -------------------
    # partition is always L2 (for COSINE/IP the caller's rows are already
    # normalized, so L2 proximity == angular proximity)
    cents, assign, x_dev = kmeans_build(
        vecs, nlist, Metric.L2, seed=seed, compute_dtype="bfloat16",
    )
    kc = cents.shape[0]
    order = np.argsort(assign, kind="stable").astype(np.int64)
    lens = np.bincount(assign, minlength=kc).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    l_pad = int(round_up(max(int(lens.max()), 1), 128))
    npad = slab_pad(n, l_pad)
    xperm, sqnorm = take_slab(x_dev, pad_order(order, npad, x_dev.shape[0]))
    _mark("kmeans+slab")

    # ---- layer 0: probe-KNN -> select -> symmetrize -> select -----------
    cand = _layer0_candidates(
        xperm, sqnorm, cents[:kc], offsets, lens, n, l_pad, knn_r, nprobe, sm,
    )
    _mark("knn candidates")
    node_ids = np.arange(n, dtype=np.int32)
    deg0 = 2 * m
    adj0_p = _chunked_select(xperm, sqnorm, node_ids, cand, deg0, sm)
    _mark("select pass 1")
    for _ in range(descent_rounds):
        grown = _descend_candidates(adj0_p)
        adj0_p = _chunked_select(xperm, sqnorm, node_ids, grown, deg0, sm)
        _mark("descent round")
    union = _symmetrize(adj0_p, n, rev_cap=m)
    adj0_p = _chunked_select(xperm, sqnorm, node_ids, union, deg0, sm)
    _mark("symmetrize+select")
    adj0_p = _graft_components(adj0_p, xperm, sqnorm, n, sm)
    _mark("graft")

    # ---- upper layers (subset exact KNN + cluster highways) ---------------
    # The routing layers are where a bulk build loses to incremental
    # construction: pure within-layer KNN is cluster-local, so the greedy
    # descent hits local maxima crossing clusters (measured: every failed
    # query landed ~7 cluster-radii from its truth). Two repairs:
    # (a) every k-means cluster gets at least one level-1 node (promote the
    #     row nearest its centroid), so the routing layer covers the space;
    # (b) each level-1 node's candidate pool is unioned with the level-1
    #     REPRESENTATIVE of its cluster's nearest clusters — explicit
    #     inter-cluster highways the diversity heuristic then keeps (they
    #     are far from every intra-cluster link).
    levels_perm = levels[order].copy()
    crow_perm = np.repeat(np.arange(kc, dtype=np.int32), lens)
    d2own_host: np.ndarray | None = None

    def _d2own() -> np.ndarray:
        """Distance of every (permuted) row to its own centroid — computed
        on device in one pass (the host-slab alternative fetched the full
        512 MB slab back at 1M); D2H is [n] fp32."""
        nonlocal d2own_host
        if d2own_host is None:
            @jax.jit
            def fn(xperm, sqnorm, crow_d, cents_d):
                x = xperm[: crow_d.shape[0]].astype(jnp.float32)
                cg = jnp.take(cents_d, crow_d, axis=0)
                dots = jnp.einsum("nd,nd->n", x, cg,
                                  preferred_element_type=jnp.float32)
                csq = jnp.einsum("nd,nd->n", cg, cg,
                                 preferred_element_type=jnp.float32)
                return sqnorm[: crow_d.shape[0]] - 2.0 * dots + csq

            d2own_host = np.asarray(
                fn(xperm, sqnorm, jnp.asarray(crow_perm), jnp.asarray(cents))
            )
        return d2own_host

    def _cluster_reps(sub_mask: np.ndarray) -> np.ndarray:
        """Per cluster: the masked row nearest its centroid (-1 if none) —
        segmented argmin over the device-computed row→centroid distances."""
        d2 = _d2own()
        reps = np.full(kc, -1, np.int32)
        rows = np.flatnonzero(sub_mask)
        if rows.size == 0:
            return reps
        cr = crow_perm[rows]
        order_r = np.lexsort((d2[rows], cr))
        rs, cs = rows[order_r], cr[order_r]
        first = np.concatenate([[True], cs[1:] != cs[:-1]])
        reps[cs[first]] = rs[first]
        return reps

    # (a) promotion: clusters with no level>=1 node
    has_l1 = np.zeros(kc, bool)
    has_l1[np.unique(crow_perm[levels_perm >= 1])] = True
    if not has_l1.all():
        reps_all = _cluster_reps(np.ones(n, bool))
        for c in np.flatnonzero(~has_l1):
            if reps_all[c] >= 0:
                levels_perm[reps_all[c]] = 1

    cc_h = np.einsum("kd,kd->k", cents, cents)
    cd2_h = cc_h[:, None] - 2.0 * (cents @ cents.T) + cc_h[None, :]
    cluster_nn = np.argsort(cd2_h, axis=1, kind="stable")[:, 1:9]  # 8 nearest

    top = int(levels_perm.max(initial=0))
    adj_up_p = []
    for lev in range(1, top + 1):
        subset = np.flatnonzero(levels_perm >= lev).astype(np.int32)
        a = np.full((n, m), -1, np.int32)
        if subset.size > 1:
            c_up = _subset_knn(xperm, sqnorm, subset,
                               min(knn_r, subset.size) + 1, sm)
            sel = _chunked_select(xperm, sqnorm, subset, c_up, m, sm)
            # symmetrize within the layer (ids are global; group by subset)
            dense = np.full((n, m), -1, np.int32)
            dense[subset] = sel
            uni = _symmetrize(dense, n, rev_cap=m)[subset]
            sel = _chunked_select(xperm, sqnorm, subset, uni, m, sm)
            # (b) highways: the REPRESENTATIVE node of each cluster gets its
            # nearest clusters' representatives appended in its tail slots —
            # an explicit backbone for cross-cluster routing that leaves
            # every other node's locally-selected links untouched
            sub_mask = np.zeros(n, bool)
            sub_mask[subset] = True
            reps = _cluster_reps(sub_mask)
            live = np.flatnonzero(reps >= 0)
            pos_in_subset = {int(r): i for i, r in enumerate(subset)}
            for c in live:
                u = int(reps[c])
                i = pos_in_subset[u]
                targets = [int(t) for t in reps[cluster_nn[c]]
                           if t >= 0 and t != u and t not in sel[i]]
                row = sel[i]
                n_free = int((row < 0).sum())
                take = targets[: max(n_free, min(4, m // 4))]
                _fill_tail_slots(row, take)
            a[subset] = sel
        adj_up_p.append(a)
    _mark("upper layers")

    # ---- map back to input row space -------------------------------------
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    order32 = order.astype(np.int32)

    def to_orig(a):
        mapped = np.where(a >= 0, order32[np.maximum(a, 0)], -1)
        out = np.empty_like(mapped)
        out[order] = mapped  # row p describes original row order[p]
        return out

    adj0 = to_orig(adj0_p)
    adj_up = (
        np.stack([to_orig(a) for a in adj_up_p])
        if adj_up_p else np.zeros((0, n, m), np.int32)
    )
    levels_out = np.empty(n, np.int32)
    levels_out[order] = levels_perm  # includes cluster-rep promotions
    top_rows = np.flatnonzero(levels_out == top)
    entry = int(top_rows[0]) if top_rows.size else 0
    return adj0, adj_up, entry, top, levels_out
