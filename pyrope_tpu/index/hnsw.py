"""HNSW graph index: host-built hierarchy, batched device beam search.

Rebuild of the reference's ``HnswVectorIndex``
(ref: src/Pyrope.GarnetServer/Vector/HnswVectorIndex.cs):

- params m (16), ef_construction (200), ef_search (10, mutable) (:30-40)
- geometric level generation λ = 1/ln(m) (:351-357)
- insert: greedy descent through upper layers (:106-134), then
  SearchLayer(ef_construction) + link + prune to M (2M at layer 0) (:141-162)
- ``SelectNeighbors`` = simple closest-M, no RNG-diversity heuristic (:327-331)
- cosine vectors normalized at insert (:69-85) and queries at search (:212-219)
- delete = tombstone only; the node keeps routing (:187-204)
- reference gap closed: Snapshot/Load are real here (ref no-ops :371-372,
  SURVEY §5.4)

Device redesign of the query path (the reference's sequential best-first
SearchLayer :281-325 is unvectorizable): a **batched beam search** with fixed
iteration count — each step expands the top-E unexpanded pool entries,
gathers their adjacency rows, masks visited/duplicate/invalid candidates,
scores E·2M candidates per query in one gathered einsum, and merges into the
pool with top-k. A per-query visited bool map plus within-step pairwise dedup
replaces the sequential visited set (SURVEY §7.6).

Graph construction is inherently sequential (insert i depends on the graph
after i−1); it runs on host over numpy (a native C++ builder is the planned
fast path), while all queries run on device.
"""

from __future__ import annotations

import functools
import heapq
import json
import math
from typing import Iterator, Optional

import jax
import jax.numpy as jnp

from pyrope_tpu.ops.scalars import device_i32
import numpy as np

from pyrope_tpu.index.base import VectorIndex
from pyrope_tpu.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu.utils.shapes import batch_bucket, round_up

DEFAULT_M = 16            # ref :30-40
DEFAULT_EF_CONSTRUCTION = 200
DEFAULT_EF_SEARCH = 10
UPPER_GREEDY_STEPS = 16   # fixed descent iterations per upper level
EXPAND_PER_STEP = 8       # E: pool entries expanded per beam iteration
# T: frontier width of the upper-layer descent. Measured at 10k clustered
# (bootstrap graph): T=1 (the reference's greedy) leaves 3/256 queries at
# recall 0 (cluster-level local maxima), T=4 leaves 1, T=8 none (0.9992).
DESCENT_BEAM = 8


def beam_schedule(ef: int, top_k: int) -> tuple[int, int]:
    """(pool, steps) for the batched beam at a given ef/k — the ONE place
    the beam budget is tuned (single-chip device_search, search_batch, and
    the sharded path must agree or recall diverges between paths). steps =
    ceil(pool/E) + 8 lets the frontier drain fully plus slack; tuned on
    uniform/clustered 100k against the sequential host oracle (r2)."""
    from pyrope_tpu.utils.shapes import round_up as _ru

    pool = int(_ru(max(ef, top_k, EXPAND_PER_STEP), 8))
    steps = max(4, -(-pool // EXPAND_PER_STEP) + 8)
    return pool, steps


def beam_search_body(
    x, x_exact, sqnorm, adj0, adj_up, alive, entry, q,
    *, metric: Metric, k: int, pool: int, steps: int, n_upper: int,
    visited_mode: str = "pool", rerank: bool = False,
):
    """Batched beam search body (greedy upper descent + layer-0 beam).
    Module-level so the sharded query-parallel wrapper
    (pyrope_tpu/parallel/sharded_hnsw.py) can shard_map the same program.

    ``x`` is the BEAM slab (any dtype — the hot gathers ride it, so bf16
    halves the device-memory bytes of the gather-bound walk); ``x_exact`` is the fp32
    slab used to re-score the final pool when ``rerank`` (bf16 rounding is
    on the order of inter-NN margins — the PQ rerank-slab lesson — so beam
    membership may be approximate but the returned top-k ordering and
    scores must come from fp32). Pass the same array for both (and
    rerank=False) to search fp32 end-to-end.

    Both loops early-exit at a fixed point: the upper descent stops when a
    step leaves every query's frontier unchanged, the layer-0 beam when no
    query holds a live unexpanded pool entry (expansion is then a no-op for
    every query: candidates not admitted to the pool can never re-enter).
    ``steps``/``UPPER_GREEDY_STEPS`` stay the hard caps, so results are
    identical to the fixed-count loops.

    ``visited_mode``:
      'pool' (default) — candidate dedup by membership in the CURRENT pool.
        Exactly equivalent to the bitmap (tested id-for-id): a node evicted
        from the pool scored <= the kth bound at eviction, the bound is
        monotone, and ties keep the incumbent (pool entries precede
        candidates in the top_k concat) — so re-scored nodes can never
        re-enter, and re-scoring a never-admitted node just re-drops it.
        Cost: a [B, C, pool] compare per step — no [B, N] visited carry
        and, critically, no per-step SCATTER into a [B, N] array (the
        bitmap variant allocates B x N bytes, 1 GB at 1M x b1024).
      'bitmap' — the original [B, N] visited array (scatter+gather).
    """
    def fn(x, x_exact, sqnorm, adj0, adj_up, alive, entry, q):
        b, d = q.shape
        qf = q.astype(jnp.float32)
        qq = jnp.sum(qf * qf, axis=-1)
        qb = qf.astype(x.dtype)  # beam-dtype query: bf16 dots on tensor cores
        # an fp32 beam slab scores at HIGHEST (the exact rerank below must
        # agree with the walk); a bf16 slab keeps the fast default
        prec = jax.lax.Precision.HIGHEST if x.dtype == jnp.float32 else None

        def node_scores(ids):
            """ids [B, C] -> metric scores [B, C]; -inf for id < 0."""
            safe = jnp.maximum(ids, 0)
            vecs = jnp.take(x, safe, axis=0)            # [B, C, D]
            dots = jnp.einsum("bcd,bd->bc", vecs, qb,
                              preferred_element_type=jnp.float32,
                              precision=prec)
            if metric == Metric.L2:
                sq = jnp.take(sqnorm, safe, axis=0)
                s = -jnp.maximum(qq[:, None] - 2.0 * dots + sq, 0.0)
            else:  # IP; cosine rows are pre-normalized so dots == cosine
                s = dots
            return jnp.where(ids >= 0, s, -jnp.inf)

        # ---- upper-layer descent (ref :229-247, widened) ------------------
        # The reference walks a single greedy pointer; a width-T frontier
        # costs T gathers but escapes the cluster-level local maxima that a
        # bulk-built routing layer (and occasionally the incremental one)
        # presents — measured on clustered corpora as the difference
        # between dead queries (recall 0) and full recall. T duplicates are
        # masked by a sort so the frontier holds T DISTINCT best nodes.
        t_beam = DESCENT_BEAM

        def dedup_sorted(ids, s):
            order = jnp.argsort(ids, axis=1)
            sid = jnp.take_along_axis(ids, order, axis=1)
            ss = jnp.take_along_axis(s, order, axis=1)
            dup = jnp.concatenate(
                [jnp.zeros((ids.shape[0], 1), bool), sid[:, 1:] == sid[:, :-1]],
                axis=1,
            )
            return sid, jnp.where(dup | (sid < 0), -jnp.inf, ss)

        fr = jnp.full((b, t_beam), entry, jnp.int32)
        fr_s = node_scores(fr)
        fr_s = fr_s.at[:, 1:].set(-jnp.inf)  # one live copy of the entry
        for lev in range(n_upper - 1, -1, -1):
            def body(carry):
                i, fr, fr_s, _ = carry
                nbrs = jnp.take(adj_up[lev], jnp.maximum(fr, 0), axis=0)
                nbrs = jnp.where(
                    jnp.isfinite(fr_s)[:, :, None], nbrs, -1
                ).reshape(b, -1)                                 # [B, T*M]
                all_ids = jnp.concatenate([fr, nbrs], axis=1)
                all_s = jnp.concatenate([fr_s, node_scores(nbrs)], axis=1)
                sid, ss = dedup_sorted(all_ids, all_s)
                nfr_s, pos = jax.lax.top_k(ss, t_beam)
                nfr = jnp.take_along_axis(sid, pos, axis=1)
                nfr = jnp.where(jnp.isfinite(nfr_s), nfr, -1)
                # fixed point: a step that moves NO query's frontier can
                # never move a later one (top_k is deterministic)
                return i + 1, nfr, nfr_s, jnp.any(nfr != fr)

            def cond(carry):
                i, _, _, changed = carry
                return (i < UPPER_GREEDY_STEPS) & changed

            _, fr, fr_s, _ = jax.lax.while_loop(
                cond, body, (jnp.int32(0), fr, fr_s, jnp.bool_(True))
            )

        # ---- layer-0 batched beam (replaces sequential SearchLayer) ------
        deg = adj0.shape[1]
        c = EXPAND_PER_STEP * deg                       # candidates per step
        n_nodes = x.shape[0]

        pool_ids = jnp.full((b, pool), -1, jnp.int32)
        pool_s = jnp.full((b, pool), -jnp.inf, jnp.float32)
        expanded = jnp.zeros((b, pool), bool)
        use_bitmap = visited_mode == "bitmap"
        visited = (
            jnp.zeros((b, n_nodes), bool) if use_bitmap
            else jnp.zeros((b, 1), bool)  # unused placeholder carry
        )

        # seed with the whole descent frontier (distinct by construction)
        pool_ids = pool_ids.at[:, :t_beam].set(
            jnp.where(jnp.isfinite(fr_s), fr, -1)
        )
        pool_s = pool_s.at[:, :t_beam].set(fr_s)
        if use_bitmap:
            visited = jax.vmap(lambda v, i, ok: v.at[i].max(ok))(
                visited, jnp.maximum(fr, 0), jnp.isfinite(fr_s)
            )

        iota_pool = jax.lax.broadcasted_iota(jnp.int32, (1, 1, pool), 2)

        def step(carry):
            i, pool_ids, pool_s, expanded, visited = carry
            unexp = jnp.where(
                (~expanded) & (pool_ids >= 0), pool_s, -jnp.inf
            )
            top_vals, pos = jax.lax.top_k(unexp, EXPAND_PER_STEP)   # [B, E]
            valid_e = jnp.isfinite(top_vals)
            hit = (pos[:, :, None] == iota_pool) & valid_e[:, :, None]
            expanded = expanded | jnp.any(hit, axis=1)

            eids = jnp.take_along_axis(pool_ids, pos, axis=1)       # [B, E]
            nbrs = jnp.take(adj0, jnp.maximum(eids, 0), axis=0)     # [B, E, deg]
            nbrs = jnp.where(valid_e[:, :, None], nbrs, -1).reshape(b, c)

            # within-step duplicate suppression: keep first occurrence only
            eq = nbrs[:, :, None] == nbrs[:, None, :]               # [B, C, C]
            tri = jnp.tril(jnp.ones((c, c), bool), k=-1)
            dup = jnp.any(eq & tri[None], axis=2)
            invalid = nbrs < 0
            if use_bitmap:
                safe = jnp.maximum(nbrs, 0)
                pre_seen = jnp.take_along_axis(visited, safe, axis=1)
                visited = jax.vmap(lambda v, idx, ok: v.at[idx].max(ok))(
                    visited, safe, ~invalid
                )
            else:
                # in-pool membership replaces the bitmap (see docstring):
                # one [B, C, pool] compare, no scatter, no [B, N] carry
                pre_seen = jnp.any(
                    nbrs[:, :, None] == pool_ids[:, None, :], axis=2
                )
            drop = pre_seen | dup | invalid

            s = node_scores(nbrs)
            s = jnp.where(drop, -jnp.inf, s)

            all_s = jnp.concatenate([pool_s, s], axis=1)
            all_ids = jnp.concatenate([pool_ids, nbrs], axis=1)
            all_exp = jnp.concatenate(
                [expanded, jnp.zeros((b, c), bool)], axis=1
            )
            pool_s, sel = jax.lax.top_k(all_s, pool)
            pool_ids = jnp.take_along_axis(all_ids, sel, axis=1)
            expanded = jnp.take_along_axis(all_exp, sel, axis=1)
            pool_ids = jnp.where(jnp.isfinite(pool_s), pool_ids, -1)
            return i + 1, pool_ids, pool_s, expanded, visited

        def unfinished(carry):
            i, pool_ids, _, expanded, _ = carry
            # fixed point: with no live unexpanded entry anywhere, every
            # further step expands nothing (evicted nodes cannot re-enter)
            return (i < steps) & jnp.any((~expanded) & (pool_ids >= 0))

        _, pool_ids, pool_s, expanded, visited = jax.lax.while_loop(
            unfinished, step,
            (jnp.int32(0), pool_ids, pool_s, expanded, visited),
        )

        if rerank:
            # exact fp32 re-score of the surviving pool: beam membership may
            # carry beam-dtype rounding, the returned ordering/scores not
            safe = jnp.maximum(pool_ids, 0)
            vecs = jnp.take(x_exact, safe, axis=0)          # [B, pool, D]
            # HIGHEST: a default-precision fp32 matmul may run in TF32 on
            # the GPU — without it the rerank reintroduces exactly the
            # rounding it exists to remove (CLAUDE.md exact-path invariant)
            dots = jnp.einsum(
                "bpd,bd->bp", vecs, qf,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            if metric == Metric.L2:
                sq = jnp.take(sqnorm, safe, axis=0)
                exact = -jnp.maximum(qq[:, None] - 2.0 * dots + sq, 0.0)
            else:
                exact = dots
            pool_s = jnp.where(
                (pool_ids >= 0) & jnp.isfinite(pool_s), exact, -jnp.inf
            )

        # final: drop tombstones, take top-k (ref tombstone filter :187-204)
        ok = (pool_ids >= 0) & jnp.take(alive, jnp.maximum(pool_ids, 0), axis=0)
        final_s = jnp.where(ok, pool_s, -jnp.inf)
        vals, sel = jax.lax.top_k(final_s, k)
        ids = jnp.take_along_axis(pool_ids, sel, axis=1)
        ids = jnp.where(jnp.isfinite(vals), ids, -1)
        return vals, ids

    return fn(x, x_exact, sqnorm, adj0, adj_up, alive, entry, q)


@functools.lru_cache(maxsize=None)
def _hnsw_search_fn(metric: Metric, k: int, pool: int, steps: int,
                    n_upper: int, visited_mode: str = "pool",
                    rerank: bool = False):
    """Jitted batched beam search at layer 0 (+ greedy upper descent)."""
    return jax.jit(functools.partial(
        beam_search_body, metric=metric, k=k, pool=pool, steps=steps,
        n_upper=n_upper, visited_mode=visited_mode, rerank=rerank,
    ))


class HnswIndex(VectorIndex):
    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        m: int = DEFAULT_M,
        ef_construction: int = DEFAULT_EF_CONSTRUCTION,
        ef_search: int = DEFAULT_EF_SEARCH,
        seed: int = 42,
        neighbor_heuristic: bool = True,
        build_mode: str = "auto",
        visited_mode: str = "pool",
        search_dtype: str = "float32",
    ):
        """``neighbor_heuristic``: diversity-heuristic neighbor selection
        (HNSW paper Alg. 4) instead of the reference's closest-M
        (ref: HnswVectorIndex.cs SelectNeighbors :327-331). Spreading links
        across directions lets the beam escape local clusters — measured
        recall wins at equal ef. False restores reference selection.

        ``build_mode`` picks the BULK construction path for ``add_batch``
        into an empty index: 'incremental' = the sequential native C++
        builder (the reference's insert algorithm); 'bootstrap' = the
        device-bootstrapped pipeline (ops/hnsw_bootstrap.py — every
        distance eval a device matmul instead of single-core host
        inserts); 'auto' = bootstrap at
        n >= 200k, incremental below. Incremental per-row ``add`` is
        unaffected. Bootstrap requires ``neighbor_heuristic`` (it IS the
        selection rule); closest-M indexes fall back to incremental."""
        if build_mode not in ("auto", "incremental", "bootstrap"):
            raise ValueError(
                f"build_mode must be auto|incremental|bootstrap, got {build_mode!r}"
            )
        if visited_mode not in ("pool", "bitmap"):
            raise ValueError(
                f"visited_mode must be pool|bitmap, got {visited_mode!r}"
            )
        if search_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"search_dtype must be bfloat16|float32, got {search_dtype!r}"
            )
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.m = int(m)
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)  # mutable, ref :30-40
        self.neighbor_heuristic = bool(neighbor_heuristic)
        self.build_mode = build_mode
        self.visited_mode = visited_mode
        # 'float32' (default): one fp32 slab end-to-end. 'bfloat16' walks a
        # bf16 beam slab and re-scores the final pool fp32, at 1.5x slab
        # memory (bf16 copy + resident fp32 rerank slab); whether it pays
        # on the GPU has not been measured.
        self.search_dtype = search_dtype
        self._ml = 1.0 / math.log(self.m)  # λ = 1/ln(m), ref :351-357
        self._rng = np.random.default_rng(seed)

        cap = 1024
        self._vecs = np.zeros((cap, self.dim), np.float32)
        self._alive = np.zeros(cap, bool)
        self._levels = np.full(cap, -1, np.int32)
        self._adj0 = np.full((cap, 2 * self.m), -1, np.int32)
        self._adj_up: list[np.ndarray] = []   # per level >= 1: [cap, M]
        self._row_ids: list[Optional[str]] = [None] * cap
        self._id_to_row: dict[str, int] = {}
        self._count = 0
        self._live = 0
        self._entry = -1
        self._top_level = -1
        self._dirty = True
        self._dev: Optional[dict] = None

    # ---- host-side scoring (higher = better) ----------------------------

    def _prep(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float32).reshape(-1)
        if v.shape[0] != self.dim:
            raise ValueError(f"dim mismatch: expected {self.dim}, got {v.shape[0]}")
        if self.metric == Metric.COSINE:  # normalize at insert (ref :69-85)
            n = np.linalg.norm(v)
            if n > 1e-12:
                v = v / n
        return v

    def _scores(self, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
        vecs = self._vecs[rows]
        dots = vecs @ q
        if self.metric == Metric.L2:
            return -np.maximum(((q * q).sum() - 2 * dots + (vecs * vecs).sum(1)), 0.0)
        return dots  # IP / normalized cosine

    # ---- capacity -------------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = self._vecs.shape[0]
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        def pad2(a, fill):
            out = np.full((new_cap,) + a.shape[1:], fill, a.dtype)
            out[:cap] = a
            return out
        self._vecs = pad2(self._vecs, 0)
        self._alive = pad2(self._alive, False)
        self._levels = pad2(self._levels, -1)
        self._adj0 = pad2(self._adj0, -1)
        self._adj_up = [pad2(a, -1) for a in self._adj_up]
        self._row_ids.extend([None] * (new_cap - cap))
        self._dev = None

    def _adj_at(self, level: int) -> np.ndarray:
        if level == 0:
            return self._adj0
        while len(self._adj_up) < level:
            self._adj_up.append(
                np.full((self._vecs.shape[0], self.m), -1, np.int32)
            )
        return self._adj_up[level - 1]

    # ---- host search-layer (build only; ref SearchLayer :281-325) --------

    def _search_layer_host(
        self, q: np.ndarray, entries: list[int], ef: int, level: int
    ) -> list[tuple[float, int]]:
        adj = self._adj_at(level)
        visited = set(entries)
        escore = {e: float(self._scores(q, np.array([e]))[0]) for e in entries}
        cand = [(-escore[e], e) for e in entries]   # max-heap by score
        heapq.heapify(cand)
        w = [(escore[e], e) for e in entries]        # min-heap: worst first
        heapq.heapify(w)
        while len(w) > ef:
            heapq.heappop(w)
        while cand:
            negs, c = heapq.heappop(cand)
            if len(w) >= ef and -negs < w[0][0]:
                break
            nbrs = [n for n in adj[c] if n >= 0 and n not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            ss = self._scores(q, np.array(nbrs))
            for n, sn in zip(nbrs, ss):
                sn = float(sn)
                if len(w) < ef or sn > w[0][0]:
                    heapq.heappush(w, (sn, int(n)))
                    heapq.heappush(cand, (-sn, int(n)))
                    if len(w) > ef:
                        heapq.heappop(w)
        return sorted(w, reverse=True)  # [(score, node)] best first

    def _greedy_descent_host(self, q: np.ndarray, start: int, level: int) -> int:
        cur = start
        cur_s = float(self._scores(q, np.array([cur]))[0])
        adj = self._adj_at(level)
        while True:
            nbrs = adj[cur]
            nbrs = nbrs[nbrs >= 0]
            if nbrs.size == 0:
                return cur
            ss = self._scores(q, nbrs)
            bi = int(np.argmax(ss))
            if ss[bi] <= cur_s:
                return cur
            cur, cur_s = int(nbrs[bi]), float(ss[bi])

    def _select_neighbors(self, cands: np.ndarray,
                          scores: np.ndarray, m_out: int) -> np.ndarray:
        """Neighbor selection from best-first (cands, scores): diversity
        heuristic (default) or the reference's closest-M. Mirrors the
        native builder's select_heuristic exactly."""
        order = np.argsort(-scores)
        cands, scores = cands[order], scores[order]
        if not self.neighbor_heuristic:
            return cands[:m_out]
        kept: list[int] = []
        rejected: list[int] = []
        for e, s in zip(cands, scores):
            if len(kept) >= m_out:
                break
            ek = self._scores(self._vecs[int(e)], np.asarray(kept, np.int64)) if kept else None
            if ek is None or not (ek > s).any():
                kept.append(int(e))
            else:
                rejected.append(int(e))
        for e in rejected:  # keepPrunedConnections backfill
            if len(kept) >= m_out:
                break
            kept.append(e)
        return np.asarray(kept, dtype=cands.dtype)

    def _link(self, a: int, b: int, level: int) -> None:
        """Add b to a's neighbor list, pruning to max-degree when full —
        closest (ref link+prune :141-162; SelectNeighbors=closest :327-331)
        or diversity-heuristic per ``neighbor_heuristic``."""
        adj = self._adj_at(level)
        row = adj[a]
        slot = np.where(row < 0)[0]
        if slot.size:
            row[slot[0]] = b
            return
        cands = np.append(row, b)
        ss = self._scores(self._vecs[a], cands)
        keep = self._select_neighbors(cands, ss, row.shape[0])
        adj[a][:] = -1
        adj[a][: keep.shape[0]] = keep

    # ---- mutation --------------------------------------------------------

    def add(self, id: str, vector: np.ndarray) -> bool:
        with self.lock:
            return self._add_locked(id, vector)

    def _add_locked(self, id: str, vector: np.ndarray) -> bool:
        row = self._id_to_row.get(id)
        if row is not None and self._alive[row]:
            return False
        v = self._prep(vector)
        if row is not None:  # revive tombstone in place, keep links
            self._vecs[row] = v
            self._alive[row] = True
            self._live += 1
            self._dirty = True
            return True
        self._grow(self._count + 1)
        row = self._count
        self._count += 1
        level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self._vecs[row] = v
        self._alive[row] = True
        self._levels[row] = level
        self._row_ids[row] = id
        self._id_to_row[id] = row
        self._live += 1
        self._dirty = True

        if self._entry < 0:
            self._entry = row
            self._top_level = level
            self._adj_at(level)  # materialize layers
            return True

        cur = self._entry
        for lev in range(self._top_level, level, -1):
            cur = self._greedy_descent_host(v, cur, lev)
        for lev in range(min(level, self._top_level), -1, -1):
            w = self._search_layer_host(v, [cur], self.ef_construction, lev)
            # neighbor selection (heuristic by default, closest-M when
            # neighbor_heuristic=False; the 2M layer-0 cap is enforced by
            # the adjacency row width inside _link)
            wc = np.asarray([n for _, n in w], np.int64)
            wsc = np.asarray([s for s, _ in w], np.float32)
            neighbors = (
                [int(x) for x in self._select_neighbors(wc, wsc, self.m)]
                if wc.size else []
            )
            adj = self._adj_at(lev)
            for n in neighbors:
                if n == row:
                    continue
                slot = np.where(adj[row] < 0)[0]
                if slot.size:
                    adj[row][slot[0]] = n
                self._link(n, row, lev)
            cur = w[0][1] if w else cur
        if level > self._top_level:
            self._entry = row
            self._top_level = level
            self._adj_at(level)
        return True

    def add_batch(self, ids, vectors) -> int:
        """Bulk build. When the index is empty and all ids are new, the
        whole graph is constructed by the native C++ builder
        (native/hnsw_builder.cc) — same algorithm and level distribution as
        the incremental path, ~100x faster than per-row Python inserts.
        Falls back to per-row adds otherwise (or without a toolchain)."""
        with self.lock:
            return self._add_batch_locked(ids, vectors)

    def _add_batch_locked(self, ids, vectors) -> int:
        vecs = np.asarray(vectors, np.float32)
        if (
            self._count > 0
            or vecs.ndim != 2
            or vecs.shape[1] != self.dim
            or len(set(ids)) != len(ids)
        ):
            return super().add_batch(ids, vecs)

        n = vecs.shape[0]
        if self.metric == Metric.COSINE:
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = np.where(norms > 1e-12, vecs / np.maximum(norms, 1e-12), vecs)
        # same geometric level draw as add() (ref :351-357)
        u = np.maximum(self._rng.random(n), 1e-12)
        levels = (-np.log(u) * self._ml).astype(np.int32)

        use_bootstrap = self.neighbor_heuristic and (
            self.build_mode == "bootstrap"
            or (self.build_mode == "auto" and n >= 200_000)
        )
        built = None
        if use_bootstrap:
            from pyrope_tpu.ops.hnsw_bootstrap import bootstrap_build

            adj0, adj_up_arr, entry, top_level, levels = bootstrap_build(
                vecs, levels, self.m, self.metric,
            )
            built = (adj0, adj_up_arr, entry, top_level)
        if built is None:
            from pyrope_tpu.native import hnsw_build_native

            built = hnsw_build_native(
                vecs, levels, self.m, self.ef_construction,
                metric_is_l2=(self.metric == Metric.L2),
                heuristic=self.neighbor_heuristic,
            )
        if built is None:
            return super().add_batch(ids, vecs)
        adj0, adj_up, entry, top_level = built
        self._grow(n)
        self._vecs[:n] = vecs
        self._alive[:n] = True
        self._levels[:n] = levels
        self._adj0[:n] = adj0
        cap = self._vecs.shape[0]
        self._adj_up = []
        for lev in range(adj_up.shape[0]):
            a = np.full((cap, self.m), -1, np.int32)
            a[:n] = adj_up[lev]
            self._adj_up.append(a)
        for row, i in enumerate(ids):
            self._row_ids[row] = i
            self._id_to_row[i] = row
        self._count = n
        self._live = n
        self._entry = entry
        self._top_level = top_level
        self._dirty = True
        return n

    def relabel(self, order: str = "cluster", seed: int = 0) -> None:
        """Permute node rows for beam-gather HBM locality (VERDICT r4 #6).

        Search results are invariant (ids, scores, and even tie-order: the
        graph is isomorphic and _row_ids moves with the rows); only the
        physical row layout changes, so neighbor gathers in the layer-0
        beam hit nearer HBM rows. Orders:
          'cluster' — k-means cell-major (neighbors are overwhelmingly
                      same-cell on clustered corpora; 128 cells, seed 42)
          'bfs'     — breadth-first from the entry point over layer 0
          'random'  — control arm for locality experiments
        """
        with self.lock:
            n = self._count
            if n <= 1:
                return
            if order == "cluster":
                from pyrope_tpu.ops.kmeans import kmeans_build

                metric = (Metric.L2 if self.metric == Metric.COSINE
                          else self.metric)
                kc = max(2, min(128, n // 64))
                _, assign, _ = kmeans_build(
                    self._vecs[:n], kc, metric, seed=42)
                new_of_old = np.argsort(np.argsort(assign, kind="stable"))
            elif order == "bfs":
                adj = self._adj0[:n]
                seen = np.zeros(n, bool)
                out = []
                from collections import deque

                for start in ([max(self._entry, 0)] + list(range(n))):
                    if seen[start]:
                        continue
                    dq = deque([start])
                    seen[start] = True
                    while dq:
                        c = dq.popleft()
                        out.append(c)
                        for nb in adj[c]:
                            if nb >= 0 and nb < n and not seen[nb]:
                                seen[nb] = True
                                dq.append(nb)
                new_of_old = np.empty(n, np.int64)
                new_of_old[np.array(out)] = np.arange(n)
            elif order == "random":
                new_of_old = np.random.default_rng(seed).permutation(n)
            else:
                raise ValueError(f"order must be cluster|bfs|random, got {order!r}")
            old_of_new = np.argsort(new_of_old)

            def remap_vals(a):
                out = np.where(a >= 0, new_of_old[np.maximum(a, 0)], -1)
                return out.astype(np.int32)

            cap = self._vecs.shape[0]
            for name in ("_vecs", "_alive", "_levels"):
                arr = getattr(self, name)
                arr[:n] = arr[:n][old_of_new]
            self._adj0[:n] = remap_vals(self._adj0[:n][old_of_new])
            for a in self._adj_up:
                a[:n] = remap_vals(a[:n][old_of_new])
            ids = [self._row_ids[int(r)] for r in old_of_new]
            for new, rid in enumerate(ids):
                self._row_ids[new] = rid
                if rid is not None:
                    self._id_to_row[rid] = new
            for r in range(n, cap):
                self._row_ids[r] = None
            if self._entry >= 0:
                self._entry = int(new_of_old[self._entry])
            self._dirty = True

    def upsert(self, id: str, vector: np.ndarray) -> None:
        with self.lock:
            row = self._id_to_row.get(id)
            if row is None:
                self._add_locked(id, vector)
                return
            if not self._alive[row]:
                self._live += 1
            self._vecs[row] = self._prep(vector)  # in-place update, links kept
            self._alive[row] = True
            self._dirty = True

    def delete(self, id: str) -> bool:
        with self.lock:
            row = self._id_to_row.get(id)
            if row is None or not self._alive[row]:
                return False
            self._alive[row] = False  # tombstone only (ref :187-204)
            self._live -= 1
            self._dirty = True
            return True

    # ---- device sync + query ---------------------------------------------

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        with self.lock:
            return self._sync_locked()

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        n = max(self._count, 1)
        npad = round_up(n, 8)
        x = np.zeros((npad, self.dim), np.float32)
        x[: self._count] = self._vecs[: self._count]
        sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
        adj0 = np.full((npad, 2 * self.m), -1, np.int32)
        adj0[: self._count] = self._adj0[: self._count]
        alive = np.zeros(npad, bool)
        alive[: self._count] = self._alive[: self._count]
        n_upper = len(self._adj_up)
        if n_upper:
            up = np.full((n_upper, npad, self.m), -1, np.int32)
            for i, a in enumerate(self._adj_up):
                up[i, : self._count] = a[: self._count]
        else:
            up = np.full((1, npad, self.m), -1, np.int32)  # dummy, unused
        x_exact = jnp.asarray(x)
        self._dev = {
            # beam slab: bf16 halves the gather bytes of the walk; the fp32
            # slab stays resident for the final-pool rerank (1.5x memory,
            # same tradeoff as the IVF-PQ fp32 refine slab)
            "x": (
                x_exact.astype(jnp.bfloat16)
                if self.search_dtype == "bfloat16" else x_exact
            ),
            "x_exact": x_exact,
            "sqnorm": jnp.asarray(sq),
            "adj0": jnp.asarray(adj0),
            "adj_up": jnp.asarray(up),
            "alive": jnp.asarray(alive),
            "n_upper": n_upper,
        }
        self._dirty = False
        return self._dev

    def device_search(
        self, q: jax.Array, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[jax.Array, jax.Array]:
        """Device-resident beam search; q [B, D] on device (pre-normalized
        for COSINE). Returns device (scores [B, k], node rows [B, k])."""
        if self._count == 0 or self._entry < 0:
            raise RuntimeError("device_search on empty index")
        ef = options.ef_search or self.ef_search
        pool, steps = beam_schedule(ef, top_k)
        dev = self._sync()
        search_metric = (
            Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric
        )
        fn = _hnsw_search_fn(search_metric, top_k, pool, steps,
                             dev["n_upper"], self.visited_mode,
                             self.search_dtype == "bfloat16")
        return fn(
            dev["x"], dev["x_exact"], dev["sqnorm"], dev["adj0"],
            dev["adj_up"], dev["alive"], device_i32(self._entry), q,
        )

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        return [
            [self._row_ids[int(r)] or "" if r >= 0 else "" for r in row]
            for row in rows
        ]

    def search_batch(
        self,
        queries: np.ndarray,
        top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> list[list[SearchResult]]:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: expected {self.dim}, got {q.shape[1]}")
        if self._count == 0 or self._entry < 0:
            return [[] for _ in range(q.shape[0])]
        if self.metric == Metric.COSINE:
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.maximum(norms, 1e-12)

        ef = options.ef_search or self.ef_search
        pool, steps = beam_schedule(ef, top_k)
        b = q.shape[0]
        bb = batch_bucket(b)
        qp = np.pad(q, ((0, bb - b), (0, 0))) if bb != b else q

        dev = self._sync()
        search_metric = (
            Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric
        )
        fn = _hnsw_search_fn(search_metric, top_k, pool, steps,
                             dev["n_upper"], self.visited_mode,
                             self.search_dtype == "bfloat16")
        vals, rows = fn(
            dev["x"], dev["x_exact"], dev["sqnorm"], dev["adj0"],
            dev["adj_up"], dev["alive"], device_i32(self._entry),
            jnp.asarray(qp),
        )
        vals = np.asarray(vals)[:b]
        rows = np.asarray(rows)[:b]
        out: list[list[SearchResult]] = []
        for bi in range(b):
            hits = []
            for v, r in zip(vals[bi], rows[bi]):
                if r < 0 or not np.isfinite(v):
                    continue
                rid = self._row_ids[int(r)]
                if rid is not None:
                    hits.append(SearchResult(rid, float(v)))
            out.append(hits)
        return out

    # ---- lifecycle --------------------------------------------------------

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        for row in range(self._count):
            if self._alive[row] and self._row_ids[row] is not None:
                yield self._row_ids[row], self._vecs[row].copy()

    def get_stats(self) -> IndexStats:
        return IndexStats(count=self._live, dim=self.dim, metric=self.metric)

    def snapshot(self, path: str) -> None:
        """Real graph snapshot (reference HNSW Snapshot is a no-op :371-372)."""
        n = self._count
        meta = json.dumps({
            "format": "pyrope_tpu.hnsw.v1",
            "dim": self.dim,
            "metric": self.metric.value,
            "m": self.m,
            "ef_construction": self.ef_construction,
            "ef_search": self.ef_search,
            "neighbor_heuristic": self.neighbor_heuristic,
            "entry": self._entry,
            "top_level": self._top_level,
            "count": n,
        })
        np.savez_compressed(
            path,
            meta=np.str_(meta),
            vecs=self._vecs[:n],
            alive=self._alive[:n],
            levels=self._levels[:n],
            adj0=self._adj0[:n],
            adj_up=np.stack([a[:n] for a in self._adj_up]) if self._adj_up else np.zeros((0, n, self.m), np.int32),
            ids=np.array([self._row_ids[r] or "" for r in range(n)], dtype=np.str_),
        )

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("format") != "pyrope_tpu.hnsw.v1":
                raise ValueError(f"bad snapshot format: {meta.get('format')}")
            if int(meta["dim"]) != self.dim:
                raise ValueError("snapshot dim mismatch")
            self.metric = Metric.parse(meta["metric"])
            self.m = int(meta["m"])
            self.ef_construction = int(meta["ef_construction"])
            self.ef_search = int(meta["ef_search"])
            self.neighbor_heuristic = bool(meta.get("neighbor_heuristic", True))
            self._ml = 1.0 / math.log(self.m)
            n = int(meta["count"])
            cap = max(1024, round_up(n, 1024))
            self._vecs = np.zeros((cap, self.dim), np.float32)
            self._alive = np.zeros(cap, bool)
            self._levels = np.full(cap, -1, np.int32)
            self._adj0 = np.full((cap, 2 * self.m), -1, np.int32)
            self._vecs[:n] = z["vecs"]
            self._alive[:n] = z["alive"]
            self._levels[:n] = z["levels"]
            self._adj0[:n] = z["adj0"]
            up = np.asarray(z["adj_up"])
            self._adj_up = []
            for i in range(up.shape[0]):
                a = np.full((cap, self.m), -1, np.int32)
                a[:n] = up[i]
                self._adj_up.append(a)
            ids = [str(s) for s in z["ids"]]
            self._row_ids = [i if i else None for i in ids] + [None] * (cap - n)
            self._id_to_row = {i: r for r, i in enumerate(ids) if i}
            self._count = n
            self._live = int(self._alive[:n].sum())
            self._entry = int(meta["entry"])
            self._top_level = int(meta["top_level"])
        self._dirty = True
        self._dev = None
