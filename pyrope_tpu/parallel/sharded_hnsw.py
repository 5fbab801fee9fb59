"""Query-sharded HNSW: replicated graph, query batch split over the mesh.

The HNSW beam search is a per-query graph walk — there is no corpus axis to
shard cheaply (splitting the graph would need cross-shard neighbor hops
every step, i.e. an all-to-all per beam iteration). The idiomatic
device layout is therefore **replicate the graph, shard the queries**: each
device runs the identical batched beam program (index/hnsw.py
beam_search_body) on its slice of the batch; no collectives are needed and
throughput scales linearly with devices. Memory bound: the graph (vectors +
int32 adjacency) must fit one device — at m=16/dim=128 that is ~45M vectors
per 16 GB chip; corpora beyond that belong to sharded IVF/IVF-PQ
(SURVEY §5.8: the reference has NO distribution story at all).

Completes the sharded family matrix from VERDICT r1 #6.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyrope_tpu.index.hnsw import HnswIndex, beam_schedule, beam_search_body
from pyrope_tpu.ops.scalars import device_i32
from pyrope_tpu.parallel.mesh import DATA_AXIS, default_mesh
from pyrope_tpu.types import (
    DEFAULT_SEARCH_OPTIONS,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu.utils.shapes import round_up


def make_sharded_hnsw_search(
    mesh: Mesh, metric: Metric, k: int, pool: int, steps: int, n_upper: int,
    axis: str = DATA_AXIS, rerank: bool = False,
):
    """shard_map over the query batch: graph arrays replicated, q sharded
    over ``axis``, per-device beam, outputs sharded (no collectives)."""
    body = functools.partial(
        beam_search_body, metric=metric, k=k, pool=pool, steps=steps,
        n_upper=n_upper, rerank=rerank,
    )
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(None, None), P(None, None), P(None), P(None, None),
            P(None, None, None), P(None), P(),
            P(axis, None),                        # queries sharded
        ),
        out_specs=(P(axis, None), P(axis, None)),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedHnswIndex(HnswIndex):
    """HnswIndex whose query batches fan out over a device mesh. Host API
    and graph construction identical to HnswIndex; batches are padded to a
    mesh-size multiple before dispatch."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 10,
        seed: int = 42,
        neighbor_heuristic: bool = True,
        search_dtype: str = "float32",
    ):
        self.mesh = mesh if mesh is not None else default_mesh()
        self._ndev = self.mesh.devices.size
        super().__init__(
            dim, metric, m=m, ef_construction=ef_construction,
            ef_search=ef_search, seed=seed,
            neighbor_heuristic=neighbor_heuristic,
            search_dtype=search_dtype,
        )
        self._fn_cache: dict = {}

    def _replicated(self, dev: dict) -> dict:
        """Pin graph arrays to an explicitly replicated sharding on the
        mesh (host-built numpy uploads land on device 0 otherwise)."""
        if dev.get("_mesh_replicated"):
            return dev
        rep = NamedSharding(self.mesh, P())
        # in fp32 mode x_exact IS x — replicate the slab once and alias,
        # not twice (the vector slab dominates: 512 MB at 1M x 128 fp32)
        x_aliases_exact = dev["x_exact"] is dev["x"]
        for key in ("x", "x_exact", "sqnorm", "adj0", "adj_up", "alive"):
            if key == "x_exact" and x_aliases_exact:
                dev[key] = dev["x"]
                continue
            dev[key] = jax.device_put(dev[key], rep)
        dev["_mesh_replicated"] = True
        return dev

    def device_search(
        self, q: jax.Array, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[jax.Array, jax.Array]:
        if self._count == 0 or self._entry < 0:
            raise RuntimeError("device_search on empty index")
        b = q.shape[0]
        if b % self._ndev:
            raise ValueError(
                f"query batch {b} must be a multiple of the mesh size "
                f"{self._ndev} (search_batch pads automatically)"
            )
        ef = options.ef_search or self.ef_search
        pool, steps = beam_schedule(ef, top_k)
        dev = self._replicated(self._sync())
        axis = self.mesh.axis_names[0]
        rerank = self.search_dtype == "bfloat16"
        key = (top_k, pool, steps, dev["n_upper"], self.metric, axis, rerank)
        fn = self._fn_cache.get(key)
        if fn is None:
            search_metric = (
                Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric
            )
            fn = self._fn_cache[key] = make_sharded_hnsw_search(
                self.mesh, search_metric, top_k, pool, steps, dev["n_upper"],
                axis=axis, rerank=rerank,
            )
        return fn(
            dev["x"], dev["x_exact"], dev["sqnorm"], dev["adj0"],
            dev["adj_up"], dev["alive"], device_i32(self._entry), q,
        )

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
        b = q.shape[0]
        bb = round_up(b, self._ndev)
        qp = np.pad(q, ((0, bb - b), (0, 0))) if bb != b else q
        vals, rows = self.device_search(jnp.asarray(qp), top_k, options)
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


# ---- corpus-sharded HNSW (VERDICT r4 #7) ------------------------------------
# The query-sharded class above replicates the graph: fine for throughput,
# memory-capped at one device's memory. The class
# below PARTITIONS the corpus over the mesh — a k-means cell (capacity-
# balanced) per shard, an independent sub-graph per cell — so graph memory
# scales with mesh size like the sharded IVF/PQ families. Query = replicate
# the batch, per-shard beam over the local sub-graph, ONE ICI all_gather of
# the [B, k] local winners + top-k merge (the same merge contract as
# parallel/sharded_flat.py). Beam work per shard shrinks with n/ndev, so
# the fan-out costs far less than ndev independent full searches.
#
# Recall note: searching ndev cell-local sub-graphs with the same ef is the
# classic partitioned-ANN recipe (cells are k-means-coherent, so a query's
# true neighbors concentrate in one or two shards and THOSE shards' beams
# find them with a full-width pool); parity vs the replicated single graph
# is pinned by tests/test_sharded.py on the 8-device CPU mesh.


def make_sharded_hnsw_corpus_search(
    mesh: Mesh, metric: Metric, k: int, pool: int, steps: int, n_upper: int,
    stride: int, axis: str = DATA_AXIS,
):
    """shard_map over the GRAPH: every graph array carries a leading
    [ndev] shard axis (sharded over ``axis``), queries replicate, each
    device beams its own sub-graph, local rows are rebased to the global
    candidate space (shard * stride + local), and one all_gather + top-k
    produces replicated [B, k] outputs."""
    body = functools.partial(
        beam_search_body, metric=metric, k=k, pool=pool, steps=steps,
        n_upper=n_upper, rerank=False,
    )

    def shard_fn(x, sqnorm, adj0, adj_up, alive, entries, q):
        # per-device blocks keep a leading length-1 shard axis: drop it
        vals, rows = body(x[0], x[0], sqnorm[0], adj0[0], adj_up[0],
                          alive[0], entries[0], q)
        sidx = jax.lax.axis_index(axis)
        rows = jnp.where(rows >= 0, rows + sidx * stride, -1)
        av = jax.lax.all_gather(vals, axis)              # [nd, B, k] via ICI
        ar = jax.lax.all_gather(rows, axis)
        nd = av.shape[0]
        b = q.shape[0]
        av = jnp.moveaxis(av, 0, 1).reshape(b, nd * k)
        ar = jnp.moveaxis(ar, 0, 1).reshape(b, nd * k)
        v, sel = jax.lax.top_k(av, k)
        r = jnp.take_along_axis(ar, sel, axis=-1)
        return v, jnp.where(jnp.isfinite(v), r, -1)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(axis, None, None),                  # x [nd, npad, D]
            P(axis, None),                        # sqnorm
            P(axis, None, None),                  # adj0
            P(axis, None, None, None),            # adj_up
            P(axis, None),                        # alive
            P(axis),                              # entries
            P(None, None),                        # q replicated
        ),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedHnswCorpusIndex:
    """HNSW partitioned over the mesh: per-shard k-means cell + sub-graph.

    Scaling contract: graph memory per device is ~1/ndev of the corpus
    (vectors + adjacency), closing the one family without a data-sharded
    variant (VERDICT r4 #7). Writes before build() buffer on host; build()
    partitions (k-means cells, capacity-balanced to ceil(n/ndev)) and
    builds the sub-graphs; later adds route to the least-loaded shard's
    incremental insert, deletes to the owning shard's tombstone."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 10,
        seed: int = 42,
        neighbor_heuristic: bool = True,
        build_mode: str = "auto",
    ):
        self.mesh = mesh if mesh is not None else default_mesh()
        self._ndev = int(self.mesh.devices.size)
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.m = int(m)
        self.ef_search = int(ef_search)
        self._sub_kwargs = dict(
            m=m, ef_construction=ef_construction, ef_search=ef_search,
            seed=seed, neighbor_heuristic=neighbor_heuristic,
            build_mode=build_mode,
        )
        self.seed = seed
        self._subs: list[HnswIndex] = []
        self._buf_ids: list[str] = []
        self._buf_vecs: list[np.ndarray] = []
        self._buf_pos: dict[str, int] = {}
        self._owner: dict[str, int] = {}      # id -> shard (post-build)
        self._dev: Optional[dict] = None
        self._fn_cache: dict = {}

    # ---- mutation --------------------------------------------------------

    def add(self, id: str, vector: np.ndarray) -> bool:
        if self._subs:
            if id in self._owner:
                return False
            s = min(range(self._ndev),
                    key=lambda i: self._subs[i].get_stats().count)
            if self._subs[s].add(id, vector):
                self._owner[id] = s
                self._dev = None
                return True
            return False
        if id in self._buf_pos:
            return False
        self._buf_pos[id] = len(self._buf_ids)
        self._buf_ids.append(id)
        self._buf_vecs.append(np.asarray(vector, np.float32).reshape(-1))
        return True

    def add_batch(self, ids, vectors) -> int:
        vectors = np.asarray(vectors, np.float32)
        return sum(self.add(i, v) for i, v in zip(ids, vectors))

    def delete(self, id: str) -> bool:
        s = self._owner.get(id)
        if s is not None:
            if self._subs[s].delete(id):
                self._dev = None
                return True
            return False
        pos = self._buf_pos.pop(id, None)
        if pos is None:
            return False
        self._buf_ids[pos] = None
        return True

    # ---- build: partition + per-shard sub-graphs --------------------------

    def build(self) -> None:
        pairs = [(i, v) for i, v in zip(self._buf_ids, self._buf_vecs)
                 if i is not None]
        if not pairs or self._subs:
            return
        ids = [p[0] for p in pairs]
        x = np.stack([p[1] for p in pairs])
        n = x.shape[0]
        nd = self._ndev
        cells = self._partition(x, nd)
        self._subs = [HnswIndex(self.dim, self.metric, **self._sub_kwargs)
                      for _ in range(nd)]
        for s in range(nd):
            rows = np.flatnonzero(cells == s)
            if rows.size:
                self._subs[s].add_batch([ids[r] for r in rows], x[rows])
                self._subs[s].build()
            for r in rows:
                self._owner[ids[r]] = s
        self._buf_ids, self._buf_vecs, self._buf_pos = [], [], {}
        self._dev = None

    def _partition(self, x: np.ndarray, nd: int) -> np.ndarray:
        """k-means cells capacity-balanced to ceil(n/nd): coherent shards
        (a query's true neighbors concentrate on few shards) with bounded
        skew (the memory contract needs max cell ~ n/nd)."""
        from pyrope_tpu.ops.kmeans import kmeans_build

        n = x.shape[0]
        if nd == 1:
            return np.zeros(n, np.int32)
        metric = Metric.L2 if self.metric == Metric.COSINE else self.metric
        _, assign, _ = kmeans_build(x, nd, metric, seed=self.seed)
        assign = np.asarray(assign, np.int32).copy()
        cap = -(-n // nd)
        counts = np.bincount(assign, minlength=nd)
        spill = []
        for c in range(nd):
            if counts[c] > cap:
                rows = np.flatnonzero(assign == c)
                spill.extend(rows[cap:])   # deterministic overflow tail
                counts[c] = cap
        for r in spill:
            tgt = int(np.argmin(counts))
            assign[r] = tgt
            counts[tgt] += 1
        return assign

    # ---- query -----------------------------------------------------------

    def _sync(self) -> dict:
        if self._dev is not None:
            return self._dev
        if not self._subs:
            raise RuntimeError("call build() first")
        devs = [s._sync() for s in self._subs]
        nd = self._ndev
        npad = max(d["x"].shape[0] for d in devs)
        n_upper = max(d["n_upper"] for d in devs)
        x = np.zeros((nd, npad, self.dim), np.float32)
        sq = np.zeros((nd, npad), np.float32)
        adj0 = np.full((nd, npad, 2 * self.m), -1, np.int32)
        up = np.full((nd, max(n_upper, 1), npad, self.m), -1, np.int32)
        alive = np.zeros((nd, npad), bool)
        entries = np.zeros(nd, np.int32)
        for s, d in enumerate(devs):
            ns = d["x"].shape[0]
            x[s, :ns] = np.asarray(d["x_exact"], np.float32)
            sq[s, :ns] = np.asarray(d["sqnorm"])
            adj0[s, :ns] = np.asarray(d["adj0"])
            u = np.asarray(d["adj_up"])
            if d["n_upper"]:
                up[s, : d["n_upper"], :ns] = u
            alive[s, :ns] = np.asarray(d["alive"])
            entries[s] = max(self._subs[s]._entry, 0)
        shard = lambda *dims: NamedSharding(self.mesh, P(DATA_AXIS, *dims))
        self._dev = {
            # one device_put per array against the sharded layout: each
            # device receives ONLY its sub-graph block (the memory contract)
            "x": jax.device_put(x, shard(None, None)),
            "sqnorm": jax.device_put(sq, shard(None)),
            "adj0": jax.device_put(adj0, shard(None, None)),
            "adj_up": jax.device_put(up, shard(None, None, None)),
            "alive": jax.device_put(alive, shard(None)),
            "entries": jax.device_put(entries, shard()),
            "n_upper": n_upper,
            "stride": npad,
        }
        return self._dev

    def device_search(
        self, q: jax.Array, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[jax.Array, jax.Array]:
        dev = self._sync()
        ef = options.ef_search or self.ef_search
        pool, steps = beam_schedule(ef, top_k)
        axis = self.mesh.axis_names[0]
        key = (top_k, pool, steps, dev["n_upper"], dev["stride"], axis)
        fn = self._fn_cache.get(key)
        if fn is None:
            search_metric = (
                Metric.INNER_PRODUCT if self.metric == Metric.COSINE
                else self.metric
            )
            fn = self._fn_cache[key] = make_sharded_hnsw_corpus_search(
                self.mesh, search_metric, top_k, pool, steps,
                dev["n_upper"], dev["stride"], axis=axis,
            )
        return fn(dev["x"], dev["sqnorm"], dev["adj0"], dev["adj_up"],
                  dev["alive"], dev["entries"], q)

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
        if not self._subs:
            return [[] for _ in range(q.shape[0])]
        if self.metric == Metric.COSINE:
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.maximum(norms, 1e-12)
        vals, rows = self.device_search(jnp.asarray(q), top_k, options)
        vals, rows = np.asarray(vals), np.asarray(rows)
        stride = self._dev["stride"]
        out: list[list[SearchResult]] = []
        for bi in range(q.shape[0]):
            hits = []
            for v, r in zip(vals[bi], rows[bi]):
                if r < 0 or not np.isfinite(v):
                    continue
                s, local = divmod(int(r), stride)
                rid = self._subs[s]._row_ids[local]
                if rid is not None:
                    hits.append(SearchResult(rid, float(v)))
            out.append(hits)
        return out

    def search(self, query, top_k, options=DEFAULT_SEARCH_OPTIONS):
        return self.search_batch(query, top_k, options)[0]

    # ---- lifecycle --------------------------------------------------------

    def get_stats(self):
        from pyrope_tpu.types import IndexStats

        count = sum(s.get_stats().count for s in self._subs) + sum(
            1 for i in self._buf_ids if i is not None
        )
        return IndexStats(count=count, dim=self.dim, metric=self.metric)

    def memory_bytes(self) -> dict:
        """Per-device graph bytes: the scaling contract (each device holds
        ONE sub-graph block of the stacked arrays)."""
        if self._dev is None:
            return {}
        d = self._dev
        total = sum(int(np.prod(d[k].shape)) * d[k].dtype.itemsize
                    for k in ("x", "sqnorm", "adj0", "adj_up", "alive"))
        return {"graph_total": total, "graph_per_device": total // self._ndev}

    def snapshot(self, path: str) -> None:
        """Manifest + one sub-graph snapshot per shard (HnswIndex snapshots
        are real here — the reference's are no-ops, HnswVectorIndex.cs:371)."""
        import json as _json

        for s, sub in enumerate(self._subs):
            sub.snapshot(f"{path}.shard{s}.npz")
        meta = {"format": "pyrope_tpu.sharded_hnsw.v1", "ndev": self._ndev,
                "dim": self.dim, "metric": self.metric.value,
                "owner": self._owner}
        with open(path, "w") as f:
            _json.dump(meta, f)

    def load(self, path: str) -> None:
        import json as _json

        with open(path) as f:
            meta = _json.load(f)
        if meta.get("format") != "pyrope_tpu.sharded_hnsw.v1":
            raise ValueError(f"bad snapshot format: {meta.get('format')}")
        if int(meta["ndev"]) != self._ndev:
            raise ValueError(
                f"snapshot mesh size {meta['ndev']} != mesh {self._ndev}")
        self.metric = Metric.parse(meta["metric"])
        self._subs = []
        for s in range(self._ndev):
            sub = HnswIndex(self.dim, self.metric, **self._sub_kwargs)
            sub.load(f"{path}.shard{s}.npz")
            self._subs.append(sub)
        self._owner = {k: int(v) for k, v in meta["owner"].items()}
        self._buf_ids, self._buf_vecs, self._buf_pos = [], [], {}
        self._dev = None
