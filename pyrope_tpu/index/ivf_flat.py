"""IVF-Flat index: coarse k-means + exact scans of probed inverted lists.

Rebuild of the reference's ``IvfFlatVectorIndex``
(ref: src/Pyrope.GarnetServer/Vector/IvfFlatVectorIndex.cs):

- pre-build writes land in a mutable buffer, searched exactly (:17,39-54,
  :170-180); here the buffer is a FlatIndex
- ``build()`` merges main + buffer, runs k-means (k = min(nlist, N), seed 42)
  and assigns rows to inverted lists (:85-145)
- query ranks all centroids, probes the top ``nprobe`` (default 3,
  ``CombineNProbe`` :14) lists, honors ``max_scans``/``nprobe`` overrides
  (:151-158, 183-219)
- exposes centroids post-build (:314-325, ICentroidsProvider)

Device layout: rows are permuted cluster-major into one contiguous slab
(CSR: offsets + lengths). Two scan kernels share identical probe semantics:

- ``probe`` (sparse): per-probe contiguous dynamic-slice of the slab +
  [B, L_pad] score kernel with a running top-k merge. Work scales with
  nprobe·L_pad, but the per-query slicing replicates the slab traffic B
  times — it only pays off when the probed fraction is tiny relative to N.
- ``dense``: ONE pass over the whole slab for the batch (XLA's score
  matmul + top_k) masked by cluster membership — row r survives iff its
  cluster is in the query's probe set and its within-list position is
  inside the max_scans budget. Both kernels return identical hit sets.
  Default ``scan_mode="auto"`` picks dense whenever one slab pass is
  cheaper than the gather blowup.

Invariant: an id lives either in the built main slab or in the buffer,
never both (upsert tombstones the main row first), so merges need no dedup.
"""

from __future__ import annotations

import functools
import json
from typing import Iterator, Optional

import jax
import jax.numpy as jnp

from pyrope_tpu.ops.scalars import device_i32
import numpy as np

from pyrope_tpu.index.base import CentroidsProvider, VectorIndex
from pyrope_tpu.index.flat import FlatIndex
from pyrope_tpu.ops.distance import score_matrix
from pyrope_tpu.ops.kmeans import kmeans_build
from pyrope_tpu.ops.topk import masked_topk, merge_topk
from pyrope_tpu.ops.transfer import upload_rows
from pyrope_tpu.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu.utils.shapes import batch_bucket, round_up

DEFAULT_NPROBE = 3  # ref: IvfFlatVectorIndex.cs:14 CombineNProbe = 3

# auto scan-mode thresholds (see pick_scan_mode)
DENSE_MAX_ROWS = 262_144   # a full matmul over this many rows is trivially cheap
DENSE_TILE_B = 256         # ~queries amortizing one slab pass in the dense matmul
DENSE_MARGIN = 2           # require probe traffic >= 2x dense before switching
# The XLA dense kernel transiently materializes [B, npad] fp32 scores plus
# an int32 allowed_row gather and a bool mask (~9 B/element); cap the
# product so an unusual batch bucket cannot exhaust device memory. The cap
# follows the device's memory limit (dense_max_elems); DENSE_MAX_ELEMS is
# the cap where the backend reports none (the CPU).
DENSE_MAX_ELEMS = 1 << 28
DENSE_BYTES_PER_ELEM = 9
DENSE_MEM_SHARE = 4  # the transients may take at most 1/4 of device memory


@functools.lru_cache(maxsize=None)
def dense_max_elems() -> int:
    """Largest batch x slab-rows product the XLA dense kernel may
    materialize: a DENSE_MEM_SHARE-th of the device's ``bytes_limit`` at
    DENSE_BYTES_PER_ELEM, or DENSE_MAX_ELEMS when the backend reports no
    memory limit."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return DENSE_MAX_ELEMS
    return int(limit) // (DENSE_BYTES_PER_ELEM * DENSE_MEM_SHARE)


def pick_scan_mode(
    scan_mode: str, npad: int, nprobe: int, l_pad: int, batch: int = 64,
    fused: bool = False,
) -> str:
    """Resolve 'auto' to 'dense' or 'probe' by HBM-traffic model.

    The sparse kernel's per-query dynamic-slice replicates probed rows per
    query: traffic ∝ batch·nprobe·l_pad rows. The dense matmul streams the
    whole slab once per ~DENSE_TILE_B queries: traffic ∝ npad·ceil(B/tile)
    rows. The model keeps a 2x safety margin toward probe.

    ``fused``: the dense scan runs on the fused scan+top-k kernel (the
    hybrid selection), which streams slab tiles with a running top-k and
    never materializes [B, npad] — the dense_max_elems guard exists only
    for the XLA dense kernel's transients, so it does not demote fused
    batches to the per-query probe kernel.
    """
    if scan_mode != "auto":
        return scan_mode
    if not fused and batch * npad > dense_max_elems():
        return "probe"  # [B, npad] transients would not fit (see cap above)
    if npad <= DENSE_MAX_ROWS:
        return "dense"
    dense_traffic = npad * -(-batch // DENSE_TILE_B)
    if batch * nprobe * l_pad >= DENSE_MARGIN * dense_traffic:
        return "dense"
    return "probe"


def slab_pad(n: int, l_pad: int) -> int:
    """Padded slab length: tail pad so every probe slice stays in range,
    rounded to 128 rows (extra rows are alive=False so every path ignores
    them)."""
    return int(round_up(round_up(n, 8) + l_pad, 128))


def rank_probes(q, cents, cvalid, offsets, lens, nprobe, max_scans, metric, cdtype):
    """Rank centroids, pick the top-nprobe lists, and compute each probe's
    effective scan length under the max_scans budget (ref :183-219).
    Returns (probe [B, nprobe] list ids, offs_p, eff)."""
    cscores = score_matrix(q, cents, metric, compute_dtype=cdtype)
    cscores = jnp.where(cvalid[None, :], cscores, -jnp.inf)
    _, probe = jax.lax.top_k(cscores, nprobe)
    lens_p = lens[probe]
    offs_p = offsets[probe]
    before = jnp.cumsum(lens_p, axis=1) - lens_p          # rows scanned earlier
    budget = jnp.maximum(max_scans - before, 0)
    eff = jnp.minimum(lens_p, budget)                     # ref: break at MaxScans
    return probe, offs_p, eff


def scan_probed_lists(
    xperm, sqnorm, alive, q, offs_p, eff,
    *, k: int, l_pad: int, metric: Metric, cdtype, prec, row_base=0,
):
    """Scan every probed list slice with a running top-k merge. Each probe
    is a contiguous dynamic-slice of the cluster-major slab (pure DMA) plus
    one [B, L_pad] score einsum. ``row_base`` offsets emitted row ids (the
    sharded scan passes shard*stride so candidates stay globally unique).

    Shared by the single-chip IVF-Flat kernel and the shard_map'd
    multi-chip kernel (pyrope_tpu/parallel/sharded_ivf.py)."""
    b = q.shape[0]
    nprobe = offs_p.shape[1]
    qf = q.astype(jnp.float32)
    qq = jnp.sum(qf * qf, axis=-1)
    qn = jnp.sqrt(jnp.maximum(qq, 1e-24))
    j = jax.lax.broadcasted_iota(jnp.int32, (1, l_pad), 1)

    vals = jnp.full((b, k), -jnp.inf, jnp.float32)
    gidx = jnp.full((b, k), -1, jnp.int32)
    for p in range(nprobe):
        off = offs_p[:, p]
        blocks = jax.vmap(
            lambda o: jax.lax.dynamic_slice(xperm, (o, 0), (l_pad, xperm.shape[1]))
        )(off)                                             # [B, L_pad, D]
        sq = jax.vmap(lambda o: jax.lax.dynamic_slice(sqnorm, (o,), (l_pad,)))(off)
        alv = jax.vmap(lambda o: jax.lax.dynamic_slice(alive, (o,), (l_pad,)))(off)
        if cdtype is not None:
            dots = jnp.einsum(
                "bld,bd->bl", blocks.astype(cdtype), q.astype(cdtype),
                preferred_element_type=jnp.float32,
            )
        else:
            dots = jnp.einsum(
                "bld,bd->bl", blocks, qf,
                preferred_element_type=jnp.float32, precision=prec,
            )
        if metric == Metric.L2:
            scores = -jnp.maximum(qq[:, None] - 2.0 * dots + sq, 0.0)
        elif metric == Metric.INNER_PRODUCT:
            scores = dots
        else:  # COSINE
            xn = jnp.sqrt(jnp.maximum(sq, 1e-24))
            scores = dots / jnp.maximum(qn[:, None] * xn, 1e-12)
        mask = (j < eff[:, p : p + 1]) & alv
        svals = jnp.where(mask, scores, -jnp.inf)
        rows = row_base + off[:, None] + j
        vals, gidx = merge_topk(vals, gidx, svals, rows, k)
    return vals, gidx


def probe_budget_table(probe, eff, kpad: int) -> jax.Array:
    """[B, nprobe] probed list ids + their max_scans budgets -> [B, kpad]
    int32 table of each list's scan budget per query (0 = not probed). A
    row r survives the dense scan iff pos[r] < table[b, crow[r]]."""
    b = probe.shape[0]
    table = jnp.zeros((b, kpad), jnp.int32)
    return table.at[jnp.arange(b)[:, None], probe].set(eff)


def dense_probe_mask(probe, eff, crow, pos, alive, kpad):
    """[B, N] mask of rows inside a probed list AND inside its max_scans
    budget: the budget table read back per row through the static
    cluster-of-row map, compared against each row's within-list position.

    Shared by the single-chip dense kernel and the shard_map'd sharded-IVF
    dense kernel (pyrope_tpu/parallel/sharded_ivf.py)."""
    allowed_row = probe_budget_table(probe, eff, kpad)[:, crow]  # [B, N]
    return (pos[None, :] < allowed_row) & alive[None, :]


@functools.lru_cache(maxsize=None)
def _ivf_dense_fn(metric: Metric, k: int, nprobe: int, compute: str | None):
    cdtype = None if compute is None else jnp.dtype(compute)

    @jax.jit
    def fn(cents, cvalid, xperm, sqnorm, alive, offsets, lens, crow, pos, q, max_scans):
        probe, _, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans, metric, cdtype
        )
        mask = dense_probe_mask(probe, eff, crow, pos, alive, cents.shape[0])
        scores = score_matrix(q, xperm, metric, x_sqnorm=sqnorm, compute_dtype=cdtype)
        # masked_topk pads when k exceeds the slab (matches the probe kernel)
        return masked_topk(jnp.where(mask, scores, -jnp.inf), None, k)

    return fn


@functools.lru_cache(maxsize=None)
def _ivf_dense_pallas_hybrid_fn(metric: Metric, k: int, r: int, nprobe: int):
    """Hybrid dense scan: the fused kernel streams the bf16 twin slab and
    keeps each query's top-R shortlist, then rerank_exact rescores those
    R rows off the fp32 slab with Precision.HIGHEST — matches the fp32
    dense scan WITH HIGH PROBABILITY at bf16 scan cost (the PQ-refine
    pattern applied to the exact IVF path). Not exact by construction:
    more than R−k near-ties within bf16 rounding of the kth score can push
    a true neighbor outside the shortlist — see
    index/flat._hybrid_search_fn for the failure regime and mitigations."""
    from pyrope_tpu.ops.distance import rerank_exact
    from pyrope_tpu.ops.pallas_scan import pallas_ivf_topk

    @jax.jit
    def fn(cents, cvalid, xperm, xperm16, sqnorm, alive, offsets, lens, crow,
           pos, q, max_scans):
        probe, _, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans, metric, None,
        )
        allowed = probe_budget_table(probe, eff, cents.shape[0])
        _, rows = pallas_ivf_topk(q, xperm16, sqnorm, alive, crow, pos,
                                  allowed, k=r, metric=metric)
        return rerank_exact(xperm, sqnorm, q, rows, k, metric)

    return fn


_cast_bf16 = jax.jit(lambda a: a.astype(jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _ivf_search_fn(metric: Metric, k: int, nprobe: int, l_pad: int, compute: str | None):
    cdtype = None if compute is None else jnp.dtype(compute)
    prec = jax.lax.Precision.HIGHEST if compute is None else None

    @jax.jit
    def fn(cents, cvalid, xperm, sqnorm, alive, offsets, lens, q, max_scans):
        _, offs_p, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans, metric, cdtype
        )
        return scan_probed_lists(
            xperm, sqnorm, alive, q, offs_p, eff,
            k=k, l_pad=l_pad, metric=metric, cdtype=cdtype, prec=prec,
        )

    return fn


class IvfFlatIndex(VectorIndex, CentroidsProvider):
    @property
    def host_write_cheap(self) -> bool:  # see IVectorIndex
        # writes land in the Flat buffer; cheap while it needs no realloc
        return self._buffer.host_write_cheap

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        nlist: int = 100,  # ref default nlist 100
        nprobe: int = DEFAULT_NPROBE,
        compute_dtype: Optional[str] = None,
        seed: int = 42,    # ref: IvfFlatVectorIndex k-means seed 42
        train_dtype: Optional[str] = None,
        scan_mode: str = "auto",
        train_init: str = "kmeans++",  # | "sample" (the reference's init)
        selection: str = "exact",
    ):
        """``compute_dtype`` governs SEARCH scans (None = exact fp32
        HIGHEST, the CLAUDE.md invariant). ``train_dtype`` governs k-means
        TRAINING matmuls only — bf16 runs on the tensor cores and perturbs only
        which list a boundary row lands in, not search exactness; None
        restores bit-stable fp32 training. ``scan_mode`` picks the probed
        scan kernel: 'auto' | 'dense' | 'probe' (see module docstring —
        both produce identical hit sets). ``selection``: 'exact' (default)
        scans with the XLA kernels at fp32 HIGHEST; 'hybrid[:R]' scans a
        bf16 twin slab with the fused scan+top-k kernel keeping top-R and
        reranks those rows off the fp32 slab with HIGHEST — matches the
        fp32 scan with high probability at bf16 scan cost (+50% slab
        memory; dense bf16-rounding near-ties past rank R are
        unrecoverable — see index/flat._hybrid_search_fn)."""
        if scan_mode not in ("auto", "dense", "probe"):
            raise ValueError(f"scan_mode must be auto|dense|probe, got {scan_mode!r}")
        if selection.partition(":")[0] not in ("exact", "hybrid"):
            raise ValueError(
                f"selection must be exact|hybrid[:R], got {selection!r}"
            )
        if selection.partition(":")[0] == "hybrid" and compute_dtype is not None:
            raise ValueError("selection='hybrid' reranks in fp32; "
                             "compute_dtype must stay None (fp32)")
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.train_dtype = train_dtype
        self.scan_mode = scan_mode
        self.train_init = train_init
        self.selection = selection

        self._buffer = FlatIndex(dim, self.metric, compute_dtype=compute_dtype)
        # built main slab (host truth). The permuted host slab and the
        # id->row dict are materialized LAZILY from (_xbase, _order): at 1M
        # rows the permute alone costs ~15-40 s in first-touch page faults
        # (see ops/transfer.py) and pure-serving builds never need either —
        # only snapshot/scan/rebuild/mutation paths do.
        self._built = False
        self._centroids: Optional[np.ndarray] = None   # [K, D]
        self._xperm_cache: Optional[np.ndarray] = np.zeros((0, self.dim), np.float32)
        self._xbase: Optional[np.ndarray] = None       # unpermuted merged corpus
        self._order: Optional[np.ndarray] = None       # argsort(assign)
        self._main_n = 0
        self._perm_ids: list[str] = []
        self._main_pos_cache: Optional[dict[str, int]] = {}
        self._alive = np.zeros(0, bool)
        self._offsets = np.zeros(0, np.int32)
        self._lens = np.zeros(0, np.int32)
        self._main_live = 0
        self._dirty = True
        self._dev: Optional[dict] = None

    @property
    def _xperm(self) -> np.ndarray:
        """Permuted host slab (cluster-major). Materialized on first use."""
        cache = self._xperm_cache
        if cache is None:
            with self.lock:
                if self._xperm_cache is None:
                    self._xperm_cache = self._xbase[self._order]
                    self._xbase = None
                    self._order = None
                cache = self._xperm_cache
        return cache

    @_xperm.setter
    def _xperm(self, value: np.ndarray) -> None:
        self._xperm_cache = value
        self._xbase = None
        self._order = None
        self._main_n = value.shape[0]

    @property
    def _main_pos(self) -> dict[str, int]:
        """id -> permuted-row dict. Materialized on first mutation/lookup."""
        cache = self._main_pos_cache
        if cache is None:
            with self.lock:
                if self._main_pos_cache is None:
                    self._main_pos_cache = {
                        pid: r for r, pid in enumerate(self._perm_ids)
                    }
                cache = self._main_pos_cache
        return cache

    @_main_pos.setter
    def _main_pos(self, value: dict[str, int]) -> None:
        self._main_pos_cache = value

    # ---- mutation -------------------------------------------------------

    def add(self, id: str, vector: np.ndarray) -> bool:
        with self.lock:
            row = self._main_pos.get(id)
            if row is not None and self._alive[row]:
                return False
            return self._buffer.add(id, vector)

    def upsert(self, id: str, vector: np.ndarray) -> None:
        with self.lock:
            row = self._main_pos.get(id)
            if row is not None and self._alive[row]:
                self._alive[row] = False  # main copy superseded by buffer copy
                self._main_live -= 1
                self._dirty = True
            self._buffer.upsert(id, vector)

    def delete(self, id: str) -> bool:
        with self.lock:
            if self._buffer.delete(id):
                return True
            row = self._main_pos.get(id)
            if row is None or not self._alive[row]:
                return False
            self._alive[row] = False
            self._main_live -= 1
            self._dirty = True
            return True

    def add_batch(self, ids, vectors) -> int:
        if not self._built and not self._main_pos:
            return self._buffer.add_batch(ids, vectors)
        return super().add_batch(ids, vectors)

    # ---- build ----------------------------------------------------------

    def build(self) -> None:
        """Merge main + buffer, retrain k-means, re-bucket
        (ref: IvfFlatVectorIndex.cs:85-145)."""
        with self.lock:
            self._build_locked()

    def _build_locked(self) -> None:
        ids: list[str] = []
        rows: list[np.ndarray] = []
        main_live_rows = [r for r in range(len(self._perm_ids)) if self._alive[r]]
        if main_live_rows:
            ids.extend(self._perm_ids[r] for r in main_live_rows)
            rows.append(self._xperm[main_live_rows])
        bids, bvecs = self._buffer.live_vectors()
        if bids:
            ids.extend(bids)
            rows.append(bvecs)
        if not ids:
            return
        x = np.concatenate(rows) if len(rows) > 1 else rows[0]
        n = x.shape[0]
        k = min(self.nlist, n)

        # single corpus upload: train + assign reuse one device buffer, and
        # the search slab below is a device-side take of the same buffer
        # (one host-to-device copy of the corpus per build)
        cents, assign, x_dev = kmeans_build(
            x, k, self.metric, seed=self.seed, compute_dtype=self.train_dtype,
            init=self.train_init,
        )

        order = np.argsort(assign, kind="stable")
        # defer the host permute + id->row dict: serving needs neither
        self._xperm_cache = None
        self._xbase = x
        self._order = order
        self._main_n = n
        self._perm_ids = [ids[i] for i in order]
        self._main_pos_cache = None
        self._alive = np.ones(n, bool)
        self._lens = np.bincount(assign, minlength=k).astype(np.int32)
        self._offsets = np.concatenate([[0], np.cumsum(self._lens)[:-1]]).astype(np.int32)
        self._centroids = cents[:k]
        self._main_live = n
        self._built = True
        self._buffer = FlatIndex(self.dim, self.metric, compute_dtype=self.compute_dtype)
        self._install_device_slab(x_dev, order)

    def get_centroids(self) -> Optional[np.ndarray]:
        return None if self._centroids is None else self._centroids.copy()

    # ---- query ----------------------------------------------------------

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        with self.lock:
            return self._sync_locked()

    def _host_tables(self) -> dict:
        """Padded centroid/list/alive tables shared by the host-upload sync
        and the device-side build install."""
        k = self._lens.shape[0]
        kpad = round_up(max(k, 1), 8)
        l_pad = int(round_up(max(int(self._lens.max()) if k else 1, 1), 128))
        n = self._main_n
        npad = slab_pad(n, l_pad)
        alive = np.zeros(npad, bool)
        alive[:n] = self._alive
        cents = np.zeros((kpad, self.dim), np.float32)
        cvalid = np.zeros(kpad, bool)
        if self._centroids is not None:
            cents[:k] = self._centroids
            cvalid[:k] = True
        offs = np.zeros(kpad, np.int32)
        lens = np.zeros(kpad, np.int32)
        offs[:k] = self._offsets
        lens[:k] = self._lens
        # static dense-mask tables: row -> cluster id, row -> within-list
        # position (pad rows point at a masked-off slot; alive=False anyway)
        crow = np.full(npad, kpad - 1, np.int32)
        pos = np.zeros(npad, np.int32)
        if n:
            crow[:n] = np.repeat(np.arange(k, dtype=np.int32), self._lens)
            pos[:n] = np.arange(n, dtype=np.int32) - self._offsets[crow[:n]]
        return {
            "k": k, "kpad": kpad, "l_pad": l_pad, "n": n, "npad": npad,
            "alive": alive, "cents": cents, "cvalid": cvalid,
            "offs": offs, "lens": lens, "crow": crow, "pos": pos,
        }

    def _dev_common(self, t: dict) -> dict:
        return {
            "cents": jnp.asarray(t["cents"]),
            "cvalid": jnp.asarray(t["cvalid"]),
            "alive": jnp.asarray(t["alive"]),
            "offsets": jnp.asarray(t["offs"]),
            "lens": jnp.asarray(t["lens"]),
            "crow": jnp.asarray(t["crow"]),
            "pos": jnp.asarray(t["pos"]),
            "l_pad": t["l_pad"],
            "k_actual": t["k"],
            # row->id table CONSISTENT with this slab: build()/load() replace
            # self._perm_ids with a fresh list, so a search that captured an
            # older dev dict still resolves against the matching table
            # (a concurrent rebuild otherwise crashes or mislabels hits)
            "perm_ids": self._perm_ids,
        }

    def _install_device_slab(self, x_dev: jax.Array, order: np.ndarray) -> None:
        """Build the device search slab from the already-uploaded corpus
        buffer via a device-side permuted take — no slab re-upload."""
        from pyrope_tpu.ops.slab import pad_order, take_slab

        t = self._host_tables()
        xperm, sqnorm = take_slab(x_dev, pad_order(order, t["npad"], x_dev.shape[0]))
        self._dev = {"xperm": xperm, "sqnorm": sqnorm, **self._dev_common(t)}
        if self.selection.partition(":")[0] == "hybrid":
            self._dev["xperm16"] = _cast_bf16(xperm)  # device-side, no re-upload
        self._dirty = False

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        t = self._host_tables()
        n, npad = t["n"], t["npad"]
        xp = self._xperm
        sq = np.zeros(npad, np.float32)
        sq[:n] = np.einsum("nd,nd->n", xp, xp)
        self._dev = {
            "xperm": upload_rows(xp, pad_to=npad),
            "sqnorm": jnp.asarray(sq),
            **self._dev_common(t),
        }
        if self.selection.partition(":")[0] == "hybrid":
            self._dev["xperm16"] = _cast_bf16(self._dev["xperm"])
        self._dirty = False
        return self._dev

    def device_search(
        self, q: jax.Array, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[jax.Array, jax.Array]:
        """Device-resident query over the built main slab only (the mutable
        buffer must be empty — compact first). Returns device
        (scores [B, k], permuted rows [B, k]); no host sync."""
        if self._buffer.get_stats().count:
            raise RuntimeError("device_search requires an empty buffer; call build()")
        if not self._built:
            raise RuntimeError("device_search requires a built index")
        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        ms = options.max_scans if options.max_scans is not None else self._main_n
        return self._run_scan(dev, q, top_k, nprobe, ms)

    def _resolve_scan(self, dev: dict, batch: int, nprobe: int, ms: int) -> str:
        """Resolve (batch, nprobe, max_scans) to the kernel that will run:
        'probe', 'dense-xla', or 'dense-pallas-hybrid'. The SINGLE source
        of routing truth, shared by _run_scan (dispatch) and describe_scan
        (bench labeling) so a recorded scan_path is always the kernel
        actually measured."""
        hybrid = (self.selection.partition(":")[0] == "hybrid"
                  and self.metric != Metric.COSINE)
        mode = pick_scan_mode(
            self.scan_mode, dev["xperm"].shape[0], nprobe, dev["l_pad"],
            batch=batch, fused=hybrid,
        )
        if mode != "dense":
            return "probe"
        return "dense-pallas-hybrid" if hybrid else "dense-xla"

    def _run_scan(self, dev: dict, q: jax.Array, top_k: int, nprobe: int, ms: int):
        path = self._resolve_scan(dev, q.shape[0], nprobe, ms)
        if path == "dense-pallas-hybrid":
            from pyrope_tpu.index.flat import hybrid_shortlist
            from pyrope_tpu.ops.topk import parse_selection

            r = hybrid_shortlist(top_k, parse_selection(self.selection)[1])
            fn = _ivf_dense_pallas_hybrid_fn(self.metric, top_k, r, nprobe)
            return fn(
                dev["cents"], dev["cvalid"], dev["xperm"], dev["xperm16"],
                dev["sqnorm"], dev["alive"], dev["offsets"], dev["lens"],
                dev["crow"], dev["pos"], q, device_i32(ms),
            )
        if path == "dense-xla":
            fn = _ivf_dense_fn(self.metric, top_k, nprobe, self.compute_dtype)
            return fn(
                dev["cents"], dev["cvalid"], dev["xperm"], dev["sqnorm"],
                dev["alive"], dev["offsets"], dev["lens"], dev["crow"],
                dev["pos"], q, device_i32(ms),
            )
        fn = _ivf_search_fn(self.metric, top_k, nprobe, dev["l_pad"], self.compute_dtype)
        return fn(
            dev["cents"], dev["cvalid"], dev["xperm"], dev["sqnorm"], dev["alive"],
            dev["offsets"], dev["lens"], q, device_i32(ms),
        )

    def describe_scan(self, batch: int, nprobe: Optional[int] = None,
                      max_scans: Optional[int] = None) -> str:
        """Which kernel a (batch, nprobe, max_scans) query would run:
        'probe', 'dense-xla', or 'dense-pallas-hybrid' (max_scans None =
        full scan). Benchmark rows record this so a QPS
        number is never quoted without its code path."""
        if not self._built:
            return "buffer"
        dev = self._sync()
        np_eff = min(nprobe or self.nprobe, dev["k_actual"])
        ms = max_scans if max_scans is not None else self._main_n
        return self._resolve_scan(dev, batch, np_eff, ms)

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        return [
            [self._perm_ids[int(r)] if r >= 0 else "" for r in row]
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
        b = q.shape[0]

        # exact scan of the mutable buffer (ref :170-180)
        buf_hits = (
            self._buffer.search_batch(q, top_k, options)
            if self._buffer.get_stats().count
            else [[] for _ in range(b)]
        )
        if not self._built or self._main_live == 0:
            return buf_hits

        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        ms = options.max_scans if options.max_scans is not None else self._main_n
        bb = batch_bucket(b)
        qp = np.pad(q, ((0, bb - b), (0, 0))) if bb != b else q
        vals, rows = self._run_scan(dev, jnp.asarray(qp), top_k, nprobe, ms)
        vals = np.asarray(vals)[:b]
        rows = np.asarray(rows)[:b]

        perm_ids = dev["perm_ids"]
        out: list[list[SearchResult]] = []
        for bi in range(b):
            hits = list(buf_hits[bi])
            for v, r in zip(vals[bi], rows[bi]):
                if r < 0 or not np.isfinite(v):
                    continue
                hits.append(SearchResult(perm_ids[int(r)], float(v)))
            hits.sort(key=lambda h: -h.score)
            out.append(hits[:top_k])
        return out

    # ---- lifecycle ------------------------------------------------------

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        for r, pid in enumerate(self._perm_ids):
            if self._alive[r]:
                yield pid, self._xperm[r].copy()
        yield from self._buffer.scan()

    def get_stats(self) -> IndexStats:
        return IndexStats(
            count=self._main_live + self._buffer.get_stats().count,
            dim=self.dim,
            metric=self.metric,
        )

    def snapshot(self, path: str) -> None:
        """Full-state snapshot: centroids + permuted slab + lists + buffer
        (ref: IvfFlatVectorIndex.cs:233-298 JSON snapshot — here one npz).

        Runs under the index lock: live_vectors may return a VIEW of the
        buffer slab and a concurrent upsert writes rows in place."""
        with self.lock:
            self._snapshot_locked(path)

    def _snapshot_locked(self, path: str) -> None:
        bids, bvecs = self._buffer.live_vectors()
        meta = json.dumps({
            "format": "pyrope_tpu.ivf_flat.v1",
            "dim": self.dim,
            "metric": self.metric.value,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "built": self._built,
            "seed": self.seed,
            "scan_mode": self.scan_mode,
        })
        np.savez_compressed(
            path,
            meta=np.str_(meta),
            centroids=self._centroids if self._centroids is not None else np.zeros((0, self.dim), np.float32),
            xperm=self._xperm,
            perm_ids=np.array(self._perm_ids, dtype=np.str_),
            alive=self._alive,
            offsets=self._offsets,
            lens=self._lens,
            buf_ids=np.array(bids, dtype=np.str_),
            buf_vecs=bvecs,
        )

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("format") != "pyrope_tpu.ivf_flat.v1":
                raise ValueError(f"bad snapshot format: {meta.get('format')}")
            if int(meta["dim"]) != self.dim:
                raise ValueError("snapshot dim mismatch")
            self.metric = Metric.parse(meta["metric"])
            self.nlist = int(meta["nlist"])
            self.nprobe = int(meta["nprobe"])
            self.seed = int(meta.get("seed", 42))
            self.scan_mode = str(meta.get("scan_mode", self.scan_mode))
            self._built = bool(meta["built"])
            cents = np.asarray(z["centroids"], np.float32)
            self._centroids = cents if cents.size else None
            self._xperm = np.asarray(z["xperm"], np.float32)
            self._perm_ids = [str(s) for s in z["perm_ids"]]
            self._alive = np.asarray(z["alive"], bool)
            self._offsets = np.asarray(z["offsets"], np.int32)
            self._lens = np.asarray(z["lens"], np.int32)
            self._main_pos = {pid: r for r, pid in enumerate(self._perm_ids)}
            self._main_live = int(self._alive.sum())
            self._buffer = FlatIndex(self.dim, self.metric, compute_dtype=self.compute_dtype)
            bids = [str(s) for s in z["buf_ids"]]
            if bids:
                self._buffer.add_batch(bids, np.asarray(z["buf_vecs"], np.float32))
        self._dirty = True
        self._dev = None
