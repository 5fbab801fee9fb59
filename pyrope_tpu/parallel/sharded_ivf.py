"""Corpus-sharded IVF-Flat: probed-list scan over a device mesh.

Multi-chip layout (SURVEY §5.8/§7.8): every inverted list's rows are dealt
round-robin across the mesh's ``data`` axis, so each shard owns an equal
~1/ndev slice of *every* list in its own contiguous cluster-major slab
(local CSR: offsets + lens). A query (replicated) ranks the replicated
centroids identically on every shard, probes the same top-nprobe lists, and
scans only its local slices; the [B, k] local candidates ride one
``all_gather`` and every shard reduces to the final top-k.

Why round-robin rows instead of whole lists per shard: probe selection is
query-dependent, so whole-list placement makes load skew with the query
distribution (hot lists pile onto one chip); slicing every list keeps all
chips busy for every query — the "sequence parallelism over the database
axis" design from SURVEY §5.7.

Candidate encoding across shards: global_candidate = shard * stride +
local_slab_pos, decoded on host via a per-shard row map.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyrope_tpu.ops.topk import masked_topk
from pyrope_tpu.index.ivf_flat import (
    IvfFlatIndex,
    dense_probe_mask,
    pick_scan_mode,
    rank_probes,
    scan_probed_lists,
)
from pyrope_tpu.ops.distance import score_matrix
from pyrope_tpu.ops.scalars import device_i32
from pyrope_tpu.parallel.mesh import (
    BATCH_AXIS,
    DATA_AXIS,
    allgather_merge_topk,
    default_mesh,
)
from pyrope_tpu.types import (
    DEFAULT_SEARCH_OPTIONS,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu.utils.shapes import batch_bucket, round_up


def roundrobin_layout(lens: np.ndarray, offsets: np.ndarray, nd: int, kpad: int):
    """Deal every list's rows round-robin across nd shards.

    Returns (local_lens [nd, kpad], local_offsets [nd, kpad], l_pad,
    cap_local, placements) where placements is a list of
    (shard, dst_start, global_rows) copy instructions for filling the
    per-shard slabs. Shared by the sharded IVF-Flat and IVF-PQ layouts —
    cap_local includes an l_pad tail so probe dynamic-slices never clamp.
    """
    k = lens.shape[0]
    local_lens = np.zeros((nd, kpad), np.int32)
    for li in range(k):
        ln = int(lens[li])
        for s in range(nd):
            local_lens[s, li] = (ln - s + nd - 1) // nd if ln > s else 0
    l_pad = int(round_up(max(int(local_lens.max()) if k else 1, 1), 128))
    local_offsets = np.zeros((nd, kpad), np.int32)
    caps = local_lens.sum(axis=1)
    # 128-row rounding like the single-device slab_pad; extra rows are
    # alive=False so every kernel ignores them
    cap_local = int(round_up(round_up(int(caps.max()) if k else 1, 8)
                             + l_pad, 128))
    placements = []
    cursor = np.zeros(nd, np.int64)
    for li in range(k):
        off = int(offsets[li])
        ln = int(lens[li])
        for s in range(nd):
            rows = np.arange(off + s, off + ln, nd)
            c = int(cursor[s])
            local_offsets[s, li] = c
            if len(rows):
                placements.append((s, c, rows))
            cursor[s] = c + len(rows)
    return local_lens, local_offsets, l_pad, cap_local, placements


def cluster_layout(lens: np.ndarray, offsets: np.ndarray, nd: int, kpad: int):
    """Deal whole CLUSTERS to shards, size-balanced (greedy LPT: largest
    list to the least-loaded shard).

    The alternative to roundrobin_layout (VERDICT r3 #6): each shard owns
    ~K/nd complete lists, so a probed list is scanned by exactly ONE shard —
    per-shard probe-path work drops from nprobe list-slices (each padded to
    >= 128 gather rows) to ~nprobe/nd full lists. The trade is load balance:
    probe ownership is query-dependent, so a query whose probes concentrate
    on one shard serializes there (the static probe cap in
    make_sharded_ivf_cluster_probe_search bounds the worst case). Greedy
    LPT keeps SLAB sizes balanced even under Zipf cluster-size skew; probe
    LOAD balance depends on the query distribution.

    Returns (local_lens [nd, kpad], local_offsets [nd, kpad], l_pad,
    cap_local, placements, owner [kpad]) — same contract as
    roundrobin_layout plus the ownership table.
    """
    k = lens.shape[0]
    owner = np.zeros(kpad, np.int32)
    load = np.zeros(nd, np.int64)
    for li in np.argsort(-lens[:k], kind="stable"):
        s = int(np.argmin(load))
        owner[li] = s
        load[s] += int(lens[li])
    if kpad > k:  # pad clusters (never probed): spread round-robin
        owner[k:] = np.arange(kpad - k) % nd
    local_lens = np.zeros((nd, kpad), np.int32)
    for li in range(k):
        local_lens[owner[li], li] = int(lens[li])
    # full lists live on one shard: l_pad tracks the LARGEST list
    l_pad = int(round_up(max(int(lens[:k].max()) if k else 1, 1), 128))
    local_offsets = np.zeros((nd, kpad), np.int32)
    caps = local_lens.sum(axis=1)
    cap_local = int(round_up(round_up(int(caps.max()) if k else 1, 8)
                             + l_pad, 128))
    placements = []
    cursor = np.zeros(nd, np.int64)
    for li in range(k):
        s = int(owner[li])
        off, ln = int(offsets[li]), int(lens[li])
        c = int(cursor[s])
        local_offsets[s, li] = c
        if ln:
            placements.append((s, c, np.arange(off, off + ln)))
        cursor[s] = c + ln
    return local_lens, local_offsets, l_pad, cap_local, placements, owner


def make_sharded_ivf_cluster_probe_search(
    mesh: Mesh, metric: Metric, k: int, nprobe: int, p_cap: int,
    l_pad: int, stride: int, compute: str | None,
):
    """shard_map'd probed scan for the CLUSTER layout: every shard ranks
    probes identically (replicated centroids), keeps only the probes it
    OWNS (owner table), compacts them into ``p_cap`` static slots, and
    scans those full lists from its local slab. ~nprobe/nd lists per shard
    instead of nprobe slices — the static shapes XLA needs, with the skew
    risk made explicit: owned probes beyond p_cap are DROPPED (choose
    p_cap = nprobe for a no-drop guarantee; the auto default provisions
    4x the balanced expectation, see ShardedIvfFlatIndex.probe_cap)."""
    cdtype = None if compute is None else jnp.dtype(compute)
    prec = jax.lax.Precision.HIGHEST if compute is None else None
    two_d = BATCH_AXIS in mesh.axis_names

    def local(cents, cvalid, xperm, sqnorm, alive, offsets, lens, owner,
              q, ms_local):
        xperm, sqnorm, alive = xperm[0], sqnorm[0], alive[0]
        offsets, lens = offsets[0], lens[0]
        shard = jax.lax.axis_index(DATA_AXIS)

        # identical global probe ranking on every shard; the local CSR's
        # lens are zero for non-owned lists so the budget below only counts
        # rows this shard will actually scan
        probe, _, _ = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, ms_local, metric, cdtype
        )
        owned = owner[probe] == shard                        # [B, nprobe]
        # compact owned probes into p_cap slots, preserving probe rank
        # (score: higher = earlier-ranked owned probe; -1 = not mine)
        pos = jax.lax.broadcasted_iota(jnp.int32, probe.shape, 1)
        sel_score, sel = jax.lax.top_k(
            jnp.where(owned, nprobe - pos, -1), p_cap
        )
        probe_own = jnp.take_along_axis(probe, sel, axis=1)  # [B, p_cap]
        valid = sel_score > 0
        lens_own = jnp.where(valid, lens[probe_own], 0)
        offs_own = jnp.where(valid, offsets[probe_own], 0)
        # max_scans budget over the shard's own scan order (ref semantics
        # applied per shard: cumulative rows scanned locally)
        before = jnp.cumsum(lens_own, axis=1) - lens_own
        eff = jnp.minimum(lens_own, jnp.maximum(ms_local - before, 0))

        vals, gidx = scan_probed_lists(
            xperm, sqnorm, alive, q, offs_own, eff,
            k=k, l_pad=l_pad, metric=metric, cdtype=cdtype, prec=prec,
            row_base=shard * stride,
        )
        return allgather_merge_topk(vals, gidx, k)

    q_spec = P(BATCH_AXIS, None) if two_d else P(None, None)
    out_one = P(BATCH_AXIS, None) if two_d else P(None, None)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, None), P(None),                      # centroids replicated
            P(DATA_AXIS, None, None), P(DATA_AXIS, None), P(DATA_AXIS, None),
            P(DATA_AXIS, None), P(DATA_AXIS, None),
            P(None),                                      # owner replicated
            q_spec, P(),
        ),
        out_specs=(out_one, out_one),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_ivf_search(
    mesh: Mesh, metric: Metric, k: int, nprobe: int, l_pad: int,
    stride: int, compute: str | None,
):
    """shard_map'd probed scan. Per-shard inputs carry a leading mesh-axis
    dim of 1 inside the body. On a 2-D batch × data mesh the query batch is
    additionally sharded over BATCH_AXIS (each batch group probes the whole
    corpus across its data row; the all_gather merge stays within the data
    axis — no cross-batch traffic)."""
    cdtype = None if compute is None else jnp.dtype(compute)
    prec = jax.lax.Precision.HIGHEST if compute is None else None
    two_d = BATCH_AXIS in mesh.axis_names

    def local(cents, cvalid, xperm, sqnorm, alive, offsets, lens, q, ms_local):
        xperm, sqnorm, alive = xperm[0], sqnorm[0], alive[0]
        offsets, lens = offsets[0], lens[0]
        shard = jax.lax.axis_index(DATA_AXIS)

        # probe selection is identical on every shard (replicated centroids)
        _, offs_p, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, ms_local, metric, cdtype
        )
        # row ids encode the shard so merged candidates stay globally unique
        vals, gidx = scan_probed_lists(
            xperm, sqnorm, alive, q, offs_p, eff,
            k=k, l_pad=l_pad, metric=metric, cdtype=cdtype, prec=prec,
            row_base=shard * stride,
        )

        return allgather_merge_topk(vals, gidx, k)

    q_spec = P(BATCH_AXIS, None) if two_d else P(None, None)
    out_one = P(BATCH_AXIS, None) if two_d else P(None, None)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, None), P(None),                      # centroids replicated
            P(DATA_AXIS, None, None), P(DATA_AXIS, None), P(DATA_AXIS, None),
            P(DATA_AXIS, None), P(DATA_AXIS, None),
            q_spec, P(),
        ),
        out_specs=(out_one, out_one),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_ivf_dense_search(
    mesh: Mesh, metric: Metric, k: int, nprobe: int,
    stride: int, compute: str | None,
):
    """shard_map'd DENSE scan: each shard runs one full matmul over its own
    cluster-major slab masked by probe membership (see
    pyrope_tpu/index/ivf_flat.py module docstring), then the [B, k] local
    winners ride the same all_gather merge as the sparse kernel. The
    local CSR (offsets/lens/crow/pos) is per-shard, so the mask and the
    max_scans budget apply to the shard's own slice of every list."""
    cdtype = None if compute is None else jnp.dtype(compute)
    two_d = BATCH_AXIS in mesh.axis_names

    def local(cents, cvalid, xperm, sqnorm, alive, offsets, lens, crow, pos,
              q, ms_local):
        xperm, sqnorm, alive = xperm[0], sqnorm[0], alive[0]
        offsets, lens, crow, pos = offsets[0], lens[0], crow[0], pos[0]
        shard = jax.lax.axis_index(DATA_AXIS)
        probe, _, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, ms_local, metric, cdtype
        )
        mask = dense_probe_mask(probe, eff, crow, pos, alive, cents.shape[0])
        scores = score_matrix(q, xperm, metric, x_sqnorm=sqnorm,
                              compute_dtype=cdtype)
        # masked_topk pads when k exceeds the shard's slab rows
        vals, lrows = masked_topk(jnp.where(mask, scores, -jnp.inf), None, k)
        gidx = jnp.where(lrows >= 0, shard * stride + lrows, -1)
        return allgather_merge_topk(vals, gidx, k)

    q_spec = P(BATCH_AXIS, None) if two_d else P(None, None)
    out_one = P(BATCH_AXIS, None) if two_d else P(None, None)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, None), P(None),
            P(DATA_AXIS, None, None), P(DATA_AXIS, None), P(DATA_AXIS, None),
            P(DATA_AXIS, None), P(DATA_AXIS, None),
            P(DATA_AXIS, None), P(DATA_AXIS, None),
            q_spec, P(),
        ),
        out_specs=(out_one, out_one),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedIvfFlatIndex(IvfFlatIndex):
    """IvfFlatIndex whose built slab is list-sliced over a 1-D mesh.

    Host API/semantics identical to IvfFlatIndex (buffer, build, options);
    only the built-slab layout and the probed-scan kernel differ.
    """

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        nlist: int = 100,
        nprobe: int = 3,
        compute_dtype: Optional[str] = None,
        seed: int = 42,
        scan_mode: str = "auto",
        shard_by: str = "rows",       # rows | cluster (see module docstring)
        probe_cap: int | str = "auto",
    ):
        """``shard_by='cluster'`` deals whole lists to shards (greedy LPT
        size balance): the probe path scans ~nprobe/nd full lists per shard
        instead of nprobe padded slices — less per-shard work, but probe
        LOAD depends on the query (VERDICT r3 #6; no reference analog — it
        has no distribution at all). ``probe_cap`` bounds the static
        owned-probe slots per shard on that path: 'auto' provisions
        4x the balanced expectation (min(nprobe, max(8, 4*ceil(nprobe/nd)));
        owned probes beyond the cap are dropped — recall, not correctness,
        degrades, and only under heavy ownership skew), or pass nprobe for
        a no-drop guarantee at single-chip probe cost."""
        if shard_by not in ("rows", "cluster"):
            raise ValueError(f"shard_by must be rows|cluster, got {shard_by!r}")
        self.mesh = mesh if mesh is not None else default_mesh()
        # rows are dealt over the DATA axis only (a 2-D mesh replicates the
        # slab across BATCH groups)
        self._ndev = int(self.mesh.shape[DATA_AXIS])
        self.shard_by = shard_by
        self.probe_cap = probe_cap
        super().__init__(
            dim, metric, nlist=nlist, nprobe=nprobe,
            compute_dtype=compute_dtype, seed=seed, scan_mode=scan_mode,
        )
        self._fn_cache: dict = {}
        self._enc_to_perm: Optional[np.ndarray] = None   # encoded -> perm row

    def _install_device_slab(self, x_dev, order) -> None:
        """The single-chip build's device-side slab install doesn't apply:
        the sharded layout is round-robin per list and is materialized by
        this class's _sync. Defer to it."""
        self._dirty = True
        self._dev = None

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        nd = self._ndev
        k = self._lens.shape[0]
        kpad = round_up(max(k, 1), 8)
        owner = None
        if self.shard_by == "cluster":
            (local_lens, local_offsets, l_pad, cap_local, placements,
             owner) = cluster_layout(self._lens, self._offsets, nd, kpad)
        else:
            local_lens, local_offsets, l_pad, cap_local, placements = (
                roundrobin_layout(self._lens, self._offsets, nd, kpad)
            )
        stride = cap_local

        xp = np.zeros((nd, cap_local, self.dim), np.float32)
        alive = np.zeros((nd, cap_local), bool)
        enc_to_perm = np.full(nd * cap_local, -1, np.int64)
        for s, c, rows in placements:
            m = len(rows)
            xp[s, c : c + m] = self._xperm[rows]
            alive[s, c : c + m] = self._alive[rows]
            enc_to_perm[s * stride + c : s * stride + c + m] = rows
        sq = np.einsum("snd,snd->sn", xp, xp).astype(np.float32)

        # per-shard dense-scan tables (each local slab is cluster-major by
        # cursor construction in roundrobin_layout)
        crow_l = np.full((nd, cap_local), kpad - 1, np.int32)
        pos_l = np.zeros((nd, cap_local), np.int32)
        for s in range(nd):
            tot = int(local_lens[s].sum())
            if tot:
                crow_l[s, :tot] = np.repeat(
                    np.arange(kpad, dtype=np.int32), local_lens[s]
                )
                pos_l[s, :tot] = (
                    np.arange(tot, dtype=np.int32)
                    - local_offsets[s][crow_l[s, :tot]]
                )

        cents = np.zeros((kpad, self.dim), np.float32)
        cvalid = np.zeros(kpad, bool)
        if self._centroids is not None:
            cents[:k] = self._centroids
            cvalid[:k] = True

        row3 = NamedSharding(self.mesh, P(DATA_AXIS, None, None))
        row2 = NamedSharding(self.mesh, P(DATA_AXIS, None))
        self._enc_to_perm = enc_to_perm
        self._dev = {
            "cents": jnp.asarray(cents),
            "cvalid": jnp.asarray(cvalid),
            "xperm": jax.device_put(jnp.asarray(xp), row3),
            "sqnorm": jax.device_put(jnp.asarray(sq), row2),
            "alive": jax.device_put(jnp.asarray(alive), row2),
            "offsets": jax.device_put(jnp.asarray(local_offsets), row2),
            "lens": jax.device_put(jnp.asarray(local_lens), row2),
            "crow": jax.device_put(jnp.asarray(crow_l), row2),
            "pos": jax.device_put(jnp.asarray(pos_l), row2),
            "kpad": kpad,
            "l_pad": l_pad,
            "stride": stride,
            "k_actual": k,
            "owner": jnp.asarray(owner) if owner is not None else None,
            # decode tables CONSISTENT with these shards (rebuild swaps them)
            "enc_to_perm": enc_to_perm,
            "perm_ids": self._perm_ids,
        }
        self._dirty = False
        return self._dev

    def device_search(
        self, q: jax.Array, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[jax.Array, jax.Array]:
        if self._buffer.get_stats().count:
            raise RuntimeError("device_search requires an empty buffer; call build()")
        if not self._built:
            raise RuntimeError("device_search requires a built index")
        return self._device_scan(q, top_k, options)

    def _device_scan(
        self, q: jax.Array, top_k: int, options: SearchOptions
    ) -> tuple[jax.Array, jax.Array]:
        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        if options.max_scans is None:
            # uncapped: a shard may hold up to ceil(len/ndev) rows of EVERY
            # list plus rounding slack, so the only safe no-op budget is the
            # local slab capacity itself
            ms_local = dev["stride"]
        elif self.shard_by == "cluster":
            # whole lists live on one shard: each probed list is scanned
            # exactly once somewhere, so the closest analog of the global
            # budget is the full budget applied per shard in probe order
            # (the row layout divides instead — its shards scan 1/nd of
            # every list). Both are approximations of the single-chip
            # insertion-order semantics; tests pin the uncapped path only.
            ms_local = options.max_scans
        else:
            ms_local = (options.max_scans + self._ndev - 1) // self._ndev
        path = self._resolve_sharded_scan(dev, q.shape[0], nprobe)
        # metric is part of the key: load() may swap self.metric in place
        key = (top_k, nprobe, dev["l_pad"], dev["stride"], self.metric, path)
        fn = self._fn_cache.get(key)
        if fn is None:
            if path == "dense-xla":
                fn = make_sharded_ivf_dense_search(
                    self.mesh, self.metric, top_k, nprobe,
                    dev["stride"], self.compute_dtype,
                )
            elif self.shard_by == "cluster":
                fn = make_sharded_ivf_cluster_probe_search(
                    self.mesh, self.metric, top_k, nprobe,
                    self._resolve_probe_cap(nprobe), dev["l_pad"],
                    dev["stride"], self.compute_dtype,
                )
            else:
                fn = make_sharded_ivf_search(
                    self.mesh, self.metric, top_k, nprobe, dev["l_pad"],
                    dev["stride"], self.compute_dtype,
                )
            self._fn_cache[key] = fn
        if path == "dense-xla":
            return fn(
                dev["cents"], dev["cvalid"], dev["xperm"], dev["sqnorm"],
                dev["alive"], dev["offsets"], dev["lens"], dev["crow"],
                dev["pos"], q, device_i32(ms_local),
            )
        if self.shard_by == "cluster":
            return fn(
                dev["cents"], dev["cvalid"], dev["xperm"], dev["sqnorm"],
                dev["alive"], dev["offsets"], dev["lens"], dev["owner"],
                q, device_i32(ms_local),
            )
        return fn(
            dev["cents"], dev["cvalid"], dev["xperm"], dev["sqnorm"],
            dev["alive"], dev["offsets"], dev["lens"], q, device_i32(ms_local),
        )

    def _resolve_probe_cap(self, nprobe: int) -> int:
        """Static owned-probe slots per shard (cluster layout's probe path):
        an explicit int is clamped to [1, nprobe]; 'auto' provisions 4x the
        balanced expectation, floor 8 — P(max shard load > 4x mean) is
        negligible for random ownership, and the greedy LPT assignment
        de-correlates neighboring clusters, but a hostile query distribution
        can still concentrate: pass probe_cap=nprobe for the no-drop bound."""
        if isinstance(self.probe_cap, int):
            return max(1, min(self.probe_cap, nprobe))
        return min(nprobe, max(8, 4 * -(-nprobe // self._ndev)))

    def _resolve_sharded_scan(self, dev: dict, batch: int,
                              nprobe: int) -> str:
        """Per-shard kernel resolution (analog of IvfFlatIndex._resolve_scan
        on local shard volumes): 'probe' or 'dense-xla'."""
        # mode decided on per-shard local volumes (each shard scans its own
        # slab; stride ≈ local rows)
        mode = pick_scan_mode(self.scan_mode, dev["stride"], nprobe,
                              dev["l_pad"], batch=batch)
        return "dense-xla" if mode == "dense" else "probe"

    def describe_scan(self, batch: int, nprobe: Optional[int] = None,
                      max_scans: Optional[int] = None) -> str:
        """Sharded analog of IvfFlatIndex.describe_scan: resolution runs on
        per-shard local volumes, so the base-class tables don't apply."""
        if not self._built:
            return "buffer"
        dev = self._sync()
        np_eff = min(nprobe or self.nprobe, dev["k_actual"])
        return self._resolve_sharded_scan(dev, batch, np_eff)

    def _decode(self, rows: np.ndarray) -> np.ndarray:
        """Encoded candidates -> global perm rows (-1 stays -1)."""
        out = np.where(rows >= 0, self._enc_to_perm[np.maximum(rows, 0)], -1)
        return out

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        dec = self._decode(np.asarray(rows))
        return [
            [self._perm_ids[int(r)] if r >= 0 else "" for r in row]
            for row in dec
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
        buf_hits = (
            self._buffer.search_batch(q, top_k, options)
            if self._buffer.get_stats().count
            else [[] for _ in range(b)]
        )
        if not self._built or self._main_live == 0:
            return buf_hits
        bb = batch_bucket(b)
        qp = np.pad(q, ((0, bb - b), (0, 0))) if bb != b else q
        dev = self._sync()
        vals, rows = self._device_scan(jnp.asarray(qp), top_k, options)
        vals = np.asarray(vals)[:b]
        enc = np.asarray(rows)[:b]
        rows = np.where(enc >= 0, dev["enc_to_perm"][np.maximum(enc, 0)], -1)
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
