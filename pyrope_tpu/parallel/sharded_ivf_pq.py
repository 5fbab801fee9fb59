"""Corpus-sharded IVF-PQ: ADC scan over a device mesh.

Same layout as ShardedIvfFlatIndex (pyrope_tpu/parallel/sharded_ivf.py) —
every inverted list's PQ codes are dealt round-robin across the ``data``
axis so each shard owns ~1/ndev of every list in its own contiguous
cluster-major code slab — but the per-shard scan is the ADC kernel
(tables from replicated codebooks, gather-free one-hot accumulation).
At M=4/ksub=256 each shard holds N·4/ndev bytes of codes: a 1B-vector
corpus is 1 GB of codes per device on four devices.

Candidate encoding across shards: shard * stride + local_slab_pos.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyrope_tpu.ops.topk import masked_topk
from pyrope_tpu.index.ivf_flat import pick_scan_mode, rank_probes
from pyrope_tpu.index.ivf_pq import (
    IvfPqIndex,
    adc_scan_dense,
    adc_scan_probed_lists,
    compute_cdot,
)
from pyrope_tpu.ops.scalars import device_i32
from pyrope_tpu.parallel.mesh import (
    BATCH_AXIS,
    DATA_AXIS,
    allgather_merge_topk,
    default_mesh,
)
from pyrope_tpu.parallel.sharded_ivf import roundrobin_layout
from pyrope_tpu.types import (
    DEFAULT_SEARCH_OPTIONS,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu.utils.shapes import batch_bucket, round_up


def make_sharded_ivfpq_search(
    mesh: Mesh, metric: Metric, k: int, nprobe: int, l_pad: int,
    stride: int, probe_metric: Metric, refine_r: int = 0,
):
    """With ``refine_r`` > 0 every shard reranks its own ADC top-R locally
    (exact re-score against its raw-slab shard) BEFORE the collective, so
    the ICI all_gather payload stays [B, k]. The union of per-shard top-R
    shortlists is a superset of the global top-R, so the sharded result
    matches the single-chip rerank exactly (up to fp ties)."""

    def local(cents, cvalid, codes, alive, offsets, lens, codebooks,
              xraw, xsq, q, ms_local):
        codes, alive = codes[0], alive[0]
        offsets, lens = offsets[0], lens[0]
        shard = jax.lax.axis_index(DATA_AXIS)
        probe, offs_p, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, ms_local, probe_metric, None
        )
        if refine_r:
            from pyrope_tpu.ops.distance import rerank_exact

            _, cand = adc_scan_probed_lists(
                codes, alive, q, cents, codebooks, probe, offs_p, eff,
                k=refine_r, l_pad=l_pad, metric=metric,  # local slab rows
            )
            vals, lid = rerank_exact(xraw[0], xsq[0], q, cand, k, metric)
            gidx = jnp.where(lid >= 0, shard * stride + lid, -1)
        else:
            vals, gidx = adc_scan_probed_lists(
                codes, alive, q, cents, codebooks, probe, offs_p, eff,
                k=k, l_pad=l_pad, metric=metric, row_base=shard * stride,
            )
        return allgather_merge_topk(vals, gidx, k)

    # 2-D batch x data mesh: queries shard over BATCH_AXIS like the flat/
    # IVF siblings (each batch group scans the full data axis independently)
    two_d = BATCH_AXIS in mesh.axis_names
    q_spec = P(BATCH_AXIS, None) if two_d else P(None, None)
    out_one = P(BATCH_AXIS, None) if two_d else P(None, None)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, None), P(None),                        # centroids replicated
            P(DATA_AXIS, None, None), P(DATA_AXIS, None),  # codes, alive
            P(DATA_AXIS, None), P(DATA_AXIS, None),        # offsets, lens
            P(None, None, None),                           # codebooks replicated
            P(DATA_AXIS, None, None), P(DATA_AXIS, None),  # rerank slab + sqnorms
            q_spec, P(),
        ),
        out_specs=(out_one, out_one),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_ivfpq_dense_search(
    mesh: Mesh, metric: Metric, k: int, nprobe: int,
    stride: int, probe_metric: Metric, refine_r: int = 0,
):
    """shard_map'd DENSE scan. With ``refine_r`` == 0: one shared-slab ADC
    accumulate per shard (pyrope_tpu/index/ivf_pq.py adc_scan_dense) masked
    by the shard's local CSR. With ``refine_r`` > 0 the raw rerank slab is
    resident, so each shard exact-scores ALL its probed rows directly (see
    _ivfpq_dense_exact_fn — dominates ADC-shortlist→rerank in recall and
    speed; the wide top_k(R) is what made the shortlist slow). Then the
    [B, k] all_gather merge."""

    def local(cents, cvalid, codes, alive, offsets, lens, codebooks,
              cdot, crow, pos, xraw, xsq, q, ms_local):
        from pyrope_tpu.index.ivf_flat import dense_probe_mask
        from pyrope_tpu.ops.distance import score_matrix

        codes, alive = codes[0], alive[0]
        offsets, lens = offsets[0], lens[0]
        cdot, crow, pos = cdot[0], crow[0], pos[0]
        shard = jax.lax.axis_index(DATA_AXIS)
        probe, _, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, ms_local, probe_metric, None
        )
        if refine_r:
            mask = dense_probe_mask(probe, eff, crow, pos, alive, cents.shape[0])
            scores = score_matrix(q, xraw[0].astype(jnp.float32), metric,
                                  x_sqnorm=xsq[0])
            # masked_topk pads when k exceeds the shard's slab rows
            vals, lid = masked_topk(jnp.where(mask, scores, -jnp.inf), None, k)
            gidx = jnp.where(lid >= 0, shard * stride + lid, -1)
        else:
            vals, lid = adc_scan_dense(
                codes, alive, q, cents, codebooks, cdot, crow, pos,
                probe, eff, k=k, metric=metric,
            )
            gidx = jnp.where(lid >= 0, shard * stride + lid, -1)
        return allgather_merge_topk(vals, gidx, k)

    two_d = BATCH_AXIS in mesh.axis_names
    q_spec = P(BATCH_AXIS, None) if two_d else P(None, None)
    out_one = P(BATCH_AXIS, None) if two_d else P(None, None)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, None), P(None),
            P(DATA_AXIS, None, None), P(DATA_AXIS, None),
            P(DATA_AXIS, None), P(DATA_AXIS, None),
            P(None, None, None),
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None),
            P(DATA_AXIS, None, None), P(DATA_AXIS, None),
            q_spec, P(),
        ),
        out_specs=(out_one, out_one),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedIvfPqIndex(IvfPqIndex):
    """IvfPqIndex whose code slab is list-sliced over a 1-D mesh."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        nlist: int = 100,
        pq_m: int = 4,
        ksub: int = 256,
        nprobe: int = 3,
        seed: int = 123,
        refine: int = 64,
        scan_mode: str = "auto",
    ):
        self.mesh = mesh if mesh is not None else default_mesh()
        self._ndev = int(self.mesh.shape[DATA_AXIS])  # rows deal over DATA only
        super().__init__(
            dim, metric, nlist=nlist, pq_m=pq_m, ksub=ksub,
            nprobe=nprobe, seed=seed, refine=refine, scan_mode=scan_mode,
        )
        self._fn_cache: dict = {}
        self._enc_to_perm: Optional[np.ndarray] = None

    def _install_device_slab(self, x_dev, codes_dev, order) -> None:
        """Single-chip device-side install doesn't apply to the sharded
        round-robin layout; defer to this class's _sync."""
        self._dirty = True
        self._dev = None

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        nd = self._ndev
        k = self._lens.shape[0]
        kpad = round_up(max(k, 1), 8)
        m = self.pq.m
        local_lens, local_offsets, l_pad, cap_local, placements = roundrobin_layout(
            self._lens, self._offsets, nd, kpad
        )
        stride = cap_local

        codes = np.zeros((nd, cap_local, m), np.uint8)
        alive = np.zeros((nd, cap_local), bool)
        enc_to_perm = np.full(nd * cap_local, -1, np.int64)
        xraw = (
            np.zeros((nd, cap_local, self.dim), np.float32)
            if self.refine > 0 else None
        )
        # per-shard dense-scan tables (local slabs are cluster-major by
        # cursor construction) + the query-independent cdot constants
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
        cdot_l = np.zeros((nd, cap_local), np.float32)
        n_total = self._codes.shape[0]
        # cdot feeds only the refine=0 dense-ADC score path (see
        # IvfPqIndex._host_tables) — skip the O(N·D) decode when reranking
        if (self.refine == 0 and n_total and self.pq.trained
                and self._centroids is not None):
            crow_global = np.repeat(
                np.arange(k, dtype=np.int32), self._lens
            )
            cdot_global = compute_cdot(
                self._codes, crow_global, self._centroids, self.pq.codebooks
            )
        else:
            cdot_global = None
        for s, c, rows in placements:
            n_rows = len(rows)
            codes[s, c : c + n_rows] = self._codes[rows]
            alive[s, c : c + n_rows] = self._alive[rows]
            if xraw is not None:
                xraw[s, c : c + n_rows] = self._xperm[rows]
            if cdot_global is not None:
                cdot_l[s, c : c + n_rows] = cdot_global[rows]
            enc_to_perm[s * stride + c : s * stride + c + n_rows] = rows

        cents = np.zeros((kpad, self.dim), np.float32)
        cvalid = np.zeros(kpad, bool)
        if self._centroids is not None:
            cents[:k] = self._centroids
            cvalid[:k] = True
        cbs = (
            self.pq.codebooks
            if self.pq.codebooks is not None
            else np.zeros((m, self.pq.ksub, self.pq.sub), np.float32)
        )

        row3 = NamedSharding(self.mesh, P(DATA_AXIS, None, None))
        row2 = NamedSharding(self.mesh, P(DATA_AXIS, None))
        self._enc_to_perm = enc_to_perm
        self._dev = {
            "cents": jnp.asarray(cents),
            "cvalid": jnp.asarray(cvalid),
            "codes": jax.device_put(jnp.asarray(codes), row3),
            "alive": jax.device_put(jnp.asarray(alive), row2),
            "offsets": jax.device_put(jnp.asarray(local_offsets), row2),
            "lens": jax.device_put(jnp.asarray(local_lens), row2),
            "crow": jax.device_put(jnp.asarray(crow_l), row2),
            "pos": jax.device_put(jnp.asarray(pos_l), row2),
            "cdot": jax.device_put(jnp.asarray(cdot_l), row2),
            "codebooks": jnp.asarray(cbs),
            "kpad": kpad,
            "l_pad": l_pad,
            "stride": stride,
            "k_actual": k,
            # decode tables CONSISTENT with these shards (rebuild swaps them)
            "enc_to_perm": enc_to_perm,
            "perm_ids": self._perm_ids,
        }
        if xraw is not None:
            dt = jnp.bfloat16 if self.refine_storage == "bf16" else jnp.float32
            sq = np.einsum("snd,snd->sn", xraw, xraw).astype(np.float32)
            self._dev["xraw"] = jax.device_put(jnp.asarray(xraw, dtype=dt), row3)
            self._dev["xsqnorm"] = jax.device_put(jnp.asarray(sq), row2)
        else:
            # dummies keep the shard_map signature static across configs
            dt = jnp.bfloat16 if self.refine_storage == "bf16" else jnp.float32
            self._dev["xraw"] = jax.device_put(
                jnp.zeros((nd, 1, self.dim), dtype=dt), row3)
            self._dev["xsqnorm"] = jax.device_put(
                jnp.zeros((nd, 1), jnp.float32), row2)
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
            ms_local = dev["stride"]
        else:
            ms_local = (options.max_scans + self._ndev - 1) // self._ndev
        search_metric = (
            Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric
        )
        probe_metric = Metric.L2 if self.metric == Metric.COSINE else self.metric
        refine_r = (
            max(top_k, min(self.refine * top_k, dev["stride"]))
            if self.refine > 0 else 0
        )
        mode = self._resolve_sharded_scan(dev, q.shape[0], nprobe)
        # metric is part of the key: load() may swap self.metric in place
        key = (top_k, nprobe, dev["l_pad"], dev["stride"], self.metric,
               refine_r, mode)
        fn = self._fn_cache.get(key)
        if fn is None:
            if mode == "dense":
                fn = make_sharded_ivfpq_dense_search(
                    self.mesh, search_metric, top_k, nprobe,
                    dev["stride"], probe_metric, refine_r,
                )
            else:
                fn = make_sharded_ivfpq_search(
                    self.mesh, search_metric, top_k, nprobe, dev["l_pad"],
                    dev["stride"], probe_metric, refine_r,
                )
            self._fn_cache[key] = fn
        if mode == "dense":
            return fn(
                dev["cents"], dev["cvalid"], dev["codes"], dev["alive"],
                dev["offsets"], dev["lens"], dev["codebooks"],
                dev["cdot"], dev["crow"], dev["pos"],
                dev["xraw"], dev["xsqnorm"], q, device_i32(ms_local),
            )
        return fn(
            dev["cents"], dev["cvalid"], dev["codes"], dev["alive"],
            dev["offsets"], dev["lens"], dev["codebooks"],
            dev["xraw"], dev["xsqnorm"], q, device_i32(ms_local),
        )

    def _resolve_sharded_scan(self, dev: dict, batch: int,
                              nprobe: int) -> str:
        """Scan mode ('dense' or 'probe') on per-shard local volumes.

        With ``refine > 0`` auto mode resolves by LOCAL index size only —
        never by batch — matching the single-chip batch-invariance contract
        (IvfPqIndex._resolve_scan: dense and probe return different hit
        sets when reranking, so the same index + query must not flip modes
        across batch sizes; only the OOM guard may demote)."""
        from pyrope_tpu.index.ivf_flat import DENSE_MAX_ROWS, dense_max_elems

        if self.scan_mode == "auto" and self.refine > 0:
            mode = "dense" if dev["stride"] <= DENSE_MAX_ROWS else "probe"
            if batch * dev["stride"] > dense_max_elems():
                mode = "probe"  # OOM guard outranks batch-invariance
            return mode
        return pick_scan_mode(self.scan_mode, dev["stride"], nprobe,
                              dev["l_pad"], batch=batch)

    def describe_scan(self, batch: int, nprobe: Optional[int] = None,
                      max_scans: Optional[int] = None) -> str:
        """Sharded analog of IvfPqIndex.describe_scan on per-shard volumes."""
        if not self._built:
            return "buffer"
        dev = self._sync()
        np_eff = min(nprobe or self.nprobe, dev["k_actual"])
        mode = self._resolve_sharded_scan(dev, batch, np_eff)
        if mode != "dense":
            return "probe-adc+rerank" if self.refine > 0 else "probe-adc"
        if self.refine == 0:
            return "dense-adc"
        return "dense-exact-xla"

    def _decode(self, rows: np.ndarray) -> np.ndarray:
        return np.where(rows >= 0, self._enc_to_perm[np.maximum(rows, 0)], -1)

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
        qq = self._normalize(q) if self.metric == Metric.COSINE else q
        bb = batch_bucket(b)
        qp = np.pad(qq, ((0, bb - b), (0, 0))) if bb != b else qq
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
