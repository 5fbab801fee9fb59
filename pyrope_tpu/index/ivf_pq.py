"""IVF-PQ index: coarse quantizer + product-quantized residuals with ADC.

Rebuild of the reference's ``IvfPqVectorIndex``
(ref: src/Pyrope.GarnetServer/Vector/IvfPqVectorIndex.cs):

- ``build()``: coarse k-means (seed 123, :67-70), residuals r = v − c
  (:73-86), PQ trained on residuals (:89), encode into inverted lists
  (:92-107)
- ``search``: exact buffer scan (:129-136), rank centroids (:140-148), per
  probed list compute the residual-query ADC table and score
  −Σ_m table[m][code[m]] (:152-199)
- reference gaps closed here: main-slab deletes are tombstoned (ref deletes
  only from the buffer, TODO at :48-53), snapshot/load are implemented
  (ref stubs at :228-230; SURVEY §5.4 flags this gap), and an exact rerank
  stage refines the ADC shortlist (the reference's ADC scores are final,
  the source of its recall ceiling — :152-199).

Device layout: codes live cluster-major in a contiguous [N_pad, M] uint8 slab
(CSR offsets + lens); probing a list is a contiguous dynamic-slice; the ADC
table is one einsum and accumulation is a flat take_along_axis gather.
Device memory holds only codes + centroids + codebooks (the memory-parity state); raw
fp32 rows are retained host-side for rebuild/compaction.

Metrics: L2 exact-ADC (‖q−x̂‖² = ‖q_res−r̂‖²); IP via q·c + q·r̂ (the dot
table is probe-independent); COSINE = IP over pre-normalized rows and
queries.
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
from pyrope_tpu.ops.kmeans import kmeans_build
from pyrope_tpu.ops.pq import (
    ProductQuantizer,
    adc_accumulate,
    adc_ip_table,
    adc_l2_table,
    pq_train_encode_device,
)
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

COARSE_SEED = 123  # ref: IvfPqVectorIndex.cs:67-70 coarse k-means seed 123
DEFAULT_NPROBE = 3


def compute_cdot(
    codes: np.ndarray, crow_n: np.ndarray,
    centroids: np.ndarray, codebooks: np.ndarray,
) -> np.ndarray:
    """cdot[n] = c·r̂ — the query-independent term of the dense ADC
    decomposition (see ``adc_scan_dense``). Host-side, chunked to bound the
    decode buffer. codes: [N, M] uint8, crow_n: [N] cluster per row."""
    n = codes.shape[0]
    out = np.zeros(n, np.float32)
    m, _, sub = codebooks.shape
    mi = np.arange(m)
    for s in range(0, n, 262_144):
        e = min(s + 262_144, n)
        dec = codebooks[mi[None, :], codes[s:e].astype(np.int64)]  # [c, M, sub]
        csub = centroids[crow_n[s:e]].reshape(e - s, m, sub)
        out[s:e] = np.einsum("nms,nms->n", dec, csub)
    return out


@jax.jit
def _residuals(x, cents, assign):
    """r = v - c on device (ref: IvfPqVectorIndex.cs:73-86 Parallel.For)."""
    return x - jnp.take(cents, assign, axis=0)


def sq8res_encode_host(
    xp: np.ndarray, cents: np.ndarray, crow_n: np.ndarray,
    chunk: int = 262_144,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side residual-SQ8 encoding of the rerank slab (the device path
    is ops/slab.take_slab_sq8res — same algebra). Chunked to bound the
    residual buffer; returns (codes u8 [n, D], mins, scales, sqnorm)."""
    n, d = xp.shape
    codes = np.zeros((n, d), np.uint8)
    mins = np.zeros(n, np.float32)
    scales = np.zeros(n, np.float32)
    sq = np.zeros(n, np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        c = cents[crow_n[s:e]]
        r = xp[s:e].astype(np.float32) - c
        mn = r.min(axis=1)
        sc = np.maximum(r.max(axis=1) - mn, 1e-12) / 255.0
        q8 = np.clip(
            np.round((r - mn[:, None]) / sc[:, None]), 0, 255
        ).astype(np.uint8)
        xhat = c + mn[:, None] + sc[:, None] * q8.astype(np.float32)
        codes[s:e] = q8
        mins[s:e] = mn
        scales[s:e] = sc
        sq[s:e] = np.einsum("nd,nd->n", xhat, xhat)
    return codes, mins, scales, sq


def adc_scan_probed_lists(
    codes_perm, alive, q, cents, codebooks, probe, offs_p, eff,
    *, k: int, l_pad: int, metric: Metric, row_base=0,
):
    """ADC scan of every probed list's code slice with a running top-k
    merge (ref: IvfPqVectorIndex.cs:152-199). ``row_base`` offsets emitted
    candidates for the sharded variant (shard*stride).

    Shared by the single-chip kernel and
    pyrope_tpu/parallel/sharded_ivf_pq.py."""
    b = q.shape[0]
    m = codes_perm.shape[1]
    nprobe = probe.shape[1]
    j = jax.lax.broadcasted_iota(jnp.int32, (1, l_pad), 1)
    vals = jnp.full((b, k), -jnp.inf, jnp.float32)
    gidx = jnp.full((b, k), -1, jnp.int32)

    if metric != Metric.L2:
        # dot table is residual-free: q·r̂ uses the same table per probe
        ip_table = adc_ip_table(q, codebooks)       # [B, M, ksub]
        qdotc = jnp.dot(q, cents.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)

    for p in range(nprobe):
        c_ids = probe[:, p]
        off = offs_p[:, p]
        blocks = jax.vmap(
            lambda o: jax.lax.dynamic_slice(codes_perm, (o, 0), (l_pad, m))
        )(off)                                      # [B, L_pad, M] uint8
        alv = jax.vmap(lambda o: jax.lax.dynamic_slice(alive, (o,), (l_pad,)))(off)
        if metric == Metric.L2:
            cent_p = cents[c_ids]                   # [B, D]
            table = adc_l2_table(q - cent_p, codebooks)
            scores = -adc_accumulate(table, blocks)  # score = −Σ table (ref :182-198)
        else:
            adc = adc_accumulate(ip_table, blocks)
            base = jnp.take_along_axis(qdotc, c_ids[:, None], axis=1)  # q·c
            scores = base + adc
        mask = (j < eff[:, p : p + 1]) & alv
        svals = jnp.where(mask, scores, -jnp.inf)
        rows = row_base + off[:, None] + j
        vals, gidx = merge_topk(vals, gidx, svals, rows, k)
    return vals, gidx


def adc_scan_dense(
    codes_all, alive, q, cents, codebooks, cdot, crow, pos, probe, eff,
    *, k: int, metric: Metric,
):
    """Dense ADC scan: ONE shared-slab accumulate over every code row,
    masked by probe membership — the IVF-PQ analog of the dense IVF-Flat
    kernel (see pyrope_tpu/index/ivf_flat.py module docstring).

    The per-probe residual table is decomposed so nothing depends on the
    (query, probe) pair:

      L2:  ‖(q−c) − r̂‖² = Σ_m‖q_m−r̂_m‖² + 2·c·r̂ + (‖c‖² − 2·q·c)
           = T0sum[b,n]  +  2·cdot[n]  +  D2[b, crow[n]]
           with T0 = adc_l2_table(q, cb) (residual-FREE, one per query),
           cdot[n] = c·r̂ (build-time constant per row),
           D2[b,c] = ‖c‖² − 2·q·c (one [B,K] matrix).
      IP:  q·c + q·r̂ = QC[b, crow[n]] + IPsum[b,n].

    Same scores as ``adc_scan_probed_lists`` up to fp summation order.
    """
    from pyrope_tpu.index.ivf_flat import dense_probe_mask
    from pyrope_tpu.ops.pq import adc_accumulate_shared

    kpad = cents.shape[0]
    qdotc = jnp.dot(q, cents.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)        # [B, K]
    if metric == Metric.L2:
        t0 = adc_l2_table(q, codebooks)                         # residual-free
        t0sum = adc_accumulate_shared(t0, codes_all)            # [B, N]
        cc = jnp.sum(cents.astype(jnp.float32) ** 2, axis=-1)   # [K]
        d2 = cc[None, :] - 2.0 * qdotc                          # [B, K]
        scores = -(t0sum + 2.0 * cdot[None, :] + d2[:, crow])
    else:
        ip = adc_ip_table(q, codebooks)
        scores = qdotc[:, crow] + adc_accumulate_shared(ip, codes_all)
    mask = dense_probe_mask(probe, eff, crow, pos, alive, kpad)
    # masked_topk pads when k exceeds the slab (matches the probe kernel)
    return masked_topk(jnp.where(mask, scores, -jnp.inf), None, k)


@functools.lru_cache(maxsize=None)
def _ivfpq_dense_fn(
    metric: Metric, k: int, nprobe: int,
    probe_metric: Metric | None = None,
):
    """Dense-mask pure ADC (refine=0): one shared-slab accumulate + top-k."""

    @jax.jit
    def fn(cents, cvalid, codes_all, alive, offsets, lens, codebooks,
           cdot, crow, pos, q, max_scans):
        from pyrope_tpu.index.ivf_flat import rank_probes

        probe, _, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans,
            probe_metric or metric, None,
        )
        return adc_scan_dense(
            codes_all, alive, q, cents, codebooks, cdot, crow, pos,
            probe, eff, k=k, metric=metric,
        )

    return fn


@functools.lru_cache(maxsize=None)
def _ivfpq_dense_exact_fn(
    metric: Metric, k: int, nprobe: int,
    probe_metric: Metric | None = None,
):
    """Dense EXACT scan over the rerank slab (refine > 0).

    When reranking is on, the raw-row slab is already device-resident — so
    the dense path skips ADC entirely and exact-scores every probed row
    directly (one matmul + mask + top-k). This strictly dominates
    ADC-shortlist→rerank in BOTH recall (no shortlist misses) and speed: the
    shortlist's wide top_k(R=refine·k) over [B, N] costs far more than a
    top_k(k) (selection, not scoring, dominates). ADC still earns its keep
    in probe mode at large N where the gathers touch M code bytes per row
    instead of 4·D.

    Precision matches ``rerank_exact``: a bf16 slab is promoted to fp32 in
    the matmul operand and the contraction runs fp32 HIGHEST, so the only
    inexactness is the slab's own storage rounding (CLAUDE.md invariant).
    """

    @jax.jit
    def fn(cents, cvalid, alive, offsets, lens, crow, pos, xraw, sqnorm,
           q, max_scans):
        from pyrope_tpu.index.ivf_flat import dense_probe_mask, rank_probes
        from pyrope_tpu.ops.distance import score_matrix

        probe, _, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans,
            probe_metric or metric, None,
        )
        mask = dense_probe_mask(probe, eff, crow, pos, alive, cents.shape[0])
        scores = score_matrix(q, xraw.astype(jnp.float32), metric,
                              x_sqnorm=sqnorm)
        # masked_topk pads when k exceeds the slab (matches the probe kernel)
        return masked_topk(jnp.where(mask, scores, -jnp.inf), None, k)

    return fn


@functools.lru_cache(maxsize=None)
def _ivfpq_search_fn(metric: Metric, k: int, nprobe: int, l_pad: int, probe_metric: Metric | None = None):
    @jax.jit
    def fn(cents, cvalid, codes_perm, alive, offsets, lens, codebooks, q, max_scans):
        from pyrope_tpu.index.ivf_flat import rank_probes

        probe, offs_p, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans,
            probe_metric or metric, None,
        )
        return adc_scan_probed_lists(
            codes_perm, alive, q, cents, codebooks, probe, offs_p, eff,
            k=k, l_pad=l_pad, metric=metric,
        )

    return fn


@functools.lru_cache(maxsize=None)
def _ivfpq_refine_search_fn(
    metric: Metric, k: int, nprobe: int, l_pad: int, refine_r: int,
    probe_metric: Metric | None = None,
):
    """ADC shortlist (top-R) -> exact gather-rerank -> final top-k. The
    reference scores with ADC only (IvfPqVectorIndex.cs:152-199); the rerank
    stage restores near-IVF-Flat recall for one extra gather + einsum."""

    @jax.jit
    def fn(cents, cvalid, codes_perm, alive, offsets, lens, codebooks,
           xraw, sqnorm, q, max_scans):
        from pyrope_tpu.index.ivf_flat import rank_probes
        from pyrope_tpu.ops.distance import rerank_exact

        probe, offs_p, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans,
            probe_metric or metric, None,
        )
        _, cand = adc_scan_probed_lists(
            codes_perm, alive, q, cents, codebooks, probe, offs_p, eff,
            k=refine_r, l_pad=l_pad, metric=metric,
        )
        return rerank_exact(xraw, sqnorm, q, cand, k, metric)

    return fn


# ---- residual-SQ8 rerank slab (refine_storage="sq8res") ---------------------
# The memory-lean compressed-but-high-recall config (VERDICT r4 #2): the
# rerank slab lives as per-row residual-SQ8 codes (N·(D+12) bytes — 1/4 of
# fp32 at D=128) and scoring reconstructs x̂ = c[crow] + min + scale·code IN
# the score algebra. Quantizing the RESIDUAL keeps the affine step sized to
# the cluster radius, not the corpus extent — measured r@10 0.9906 on the
# 1M-clustered regime vs bf16's 0.9625 at half the bytes (2026-08-20
# isolation experiment, perfect-shortlist rescore).


@functools.lru_cache(maxsize=None)
def _ivfpq_dense_sq8_xla_fn(
    metric: Metric, k: int, nprobe: int,
    probe_metric: Metric | None = None,
):
    """XLA dense scan of the residual-SQ8 slab: the decomposition
    q·x̂ = qc[b, crow] + (q @ codesᵀ)·scale + (Σq)·min, with [B, N]
    transients (the dense_max_elems guard applies, like every XLA dense
    path)."""

    @jax.jit
    def fn(cents, cvalid, codes8, mins, scales, sq8, alive, offsets, lens,
           crow, pos, q, max_scans):
        from pyrope_tpu.index.ivf_flat import dense_probe_mask, rank_probes

        probe, _, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans,
            probe_metric or metric, None,
        )
        mask = dense_probe_mask(probe, eff, crow, pos, alive, cents.shape[0])
        qf = q.astype(jnp.float32)
        qc = jnp.dot(qf, cents.T, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)       # [B, Kp]
        dots8 = jnp.dot(qf, codes8.astype(jnp.float32).T,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)    # [B, N]
        qsum = jnp.sum(qf, axis=1, keepdims=True)
        qx = qc[:, crow] + dots8 * scales[None, :] + qsum * mins[None, :]
        if metric == Metric.L2:
            qq = jnp.sum(qf * qf, axis=1, keepdims=True)
            scores = -jnp.maximum(qq - 2.0 * qx + sq8[None, :], 0.0)
        else:  # IP (cosine rows pre-normalized upstream)
            scores = qx
        return masked_topk(jnp.where(mask, scores, -jnp.inf), None, k)

    return fn


@functools.lru_cache(maxsize=None)
def _ivfpq_refine_sq8_search_fn(
    metric: Metric, k: int, nprobe: int, l_pad: int, refine_r: int,
    probe_metric: Metric | None = None,
):
    """Probe-mode ADC shortlist -> exact rerank off the residual-SQ8 slab
    (the sq8res analog of _ivfpq_refine_search_fn)."""

    @jax.jit
    def fn(cents, cvalid, codes_perm, alive, offsets, lens, codebooks,
           codes8, mins, scales, sq8, crow, q, max_scans):
        from pyrope_tpu.index.ivf_flat import rank_probes
        from pyrope_tpu.ops.distance import rerank_exact_sq8res

        probe, offs_p, eff = rank_probes(
            q, cents, cvalid, offsets, lens, nprobe, max_scans,
            probe_metric or metric, None,
        )
        _, cand = adc_scan_probed_lists(
            codes_perm, alive, q, cents, codebooks, probe, offs_p, eff,
            k=refine_r, l_pad=l_pad, metric=metric,
        )
        return rerank_exact_sq8res(
            codes8, mins, scales, crow, cents, sq8, q, cand, k, metric,
        )

    return fn


class IvfPqIndex(VectorIndex, CentroidsProvider):
    @property
    def host_write_cheap(self) -> bool:  # see IVectorIndex
        # writes land in the Flat buffer; cheap while it needs no realloc
        return self._buffer.host_write_cheap

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        nlist: int = 100,   # ref config nlist=100
        pq_m: int = 4,      # ref config m=4
        ksub: int = 256,    # ref config k=256
        nprobe: int = DEFAULT_NPROBE,
        seed: int = COARSE_SEED,
        refine: int = 64,
        refine_storage: str = "fp32",  # fp32 | bf16 | sq8res (memory-lean)
        train_dtype: Optional[str] = None,
        scan_mode: str = "auto",
        train_init: str = "kmeans++",  # coarse init; | "sample" (ref init)
    ):
        """``refine``: exact-rerank shortlist factor — ADC selects
        ``refine * top_k`` candidates whose raw rows are gathered and
        re-scored exactly on device. 0 disables rerank (pure-ADC scoring,
        the reference's memory-parity behavior). Default 64: on uniform-128
        100k at m=4 (the worst ADC regime, 32x compression) R=640 recovers
        0.92x the IVF-Flat recall at equal nprobe (vs 0.14x without rerank);
        the gather cost is negligible next to the list scans.
        ``refine_storage`` sets the device dtype of the raw slab kept for
        reranking. Default fp32 (the exact-path invariant): a bf16 slab
        halves rerank memory but its ~0.4% rounding reorders near-ties —
        on 1M-clustered, where every list member is nearly equidistant,
        bf16 capped recall at 0.71 regardless of nprobe/refine width
        (fp32 restores ~IVF-Flat recall; measured 2026-08-17).
        "sq8res" stores the slab as per-row residual-SQ8 (uint8 codes +
        min/scale against the row's own coarse centroid — N·(D+12) bytes,
        1/4 of fp32 at D=128): the quantization step tracks the CLUSTER
        radius instead of bf16's relative rounding, so near-tie margins
        survive — measured r@10 0.9906 on 1M-clustered (bf16: 0.9625) at
        half bf16's bytes. The compressed-memory high-recall config.
        ``scan_mode``: 'auto' | 'dense' | 'probe' — dense runs
        one shared-slab ADC pass masked by probe membership (see
        ``adc_scan_dense``), probe slices each probed list per query."""
        if scan_mode not in ("auto", "dense", "probe"):
            raise ValueError(f"scan_mode must be auto|dense|probe, got {scan_mode!r}")
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.seed = seed
        self.refine = int(refine)
        if refine_storage not in ("bf16", "fp32", "sq8res"):
            raise ValueError(
                f"refine_storage must be bf16|fp32|sq8res, got {refine_storage}"
            )
        self.refine_storage = refine_storage
        self.train_dtype = train_dtype  # training matmuls only (see IvfFlatIndex)
        self.scan_mode = scan_mode
        self.train_init = train_init
        self.pq = ProductQuantizer(m=int(pq_m), ksub=int(ksub), dim=self.dim)

        self._buffer = FlatIndex(dim, self.metric)
        self._built = False
        self._centroids: Optional[np.ndarray] = None
        # host-only raw rows; permuted slab + id->row dict are LAZY, same
        # rationale and mechanism as IvfFlatIndex (first-touch fault cost)
        self._xperm_cache: Optional[np.ndarray] = np.zeros((0, self.dim), np.float32)
        self._xbase: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None
        self._codes = np.zeros((0, self.pq.m), np.uint8)
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

    @property
    def _main_pos(self) -> dict[str, int]:
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

    # ---- mutation (same buffer-first discipline as IVF-Flat) -------------

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
                self._alive[row] = False
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

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        if self.metric != Metric.COSINE:
            return x
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return (x / np.maximum(n, 1e-12)).astype(np.float32)

    def build(self) -> None:
        with self.lock:
            self._build_locked()

    def _build_locked(self) -> None:
        ids: list[str] = []
        rows: list[np.ndarray] = []
        main_live = [r for r in range(len(self._perm_ids)) if self._alive[r]]
        if main_live:
            ids.extend(self._perm_ids[r] for r in main_live)
            rows.append(self._xperm[main_live])
        bids, bvecs = self._buffer.live_vectors()
        if bids:
            ids.extend(bids)
            rows.append(self._normalize(bvecs))
        if not ids:
            return
        x = np.concatenate(rows) if len(rows) > 1 else rows[0]
        n = x.shape[0]
        kc = min(self.nlist, n)

        metric = Metric.L2 if self.metric == Metric.COSINE else self.metric
        # single corpus upload: coarse train/assign, residuals, PQ training,
        # encoding, and the permuted slabs all reuse one device buffer
        # (VERDICT r1 #3 — the m16 build was 16 sequential k-means each
        # re-uploading its subspace)
        cents, assign, x_dev = kmeans_build(
            x, kc, metric, seed=self.seed, compute_dtype=self.train_dtype,
            init=self.train_init,
        )

        codes_dev = None
        if n >= self.pq.ksub:
            assign_pad = np.zeros(x_dev.shape[0], np.int32)
            assign_pad[:n] = assign
            r_dev = _residuals(x_dev, jnp.asarray(cents), jnp.asarray(assign_pad))
            codebooks, codes_dev = pq_train_encode_device(
                r_dev, n, self.pq, seed=42, compute=self.train_dtype  # ref PQ seed 42+m
            )
            self.pq.codebooks = codebooks
            codes = np.asarray(codes_dev)[:n].astype(np.uint8)
        else:  # tiny corpus: host path handles k < ksub centroid duplication
            residuals = x - cents[assign]                  # ref :73-86
            self.pq.train(residuals, seed=42)
            codes = self.pq.encode(residuals)

        order = np.argsort(assign, kind="stable")
        # defer the raw-row host permute + id->row dict (lazy properties)
        self._xperm_cache = None
        self._xbase = x
        self._order = order
        self._codes = np.ascontiguousarray(codes[order])
        self._perm_ids = [ids[i] for i in order]
        self._main_pos_cache = None
        self._alive = np.ones(n, bool)
        self._lens = np.bincount(assign, minlength=kc).astype(np.int32)
        self._offsets = np.concatenate([[0], np.cumsum(self._lens)[:-1]]).astype(np.int32)
        self._centroids = cents[:kc]
        self._main_live = n
        self._built = True
        self._buffer = FlatIndex(self.dim, self.metric)
        if codes_dev is not None:
            self._install_device_slab(x_dev, codes_dev, order)
        else:
            self._dirty = True
            self._dev = None

    def get_centroids(self) -> Optional[np.ndarray]:
        return None if self._centroids is None else self._centroids.copy()

    # ---- query ----------------------------------------------------------

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        with self.lock:
            return self._sync_locked()

    def _host_tables(self) -> dict:
        from pyrope_tpu.index.ivf_flat import slab_pad

        kc = self._lens.shape[0]
        kpad = round_up(max(kc, 1), 8)
        l_pad = int(round_up(max(int(self._lens.max()) if kc else 1, 1), 128))
        n = self._codes.shape[0]
        npad = slab_pad(n, l_pad)
        alive = np.zeros(npad, bool)
        alive[:n] = self._alive
        cents = np.zeros((kpad, self.dim), np.float32)
        cvalid = np.zeros(kpad, bool)
        if self._centroids is not None:
            cents[:kc] = self._centroids
            cvalid[:kc] = True
        offs = np.zeros(kpad, np.int32)
        lens = np.zeros(kpad, np.int32)
        offs[:kc] = self._offsets
        lens[:kc] = self._lens
        # dense-scan tables: row -> cluster, row -> within-list position,
        # and the query-independent decomposition constant cdot[n] = c·r̂
        # (see adc_scan_dense)
        crow = np.full(npad, kpad - 1, np.int32)
        pos = np.zeros(npad, np.int32)
        cdot = np.zeros(npad, np.float32)
        if n:
            crow[:n] = np.repeat(np.arange(kc, dtype=np.int32), self._lens)
            pos[:n] = np.arange(n, dtype=np.int32) - self._offsets[crow[:n]]
            # cdot feeds ONLY the refine=0 dense-ADC score decomposition;
            # with rerank on (default) the dense path exact-scans the raw
            # slab instead, so skip the O(N·D) host decode+einsum
            if self.refine == 0 and self.pq.trained and self._centroids is not None:
                cdot[:n] = compute_cdot(
                    self._codes, crow[:n], self._centroids, self.pq.codebooks
                )
        return {
            "k": kc, "kpad": kpad, "l_pad": l_pad, "n": n, "npad": npad,
            "alive": alive, "cents": cents, "cvalid": cvalid,
            "offs": offs, "lens": lens, "crow": crow, "pos": pos, "cdot": cdot,
        }

    def _dev_common(self, t: dict) -> dict:
        return {
            "cents": jnp.asarray(t["cents"]),
            "cvalid": jnp.asarray(t["cvalid"]),
            "alive": jnp.asarray(t["alive"]),
            "offsets": jnp.asarray(t["offs"]),
            "lens": jnp.asarray(t["lens"]),
            "codebooks": jnp.asarray(self.pq.codebooks),
            "crow": jnp.asarray(t["crow"]),
            "pos": jnp.asarray(t["pos"]),
            "cdot": jnp.asarray(t["cdot"]),
            "l_pad": t["l_pad"],
            "k_actual": t["k"],
            # consistent row->id table for this slab (see IvfFlatIndex note)
            "perm_ids": self._perm_ids,
        }

    def _install_device_slab(
        self, x_dev: jax.Array, codes_dev: jax.Array, order: np.ndarray
    ) -> None:
        """Permute codes + rerank slab on device from the build's buffers —
        no re-upload (see ops/slab.py)."""
        from pyrope_tpu.ops.slab import (
            pad_order,
            take_rows,
            take_slab_cast,
            take_slab_sq8res,
        )

        t = self._host_tables()
        idx = pad_order(order, t["npad"], x_dev.shape[0])
        dev = self._dev_common(t)
        dev["codes"] = take_rows(codes_dev, idx).astype(jnp.uint8)
        if self.refine > 0:
            if self.refine_storage == "sq8res":
                (dev["codes8"], dev["mins"], dev["scales"],
                 dev["sq8norm"]) = take_slab_sq8res(
                    x_dev, idx, dev["cents"], dev["crow"])
            else:
                dt = "bfloat16" if self.refine_storage == "bf16" else "float32"
                dev["xraw"], dev["xsqnorm"] = take_slab_cast(x_dev, idx, dtype=dt)
        self._dev = dev
        self._dirty = False

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        t = self._host_tables()
        n, npad = t["n"], t["npad"]
        codes = np.zeros((npad, self.pq.m), np.uint8)
        codes[:n] = self._codes
        self._dev = {"codes": jnp.asarray(codes), **self._dev_common(t)}
        if self.refine > 0:
            if self.refine_storage == "sq8res":
                c8, mn, sc, sq8 = sq8res_encode_host(
                    self._xperm, t["cents"], t["crow"][:n])
                self._dev["codes8"] = upload_rows(c8, pad_to=npad)
                self._dev["mins"] = upload_rows(mn, pad_to=npad)
                self._dev["scales"] = upload_rows(sc, pad_to=npad)
                self._dev["sq8norm"] = upload_rows(sq8, pad_to=npad)
            else:
                # raw slab for the exact rerank stage (bf16 halves the bytes;
                # sqnorms are computed from the fp32 truth so L2 stays exact
                # up to the gathered operand's storage rounding)
                dt = jnp.bfloat16 if self.refine_storage == "bf16" else jnp.float32
                xp = self._xperm
                sq = np.zeros(npad, np.float32)
                sq[:n] = np.einsum("nd,nd->n", xp, xp)
                self._dev["xraw"] = upload_rows(xp, dtype=dt, pad_to=npad)
                self._dev["xsqnorm"] = jnp.asarray(sq)
        self._dirty = False
        return self._dev

    def _resolve_scan(self, dev: dict, batch: int, nprobe: int, ms: int) -> str:
        """Resolve (batch, nprobe, max_scans) to the kernel that will run:
        'probe-adc', 'probe-adc+rerank[-sq8]', 'dense-adc',
        'dense-exact-xla', or 'dense-sq8-xla' (refine_storage="sq8res"). The SINGLE source of routing truth,
        shared by _run_device (dispatch) and describe_scan (bench labeling).

        With ``refine > 0`` the two scan modes return DIFFERENT hit sets
        (dense exact-scans the rerank slab; probe reranks an ADC shortlist),
        so 'auto' resolves by index size only — never by batch — keeping
        results batch-invariant for a given index. With ``refine == 0`` both
        modes score identical ADC sums and auto may pick by traffic."""
        from pyrope_tpu.index.ivf_flat import (
            DENSE_MAX_ROWS,
            dense_max_elems,
            pick_scan_mode,
        )

        sq8 = self.refine_storage == "sq8res"
        npad = dev["codes"].shape[0]
        if self.scan_mode == "auto" and self.refine > 0:
            # Above DENSE_MAX_ROWS the XLA dense kernel's [B, npad]
            # transient is prohibitive. Batch-invariance holds: the choice
            # depends on the index size only.
            mode = "dense" if npad <= DENSE_MAX_ROWS else "probe"
            if batch * npad > dense_max_elems():
                mode = "probe"  # OOM guard outranks batch-invariance
        else:
            mode = pick_scan_mode(
                self.scan_mode, npad, nprobe, dev["l_pad"], batch=batch,
            )
        if mode != "dense":
            if self.refine > 0:
                return "probe-adc+rerank-sq8" if sq8 else "probe-adc+rerank"
            return "probe-adc"
        if self.refine == 0:
            return "dense-adc"
        return "dense-sq8-xla" if sq8 else "dense-exact-xla"

    def _run_device(self, dev: dict, q: jax.Array, top_k: int, nprobe: int, ms: int):
        """Dispatch the jitted query: pure ADC, or ADC-shortlist + exact
        rerank when ``refine`` is enabled (routing: see _resolve_scan)."""
        search_metric = Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric
        probe_metric = Metric.L2 if self.metric == Metric.COSINE else self.metric
        path = self._resolve_scan(dev, q.shape[0], nprobe, ms)
        if path == "dense-sq8-xla":
            fn = _ivfpq_dense_sq8_xla_fn(
                search_metric, top_k, nprobe, probe_metric=probe_metric,
            )
            return fn(
                dev["cents"], dev["cvalid"], dev["codes8"], dev["mins"],
                dev["scales"], dev["sq8norm"], dev["alive"], dev["offsets"],
                dev["lens"], dev["crow"], dev["pos"], q, device_i32(ms),
            )
        if path == "probe-adc+rerank-sq8":
            r = max(top_k, min(self.refine * top_k, self._codes.shape[0] or top_k))
            fn = _ivfpq_refine_sq8_search_fn(
                search_metric, top_k, nprobe, dev["l_pad"], r,
                probe_metric=probe_metric,
            )
            return fn(
                dev["cents"], dev["cvalid"], dev["codes"], dev["alive"],
                dev["offsets"], dev["lens"], dev["codebooks"],
                dev["codes8"], dev["mins"], dev["scales"], dev["sq8norm"],
                dev["crow"], q, device_i32(ms),
            )
        if path == "dense-exact-xla":
            fn = _ivfpq_dense_exact_fn(
                search_metric, top_k, nprobe, probe_metric=probe_metric,
            )
            return fn(
                dev["cents"], dev["cvalid"], dev["alive"],
                dev["offsets"], dev["lens"], dev["crow"], dev["pos"],
                dev["xraw"], dev["xsqnorm"], q, device_i32(ms),
            )
        if path == "dense-adc":
            fn = _ivfpq_dense_fn(
                search_metric, top_k, nprobe, probe_metric=probe_metric
            )
            return fn(
                dev["cents"], dev["cvalid"], dev["codes"], dev["alive"],
                dev["offsets"], dev["lens"], dev["codebooks"],
                dev["cdot"], dev["crow"], dev["pos"], q, device_i32(ms),
            )
        if path == "probe-adc+rerank":
            r = max(top_k, min(self.refine * top_k, self._codes.shape[0] or top_k))
            fn = _ivfpq_refine_search_fn(
                search_metric, top_k, nprobe, dev["l_pad"], r,
                probe_metric=probe_metric,
            )
            return fn(
                dev["cents"], dev["cvalid"], dev["codes"], dev["alive"],
                dev["offsets"], dev["lens"], dev["codebooks"],
                dev["xraw"], dev["xsqnorm"], q, device_i32(ms),
            )
        fn = _ivfpq_search_fn(search_metric, top_k, nprobe, dev["l_pad"],
                              probe_metric=probe_metric)
        return fn(
            dev["cents"], dev["cvalid"], dev["codes"], dev["alive"],
            dev["offsets"], dev["lens"], dev["codebooks"], q, device_i32(ms),
        )

    def device_search(
        self, q: jax.Array, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[jax.Array, jax.Array]:
        """Device-resident ADC(+rerank) query over the built slab (buffer
        must be empty). q must already be normalized for COSINE."""
        if self._buffer.get_stats().count:
            raise RuntimeError("device_search requires an empty buffer; call build()")
        if not self._built:
            raise RuntimeError("device_search requires a built index")
        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        ms = options.max_scans if options.max_scans is not None else self._codes.shape[0]
        return self._run_device(dev, q, top_k, nprobe, ms)

    def describe_scan(self, batch: int, nprobe: Optional[int] = None,
                      max_scans: Optional[int] = None) -> str:
        """Which kernel a (batch, nprobe, max_scans) query would run —
        recorded in bench rows so an 'IVF-PQ' QPS number always names its
        code path (VERDICT r2: the 100k dense rows measure an exact bf16
        scan of the rerank slab, not ADC): 'probe-adc', 'probe-adc+rerank',
        'dense-adc', 'dense-exact-xla', or 'dense-sq8-xla' (max_scans None =
        full scan)."""
        if not self._built:
            return "buffer"
        dev = self._sync()
        np_eff = min(nprobe or self.nprobe, dev["k_actual"])
        ms = max_scans if max_scans is not None else self._codes.shape[0]
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

        buf_hits = (
            self._buffer.search_batch(q, top_k, options)
            if self._buffer.get_stats().count
            else [[] for _ in range(b)]
        )
        if not self._built or self._main_live == 0:
            return buf_hits

        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        ms = options.max_scans if options.max_scans is not None else self._codes.shape[0]
        qq = self._normalize(q) if self.metric == Metric.COSINE else q
        bb = batch_bucket(b)
        qp = np.pad(qq, ((0, bb - b), (0, 0))) if bb != b else qq
        vals, rows = self._run_device(dev, jnp.asarray(qp), top_k, nprobe, ms)
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

    def memory_bytes(self) -> dict:
        """Device-resident bytes for memory-parity accounting. The pure-ADC
        state (refine=0) matches the reference's PQ memory footprint; the
        rerank slab is reported separately so the trade is explicit."""
        kc = self._lens.shape[0]
        out = {
            "codes": int(self._codes.shape[0] * self.pq.m),
            "centroids": int(kc * self.dim * 4),
            "codebooks": int(self.pq.m * self.pq.ksub * self.pq.sub * 4),
        }
        if self.refine > 0:
            n = self._codes.shape[0]
            if self.refine_storage == "sq8res":
                # uint8 codes + per-row (min, scale, sqnorm) fp32
                out["refine_slab"] = int(n * self.dim + n * 12)
            else:
                elt = 2 if self.refine_storage == "bf16" else 4
                out["refine_slab"] = int(n * self.dim * elt + n * 4)
        return out

    def snapshot(self, path: str) -> None:
        """Runs under the index lock: live_vectors may return a VIEW of the
        buffer slab and a concurrent upsert writes rows in place."""
        with self.lock:
            self._snapshot_locked(path)

    def _snapshot_locked(self, path: str) -> None:
        bids, bvecs = self._buffer.live_vectors()
        meta = json.dumps({
            "format": "pyrope_tpu.ivf_pq.v1",
            "dim": self.dim,
            "metric": self.metric.value,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "pq_m": self.pq.m,
            "ksub": self.pq.ksub,
            "built": self._built,
            "seed": self.seed,
            "refine": self.refine,
            "refine_storage": self.refine_storage,
            "scan_mode": self.scan_mode,
        })
        np.savez_compressed(
            path,
            meta=np.str_(meta),
            centroids=self._centroids if self._centroids is not None else np.zeros((0, self.dim), np.float32),
            codebooks=self.pq.codebooks if self.pq.codebooks is not None else np.zeros(0, np.float32),
            xperm=self._xperm,
            codes=self._codes,
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
            if meta.get("format") != "pyrope_tpu.ivf_pq.v1":
                raise ValueError(f"bad snapshot format: {meta.get('format')}")
            if int(meta["dim"]) != self.dim:
                raise ValueError("snapshot dim mismatch")
            self.metric = Metric.parse(meta["metric"])
            self.nlist = int(meta["nlist"])
            self.nprobe = int(meta["nprobe"])
            self.seed = int(meta.get("seed", COARSE_SEED))
            self.refine = int(meta.get("refine", self.refine))
            self.refine_storage = str(meta.get("refine_storage", self.refine_storage))
            self.scan_mode = str(meta.get("scan_mode", self.scan_mode))
            self._built = bool(meta["built"])
            self.pq = ProductQuantizer(m=int(meta["pq_m"]), ksub=int(meta["ksub"]), dim=self.dim)
            cb = np.asarray(z["codebooks"], np.float32)
            self.pq.codebooks = cb if cb.size else None
            cents = np.asarray(z["centroids"], np.float32)
            self._centroids = cents if cents.size else None
            self._xperm = np.asarray(z["xperm"], np.float32)
            self._codes = np.asarray(z["codes"], np.uint8)
            self._perm_ids = [str(s) for s in z["perm_ids"]]
            self._alive = np.asarray(z["alive"], bool)
            self._offsets = np.asarray(z["offsets"], np.int32)
            self._lens = np.asarray(z["lens"], np.int32)
            self._main_pos = {pid: r for r, pid in enumerate(self._perm_ids)}
            self._main_live = int(self._alive.sum())
            self._buffer = FlatIndex(self.dim, self.metric)
            bids = [str(s) for s in z["buf_ids"]]
            if bids:
                self._buffer.add_batch(bids, np.asarray(z["buf_vecs"], np.float32))
        self._dirty = True
        self._dev = None
