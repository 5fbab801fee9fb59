"""Semantic cluster registry — the L2 cache key + Semantic-TTL.

Rebuild of the reference's ``SemanticClusterRegistry``
(ref: Services/SemanticClusterRegistry.cs): per-index centroid list
(:11-37), nearest-cluster assignment (:39-70), write-heat tracking over
60-second windows (:72-93), and ``get_recommended_ttl`` which cuts the TTL
to 10% (min 1 s) when a cluster sees >10 writes/min — "Semantic TTL"
(:95-121).

Device-first difference: nearest-cluster assignment is a batched ``[B, K]``
score (same conventions as ops.distance.score_matrix: higher = better,
L2 → −d²), not a scalar per-centroid loop — and centroids sync straight
from a built IVF index's ``CentroidsProvider``. The scoring itself runs
on HOST numpy, deliberately: a [1, K≤1024] probe is dispatch-bound on
the device (one H2D + one D2H per call, and this probe sits on the
per-write and per-search-miss paths OUTSIDE the micro-batcher), while
numpy does it in microseconds.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from pyrope_tpu.types import Metric
from pyrope_tpu.utils.clock import SYSTEM_CLOCK, Clock

_WINDOW_S = 60.0
_HOT_WRITES_PER_MIN = 10
_TTL_CUT = 0.1
_TTL_MIN_S = 1.0


def _host_score_matrix(q: np.ndarray, x: np.ndarray, metric: Metric) -> np.ndarray:
    """[B, K] scores on host numpy, matching ops.distance.score_matrix's
    conventions exactly (higher = better; L2 → −max(d², 0); cosine
    denominator floored at 1e-12)."""
    dots = q @ x.T
    if metric == Metric.INNER_PRODUCT:
        return dots
    if metric == Metric.L2:
        qq = np.einsum("bd,bd->b", q, q)
        xx = np.einsum("kd,kd->k", x, x)
        d2 = qq[:, None] - 2.0 * dots + xx[None, :]
        return -np.maximum(d2, 0.0)
    if metric == Metric.COSINE:
        qn = np.sqrt(np.einsum("bd,bd->b", q, q))
        xn = np.sqrt(np.einsum("kd,kd->k", x, x))
        return dots / np.maximum(qn[:, None] * xn[None, :], 1e-12)
    raise ValueError(f"unknown metric {metric}")


class _IndexClusters:
    __slots__ = ("centroids", "metric", "write_counts", "window_start")

    def __init__(self, centroids: np.ndarray, metric: Metric):
        self.centroids = centroids
        self.metric = metric
        self.write_counts: dict[int, int] = {}
        self.window_start = 0.0


class SemanticClusterRegistry:
    def __init__(self, clock: Clock = SYSTEM_CLOCK):
        self._clock = clock
        self._lock = threading.Lock()
        self._by_index: dict[tuple[str, str], _IndexClusters] = {}

    def update_centroids(
        self, tenant: str, index: str, centroids: np.ndarray, metric: Metric = Metric.L2
    ) -> None:
        c = np.ascontiguousarray(np.asarray(centroids, dtype=np.float32))
        with self._lock:
            self._by_index[(tenant, index)] = _IndexClusters(c, Metric.parse(metric))

    def has_clusters(self, tenant: str, index: str) -> bool:
        with self._lock:
            return (tenant, index) in self._by_index

    def get_centroids(self, tenant: str, index: str) -> Optional[np.ndarray]:
        with self._lock:
            st = self._by_index.get((tenant, index))
            return None if st is None else st.centroids

    def find_nearest_cluster(
        self, tenant: str, index: str, query: np.ndarray
    ) -> Optional[tuple[int, float]]:
        """(cluster_id, score) of the best cluster, or None if no centroids.
        Score uses the engine convention (higher = closer; L2 → −d²)."""
        out = self.find_nearest_batch(tenant, index, np.asarray(query)[None, :])
        return None if out is None else (int(out[0][0]), float(out[1][0]))

    def find_nearest_batch(
        self, tenant: str, index: str, queries: np.ndarray
    ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Batched assignment: ([B] cluster ids, [B] scores)."""
        with self._lock:
            st = self._by_index.get((tenant, index))
        if st is None or st.centroids.size == 0:
            return None
        q = np.asarray(queries, dtype=np.float32)
        scores = _host_score_matrix(q, st.centroids, st.metric)  # [B, K]
        ids = scores.argmax(axis=1)
        return ids.astype(np.int64), scores[np.arange(len(ids)), ids]

    # ---- write heat / Semantic TTL (ref :72-121) -------------------------

    def record_write(self, tenant: str, index: str, cluster_id: int) -> None:
        now = self._clock.now()
        with self._lock:
            st = self._by_index.get((tenant, index))
            if st is None:
                return
            if now - st.window_start >= _WINDOW_S:
                st.write_counts = {}
                st.window_start = now
            st.write_counts[cluster_id] = st.write_counts.get(cluster_id, 0) + 1

    def writes_in_window(self, tenant: str, index: str, cluster_id: int) -> int:
        now = self._clock.now()
        with self._lock:
            st = self._by_index.get((tenant, index))
            if st is None or now - st.window_start >= _WINDOW_S:
                return 0
            return st.write_counts.get(cluster_id, 0)

    def get_recommended_ttl(
        self, tenant: str, index: str, cluster_id: int, base_ttl_s: float
    ) -> float:
        """Semantic TTL: hot clusters (>10 writes/min) get 10% TTL, min 1 s."""
        if self.writes_in_window(tenant, index, cluster_id) > _HOT_WRITES_PER_MIN:
            return max(_TTL_MIN_S, base_ttl_s * _TTL_CUT)
        return base_ttl_s
