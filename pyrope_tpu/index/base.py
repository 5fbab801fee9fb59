"""Abstract index contract.

Python analog of the reference's ``IVectorIndex``
(ref: src/Pyrope.GarnetServer/Vector/IVectorIndex.cs:14-31:
 Add/Upsert/Delete/Search/Build/Snapshot/Load/GetStats) plus the batched
query surface that is the device engine's first-class entry point, and
``Scan`` used for Delta compaction (ref: BruteForceVectorIndex.cs:250-273).
"""

from __future__ import annotations

import abc
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from pyrope_tpu.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)


class VectorIndex(abc.ABC):
    """Contract shared by every index family."""

    dim: int
    metric: Metric

    # True when add/upsert/delete are cheap HOST work (buffer append, slab
    # write, tombstone — microseconds, no device dispatch, no graph walk).
    # The async data plane serves such writes inline on its event loop
    # instead of paying a thread-pool hop per op (server/resp.py). HNSW
    # keeps the default False: its per-row insert is a full graph descent.
    host_write_cheap = False

    _lock_init = threading.Lock()

    @property
    def lock(self) -> threading.RLock:
        """Per-index reentrant lock guarding host state (mutation + device
        sync). Analog of the reference's per-index ``ReaderWriterLockSlim``
        (ref: BruteForceVectorIndex.cs:23) — the server runs writes and
        searches on concurrent threads (asyncio.to_thread, MicroBatcher).
        Device execution itself happens on immutable jax arrays and never
        holds this lock. Created lazily so subclasses need no super().__init__."""
        lk = self.__dict__.get("_lock")
        if lk is None:
            with VectorIndex._lock_init:
                lk = self.__dict__.setdefault("_lock", threading.RLock())
        return lk

    # ---- mutation -------------------------------------------------------

    @abc.abstractmethod
    def add(self, id: str, vector: np.ndarray) -> bool:
        """Insert a new vector. Returns False if the id already exists."""

    @abc.abstractmethod
    def upsert(self, id: str, vector: np.ndarray) -> None:
        """Insert or overwrite."""

    @abc.abstractmethod
    def delete(self, id: str) -> bool:
        """Logical delete (tombstone). Returns False if absent."""

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> int:
        """Bulk insert; returns number actually added."""
        n = 0
        for i, v in zip(ids, np.asarray(vectors)):
            n += bool(self.add(i, v))
        return n

    # ---- query ----------------------------------------------------------

    @abc.abstractmethod
    def search_batch(
        self,
        queries: np.ndarray,
        top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> list[list[SearchResult]]:
        """Batched k-NN query: queries [B, D] -> per-query hits sorted by
        score descending. The batched form is the device hot path."""

    def search(
        self,
        query: np.ndarray,
        top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> list[SearchResult]:
        q = np.asarray(query, dtype=np.float32).reshape(1, -1)
        return self.search_batch(q, top_k, options)[0]

    # ---- lifecycle ------------------------------------------------------

    def build(self) -> None:
        """(Re)build internal structures; no-op for exact scans."""

    @abc.abstractmethod
    def snapshot(self, path: str) -> None:
        """Persist index state to `path` (single file)."""

    @abc.abstractmethod
    def load(self, path: str) -> None:
        """Restore index state from `path`."""

    @abc.abstractmethod
    def get_stats(self) -> IndexStats:
        ...

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        """Yield (id, vector) for every live entry (compaction export)."""
        raise NotImplementedError

    def __len__(self) -> int:
        return self.get_stats().count


class CentroidsProvider(abc.ABC):
    """Post-build centroid export (ref: Vector/ICentroidsProvider.cs:9-16)."""

    @abc.abstractmethod
    def get_centroids(self) -> Optional[np.ndarray]:
        """[K, D] float32 centroids, or None before build."""
