"""Frozen device-resident Flat index: zero-host-copy bulk ingestion.

Why this exists. ``FlatIndex`` keeps the host numpy slab as the record of
truth and uploads it to device memory lazily — the right design for a
mutable serving index, but it caps corpus scale at what the HOST can hold
and move: at 10M x 128 the fp32 corpus is 5.1 GB of host RAM to fill and
then copy, while the device can generate or receive it directly. The
reference hits the same wall earlier — its 1M-vector benchmark run stalled
at 93% load and never published a number (ref:
docs/benchmarks/20260118_benchmark_500k_ivf.md:43-55).

``DeviceFlatIndex`` accepts a corpus that ALREADY lives in device memory (a
jax array produced by a collocated loader, another model's embedding head,
or an on-device generator) and serves the exact same query surface as
``FlatIndex`` — the XLA score+top-k path, same score conventions
(ref: BruteForceVectorIndex.cs
:350-356), same ``max_scans`` budget (:288) — without ever materializing a
host copy of the vectors.

Frozen: ``add``/``upsert``/``delete`` raise (the mutable families are
``FlatIndex`` and composites over it; a mutable head over a frozen device
tail composes via ``DeltaIndex``). ``snapshot`` is real — it fetches the
slab once and writes the ``pyrope_tpu.flat.v1`` format, so a frozen corpus
can be re-loaded into a mutable ``FlatIndex``.

Row ids default to the implicit ``str(row)`` scheme so a 10M-row corpus
does not pay ~0.6 GB of host RAM for an id list nobody asked for; pass
``ids=`` to attach explicit external ids.
"""

from __future__ import annotations

import functools
import json
from typing import Iterator, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from pyrope_tpu.index.base import VectorIndex
from pyrope_tpu.index.flat import _dense_search_fn
from pyrope_tpu.ops.distance import normalize_rows
from pyrope_tpu.ops.scalars import device_i32
from pyrope_tpu.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu.utils.shapes import batch_bucket

_FROZEN_MSG = (
    "DeviceFlatIndex is frozen (device-resident slab, no host record of "
    "truth). Use FlatIndex for mutable corpora, or compose a mutable head "
    "over this index with DeltaIndex."
)


@functools.partial(jax.jit, static_argnames=("n_valid",))
def _prep_slab(x: jax.Array, n_valid: int):
    """fp32 sqnorms and the alive mask — one compiled program so
    construction costs one dispatch, not two."""
    xf = x.astype(jnp.float32)
    sqnorm = jnp.sum(xf * xf, axis=-1)
    alive = jnp.arange(x.shape[0], dtype=jnp.int32) < n_valid
    return sqnorm, alive


class DeviceFlatIndex(VectorIndex):
    """Read-only exact scan over a device-resident slab."""

    host_write_cheap = False

    def __init__(
        self,
        x: jax.Array | np.ndarray,
        metric: Metric | str = Metric.L2,
        *,
        n_valid: Optional[int] = None,
        selection: str = "exact",  # exact | approx[:recall]
        ids: Optional[Sequence[str]] = None,
    ):
        """``x``: [N, D] fp32/bf16 corpus. jax arrays are adopted in place
        (pad + sqnorm are device ops); numpy input is uploaded through the
        chunked ``upload_rows`` path. ``n_valid``: live-row count when the
        tail of ``x`` is padding (default: all N rows are live).
        COSINE rows are L2-normalized at ingest (ref: HnswVectorIndex.cs
        :69-85 normalize-at-insert) and scored as IP."""
        from pyrope_tpu.ops.topk import parse_selection

        if parse_selection(selection)[0] == "hybrid":
            raise ValueError("DeviceFlatIndex has no bf16 twin slab for "
                             "selection='hybrid'; use exact|approx")
        if x.ndim != 2:
            raise ValueError(f"expected [N, D] corpus, got shape {x.shape}")
        n, dim = int(x.shape[0]), int(x.shape[1])
        n_valid = n if n_valid is None else int(n_valid)
        if not 0 < n_valid <= n:
            raise ValueError(f"n_valid must be in (0, {n}], got {n_valid}")
        self.dim = dim
        self.metric = Metric.parse(metric)
        self.selection = selection
        if isinstance(x, np.ndarray):
            from pyrope_tpu.ops.transfer import upload_rows

            x = upload_rows(np.ascontiguousarray(x, np.float32))
        if x.dtype not in (jnp.float32, jnp.bfloat16):
            raise ValueError(f"slab dtype must be fp32|bf16, got {x.dtype}")
        if self.metric == Metric.COSINE:
            x = normalize_rows(x)
        sqnorm, alive = _prep_slab(x, n_valid)
        self._dev = {"vecs": x, "sqnorm": sqnorm, "alive": alive}
        self._count = n_valid
        if ids is not None:
            ids = list(ids)
            if len(ids) != n_valid:
                raise ValueError(f"ids must have n_valid={n_valid} entries")
            self._row_ids: Optional[list[str]] = ids
            self._id_to_row = {i: r for r, i in enumerate(ids)}
            if len(self._id_to_row) != n_valid:
                raise ValueError("duplicate ids")
        else:
            self._row_ids = None  # implicit str(row) ids
            self._id_to_row = None

    # ---- mutation: frozen -------------------------------------------------

    def add(self, id: str, vector: np.ndarray) -> bool:
        raise RuntimeError(_FROZEN_MSG)

    def upsert(self, id: str, vector: np.ndarray) -> None:
        raise RuntimeError(_FROZEN_MSG)

    def delete(self, id: str) -> bool:
        raise RuntimeError(_FROZEN_MSG)

    # ---- query -------------------------------------------------------------

    def _search_device(
        self, q: jax.Array, top_k: int, max_scans: Optional[int]
    ) -> tuple[jax.Array, jax.Array]:
        dev = self._dev
        ms_int = self._count if max_scans is None else min(max_scans, self._count)
        search_metric = (
            Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric
        )
        fn = _dense_search_fn(search_metric, top_k, None, self.selection)
        return fn(dev["vecs"], dev["sqnorm"], dev["alive"], q, device_i32(ms_int))

    def device_search(
        self, q: jax.Array, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[jax.Array, jax.Array]:
        """q [B, D] on device (pre-normalized is NOT required for COSINE:
        rows were normalized at ingest, so IP over a normalized q is cosine —
        normalize q on host like search_batch does, or pass unit vectors)."""
        return self._search_device(q, top_k, options.max_scans)

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        if self._row_ids is None:
            return [
                [str(int(r)) if r >= 0 else "" for r in row] for row in rows
            ]
        return [
            [self._row_ids[int(r)] if r >= 0 else "" for r in row]
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
        if self.metric == Metric.COSINE:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        b = q.shape[0]
        bb = batch_bucket(b)
        if bb != b:
            q = np.pad(q, ((0, bb - b), (0, 0)))
        vals, rows = self._search_device(jnp.asarray(q), top_k, options.max_scans)
        vals = np.asarray(vals)[:b]
        rows = np.asarray(rows)[:b]
        ids = self.resolve_rows(rows)
        out: list[list[SearchResult]] = []
        for vrow, irow in zip(vals, ids):
            out.append([
                SearchResult(i, float(v))
                for v, i in zip(vrow, irow)
                if i and np.isfinite(v)
            ])
        return out

    # ---- lifecycle ----------------------------------------------------------

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        """One bulk D2H fetch, then host iteration (compaction export)."""
        vecs = np.asarray(self._dev["vecs"][: self._count], np.float32)
        for row in range(self._count):
            rid = str(row) if self._row_ids is None else self._row_ids[row]
            yield rid, vecs[row]

    def get_stats(self) -> IndexStats:
        return IndexStats(count=self._count, dim=self.dim, metric=self.metric)

    def memory_bytes(self) -> int:
        d = self._dev
        return int(
            d["vecs"].size * d["vecs"].dtype.itemsize
            + d["sqnorm"].size * 4 + d["alive"].size
        )

    def describe_scan(self, batch: int | None = None,
                      nprobe: int | None = None) -> str:
        return f"device-{self.selection.partition(':')[0]}"

    def snapshot(self, path: str) -> None:
        """Fetch the slab once and write the FlatIndex-compatible
        ``pyrope_tpu.flat.v1`` format (a frozen corpus stays recoverable
        into the mutable family). At 10M rows this is a multi-GB
        device-to-host copy."""
        vecs = np.asarray(self._dev["vecs"][: self._count], np.float32)
        ids = np.array(
            [str(r) for r in range(self._count)]
            if self._row_ids is None else self._row_ids,
            dtype=np.str_,
        )
        meta = json.dumps({
            "format": "pyrope_tpu.flat.v1",
            "dim": self.dim,
            "metric": self.metric.value,
            "storage": "bf16" if self._dev["vecs"].dtype == jnp.bfloat16 else "fp32",
            # lets load() skip rebuilding the explicit id list + _id_to_row
            # dict (~0.6 GB at 10M rows) when ids were implicit (ADVICE r3);
            # FlatIndex ignores the flag and uses the ids array as before
            "implicit_ids": self._row_ids is None,
        })
        np.savez_compressed(path, meta=np.str_(meta), ids=ids, vecs=vecs)

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("format") != "pyrope_tpu.flat.v1":
                raise ValueError(f"bad snapshot format: {meta.get('format')}")
            if int(meta["dim"]) != self.dim:
                raise ValueError("snapshot dim mismatch")
            vecs = np.asarray(z["vecs"], np.float32)
            ids = (
                None if meta.get("implicit_ids")
                else [str(s) for s in z["ids"]]
            )
        self.metric = Metric.parse(meta["metric"])
        dt = jnp.bfloat16 if meta.get("storage") == "bf16" else jnp.float32
        self.__init__(
            jnp.asarray(vecs, dt), self.metric, selection=self.selection,
            ids=ids,
        )
