"""Benchmark datasets & ground truth.

Mirrors the reference bench harness's dataset support
(ref: src/Pyrope.Benchmarks/Program.cs:192-263 — synthetic with seeds
42/1337, SIFT fvecs, GloVe txt; Datasets/FvecsReader.cs:14-58,
Datasets/GloveTxtReader.cs:14-62) and adds brute-force ground truth +
recall@k, which the reference never measures (SURVEY §4).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

BASE_SEED = 42     # ref: Program.cs synthetic base vectors seed
QUERY_SEED = 1337  # ref: Program.cs synthetic query seed


def synthetic(n: int, dim: int, seed: int = BASE_SEED) -> np.ndarray:
    """Seeded uniform [0, 1) float32 vectors (ref uses Random.NextSingle)."""
    rng = np.random.default_rng(seed)
    return rng.random((n, dim), dtype=np.float32)


def synthetic_queries(n: int, dim: int, seed: int = QUERY_SEED) -> np.ndarray:
    return synthetic(n, dim, seed)


def synthetic_clustered(
    n: int, dim: int, n_clusters: int = 100, seed: int = BASE_SEED,
    spread: float = 0.05,
) -> np.ndarray:
    """Mixture-of-Gaussians corpus — the realistic ANN regime (embedding
    spaces cluster; the reference's uniform synthetic has no structure for
    IVF/HNSW to exploit, which floors recall for ANY implementation)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    noise = rng.normal(0.0, spread, (n, dim)).astype(np.float32)
    return centers[assign] + noise


def synthetic_clustered_queries(
    n: int, dim: int, n_clusters: int = 100, seed: int = QUERY_SEED,
    base_seed: int = BASE_SEED, spread: float = 0.05,
) -> np.ndarray:
    """Queries drawn near the same cluster centers as the corpus."""
    rng = np.random.default_rng(seed)
    centers_rng = np.random.default_rng(base_seed)
    centers = centers_rng.random((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    noise = rng.normal(0.0, spread, (n, dim)).astype(np.float32)
    return centers[assign] + noise


def zipf_cluster_sizes(n: int, n_clusters: int, alpha: float = 1.0,
                       seed: int = BASE_SEED) -> np.ndarray:
    """Heavy-tailed cluster sizes: size_i ∝ 1/rank_i^alpha, summing to n
    (every cluster gets >= 1 row). Real ANN corpora (SIFT/GloVe) have
    skewed cluster populations the balanced mixture above never shows —
    this is the in-image stand-in for that skew (VERDICT r3 #7; the real
    fvecs loaders exist but the image has no egress)."""
    ranks = np.arange(1, n_clusters + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    sizes = np.maximum((w / w.sum() * (n - n_clusters)).astype(np.int64), 0) + 1
    # distribute rounding remainder onto the largest clusters
    rem = n - int(sizes.sum())
    sizes[: abs(rem)] += np.sign(rem)
    assert sizes.sum() == n and (sizes > 0).all()
    # shuffle which CENTER gets which size so cluster id != popularity rank
    rng = np.random.default_rng(seed + 7)
    rng.shuffle(sizes)
    return sizes


def synthetic_zipf(
    n: int, dim: int, n_clusters: int = 100, alpha: float = 1.0,
    seed: int = BASE_SEED, spread: float = 0.05,
) -> np.ndarray:
    """Mixture-of-Gaussians corpus with Zipf(alpha) cluster sizes: the
    largest cluster holds ~n/H(K) rows (14% of 1M at K=1000, vs 0.1%
    balanced), stressing padded-CSR l_pad blowup in ways
    synthetic_clustered cannot."""
    rng = np.random.default_rng(seed)
    centers = rng.random((n_clusters, dim)).astype(np.float32)
    sizes = zipf_cluster_sizes(n, n_clusters, alpha, seed)
    assign = np.repeat(np.arange(n_clusters), sizes)
    rng.shuffle(assign)  # insertion order must not leak cluster structure
    noise = rng.normal(0.0, spread, (n, dim)).astype(np.float32)
    return centers[assign] + noise


def synthetic_zipf_queries(
    n: int, dim: int, n_clusters: int = 100, alpha: float = 1.0,
    seed: int = QUERY_SEED, base_seed: int = BASE_SEED, spread: float = 0.05,
) -> np.ndarray:
    """Queries drawn near the same centers with the SAME Zipf popularity:
    hot clusters get queried proportionally more (matching real serving,
    where popular content is both dense and hot)."""
    rng = np.random.default_rng(seed)
    centers_rng = np.random.default_rng(base_seed)
    centers = centers_rng.random((n_clusters, dim)).astype(np.float32)
    sizes = zipf_cluster_sizes(n_clusters * 64, n_clusters, alpha, base_seed)
    assign = rng.choice(n_clusters, size=n, p=sizes / sizes.sum())
    noise = rng.normal(0.0, spread, (n, dim)).astype(np.float32)
    return centers[assign] + noise


def read_fvecs(path: str | Path, limit: int | None = None) -> np.ndarray:
    """SIFT-style .fvecs: per record int32 dim + dim float32 LE
    (ref: Datasets/FvecsReader.cs:14-58)."""
    data = Path(path).read_bytes()
    if len(data) < 4:
        return np.zeros((0, 0), np.float32)
    dim = struct.unpack_from("<i", data, 0)[0]
    rec = 4 + 4 * dim
    n = len(data) // rec
    if limit is not None:
        n = min(n, limit)
    arr = np.frombuffer(data[: n * rec], dtype=np.float32).reshape(n, dim + 1)
    # first float of each record is the bit-cast dim header
    return np.ascontiguousarray(arr[:, 1:])


def write_fvecs(path: str | Path, vecs: np.ndarray) -> None:
    vecs = np.asarray(vecs, np.float32)
    n, dim = vecs.shape
    out = np.empty((n, dim + 1), np.float32)
    out[:, 0] = np.frombuffer(np.full(n, dim, np.int32).tobytes(), np.float32)
    out[:, 1:] = vecs
    Path(path).write_bytes(out.tobytes())


def read_glove_txt(path: str | Path, limit: int | None = None) -> tuple[list[str], np.ndarray]:
    """GloVe txt `token v1..vN`, tolerant of malformed lines
    (ref: Datasets/GloveTxtReader.cs:14-62)."""
    tokens: list[str] = []
    rows: list[np.ndarray] = []
    dim = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            try:
                vec = np.array(parts[1:], dtype=np.float32)
            except ValueError:
                continue
            if dim is None:
                dim = vec.shape[0]
            if vec.shape[0] != dim:
                continue
            tokens.append(parts[0])
            rows.append(vec)
            if limit is not None and len(rows) >= limit:
                break
    if not rows:
        return [], np.zeros((0, 0), np.float32)
    return tokens, np.stack(rows)


def ground_truth(
    base: np.ndarray, queries: np.ndarray, k: int, metric: str = "L2",
    block: int = 4096,
) -> np.ndarray:
    """Exact top-k row indices per query (numpy, blocked over base rows)."""
    from pyrope_tpu.types import Metric

    m = Metric.parse(metric)
    q = np.asarray(queries, np.float64)
    if m == Metric.COSINE:
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    qq = (q * q).sum(1)[:, None]
    nq = q.shape[0]
    # running top-k per block: peak memory O(Q*block), not O(Q*N) float64
    best_s = np.full((nq, k), -np.inf)
    best_i = np.full((nq, k), -1, np.int64)
    n = np.asarray(base).shape[0]
    for s in range(0, n, block):
        blk = np.asarray(base[s : s + block], np.float64)
        if m == Metric.COSINE:
            blk = blk / np.maximum(np.linalg.norm(blk, axis=1, keepdims=True), 1e-12)
        dots = q @ blk.T
        if m == Metric.L2:
            sc = -(qq - 2 * dots + (blk * blk).sum(1)[None, :])
        else:
            sc = dots
        cand_s = np.concatenate([best_s, sc], axis=1)
        cand_i = np.concatenate(
            [best_i, np.broadcast_to(np.arange(s, s + blk.shape[0]), sc.shape)], axis=1
        )
        sel = np.argpartition(-cand_s, kth=min(k, cand_s.shape[1] - 1), axis=1)[:, :k]
        best_s = np.take_along_axis(cand_s, sel, axis=1)
        best_i = np.take_along_axis(cand_i, sel, axis=1)
    order = best_s.argsort(axis=1)[:, ::-1]
    return np.take_along_axis(best_i, order, axis=1)


def id_lists_to_rows(id_lists: "list[list[str]]", k: int | None = None) -> np.ndarray:
    """resolve_rows output (numeric-string ids, '' = miss) -> int row matrix
    padded with -1, ready for recall_at_k. Shared by bench.py and the
    sweep script."""
    width = k or max((len(r) for r in id_lists), default=0)
    out = np.full((len(id_lists), width), -1, np.int64)
    for bi, row in enumerate(id_lists):
        for j, i in enumerate(row[:width]):
            if i:
                out[bi, j] = int(i)
    return out


def recall_at_k(result_ids: np.ndarray, truth_ids: np.ndarray, k: int) -> float:
    """Mean |result ∩ truth| / k over queries. Inputs: [B, >=k] int arrays
    (use -1 padding for missing hits)."""
    hits = 0
    for res, tru in zip(result_ids, truth_ids):
        hits += len(set(int(r) for r in res[:k] if r >= 0) & set(int(t) for t in tru[:k]))
    return hits / (len(result_ids) * k)
