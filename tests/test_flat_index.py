"""FlatIndex behavior tests.

Mirrors the reference suite Vector/BruteForceVectorIndexTests.cs +
Vector/VectorMathTests.cs (SIMD-vs-scalar agreement becomes device-vs-numpy
agreement) and Vector/ScalarQuantizerTests.cs.
"""

import numpy as np
import pytest

from pyrope_tpu import FlatIndex, Metric, SearchOptions
from pyrope_tpu.utils.datasets import ground_truth, recall_at_k, synthetic


def make_index(metric=Metric.L2, n=50, dim=8, seed=0, **kw):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    idx = FlatIndex(dim, metric, **kw)
    idx.add_batch([f"v{i}" for i in range(n)], vecs)
    return idx, vecs


def test_exact_match_is_top_hit_l2():
    idx, vecs = make_index()
    hits = idx.search(vecs[7], 5)
    assert hits[0].id == "v7"
    assert hits[0].score == pytest.approx(0.0, abs=1e-3)


def test_scores_match_numpy_l2():
    idx, vecs = make_index(n=40, dim=16)
    q = np.random.default_rng(1).normal(size=16).astype(np.float32)
    hits = idx.search(q, 10)
    d2 = ((vecs - q) ** 2).sum(axis=1)
    order = np.argsort(d2)[:10]
    assert [h.id for h in hits] == [f"v{i}" for i in order]
    for h, i in zip(hits, order):
        # expansion-form L2 in fp32 carries ~1e-3 relative cancellation error
        assert h.score == pytest.approx(-float(d2[i]), rel=2e-3, abs=2e-3)


def test_inner_product_ordering():
    idx, vecs = make_index(metric=Metric.INNER_PRODUCT)
    q = vecs[3]
    hits = idx.search(q, 50)
    dots = vecs @ q
    order = np.argsort(-dots)
    assert [h.id for h in hits] == [f"v{i}" for i in order]


def test_cosine_scores():
    idx, vecs = make_index(metric=Metric.COSINE, n=30, dim=12)
    q = np.random.default_rng(2).normal(size=12).astype(np.float32)
    hits = idx.search(q, 5)
    cos = (vecs @ q) / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(q))
    order = np.argsort(-cos)[:5]
    assert hits[0].id == f"v{order[0]}"
    fifth_best = cos[order[-1]]
    for h in hits:
        # each hit's score must match its own true cosine and be >= the true
        # 5th-best (ties at fp32 may swap near-equal candidates)
        assert h.score == pytest.approx(float(cos[int(h.id[1:])]), abs=1e-4)
        assert h.score >= fifth_best - 1e-4


def test_add_duplicate_returns_false():
    idx, vecs = make_index()
    assert idx.add("v0", vecs[0]) is False
    assert idx.get_stats().count == 50


def test_upsert_overwrites():
    idx, vecs = make_index()
    target = np.full(8, 9.0, np.float32)
    idx.upsert("v5", target)
    hits = idx.search(target, 1)
    assert hits[0].id == "v5"


def test_delete_hides_vector_and_readd_revives():
    idx, vecs = make_index()
    assert idx.delete("v7")
    assert not idx.delete("v7")  # already gone
    hits = idx.search(vecs[7], 5)
    assert all(h.id != "v7" for h in hits)
    assert idx.get_stats().count == 49
    assert idx.add("v7", vecs[7])
    hits = idx.search(vecs[7], 1)
    assert hits[0].id == "v7"


def test_max_scans_limits_rows_in_insertion_order():
    idx, vecs = make_index(n=50)
    # query equals row 40; with max_scans=10 only rows 0-9 are scanned
    hits = idx.search(vecs[40], 3, SearchOptions(max_scans=10))
    assert all(int(h.id[1:]) < 10 for h in hits)


def test_search_batch_matches_single():
    idx, vecs = make_index(n=64, dim=8)
    q = vecs[:5] + 0.01
    batch = idx.search_batch(q, 4)
    for i in range(5):
        single = idx.search(q[i], 4)
        assert [h.id for h in batch[i]] == [h.id for h in single]


def test_topk_larger_than_count():
    idx = FlatIndex(4)
    idx.add("a", np.ones(4, np.float32))
    idx.add("b", np.zeros(4, np.float32))
    hits = idx.search(np.ones(4, np.float32), 10)
    assert len(hits) == 2
    assert hits[0].id == "a"


def test_dim_mismatch_raises():
    idx = FlatIndex(8)
    with pytest.raises(ValueError):
        idx.add("a", np.ones(4, np.float32))
    with pytest.raises(ValueError):
        idx.search(np.ones(3, np.float32), 1)


def test_capacity_growth_preserves_data():
    idx = FlatIndex(4, min_capacity=8)
    n = 100
    vecs = synthetic(n, 4)
    idx.add_batch([str(i) for i in range(n)], vecs)
    assert idx.get_stats().count == n
    hits = idx.search(vecs[77], 1)
    assert hits[0].id == "77"


def test_snapshot_load_roundtrip(tmp_path):
    idx, vecs = make_index(n=30, dim=8)
    idx.delete("v3")
    path = str(tmp_path / "flat.npz")
    idx.snapshot(path)
    fresh = FlatIndex(8)
    fresh.load(path)
    assert fresh.get_stats().count == 29
    hits = fresh.search(vecs[4], 1)
    assert hits[0].id == "v4"
    assert all(h.id != "v3" for h in fresh.search(vecs[3], 30))


def test_sq8_recall_close_to_exact():
    base = synthetic(2000, 32)
    queries = synthetic(20, 32, seed=7)
    idx = FlatIndex(32, storage="sq8")
    idx.add_batch([str(i) for i in range(2000)], base)
    truth = ground_truth(base, queries, 10, "L2")
    res = idx.search_batch(queries, 10)
    ids = np.array([[int(h.id) for h in hits] + [-1] * (10 - len(hits)) for hits in res])
    # proper affine SQ8 should stay near-exact (reference's byte-compare trick
    # loses recall; ours must not)
    assert recall_at_k(ids, truth, 10) >= 0.9


def test_scan_exports_live_entries():
    idx, vecs = make_index(n=10)
    idx.delete("v2")
    entries = dict(idx.scan())
    assert len(entries) == 9
    assert "v2" not in entries
    np.testing.assert_allclose(entries["v5"], vecs[5])


class TestApproxSelection:
    """lax.approx_max_k selection mode (an exact top-k on the GPU)."""

    def test_approx_matches_exact_on_small_n(self):
        # N <= 1024 falls back to exact top_k inside masked_topk
        import numpy as np
        from pyrope_tpu.index.flat import FlatIndex

        rng = np.random.default_rng(0)
        vecs = rng.random((200, 16), dtype=np.float32)
        exact = FlatIndex(16, "L2")
        approx = FlatIndex(16, "L2", selection="approx:0.95")
        ids = [f"v{i}" for i in range(200)]
        exact.add_batch(ids, vecs)
        approx.add_batch(ids, vecs)
        q = vecs[:4]
        r1 = exact.search_batch(q, 5)
        r2 = approx.search_batch(q, 5)
        assert [[h.id for h in row] for row in r1] == [[h.id for h in row] for row in r2]

    def test_approx_recall_large_n(self):
        import numpy as np
        from pyrope_tpu.index.flat import FlatIndex
        from pyrope_tpu.utils.datasets import ground_truth, recall_at_k

        rng = np.random.default_rng(1)
        n = 8192
        vecs = rng.random((n, 32), dtype=np.float32)
        idx = FlatIndex(32, "L2", storage="bf16", selection="approx:0.95")
        idx.add_batch([str(i) for i in range(n)], vecs)
        q = rng.random((16, 32), dtype=np.float32)
        res = idx.search_batch(q, 10)
        truth = ground_truth(vecs, q, 10, "L2")
        ids = np.array([[int(h.id) for h in row] + [-1] * (10 - len(row)) for row in res])
        assert recall_at_k(ids, truth, 10) >= 0.8  # bf16 scores + approx select

    def test_invalid_selection_rejected(self):
        import pytest
        from pyrope_tpu.index.flat import FlatIndex

        with pytest.raises(ValueError):
            FlatIndex(8, "L2", selection="bogus")

    def test_snapshot_preserves_selection(self, tmp_path):
        import numpy as np
        from pyrope_tpu.index.flat import FlatIndex

        idx = FlatIndex(8, "L2", selection="approx:0.9")
        idx.add("a", np.ones(8, np.float32))
        p = str(tmp_path / "s.npz")
        idx.snapshot(p)
        idx.load(p)
        assert idx.selection == "approx:0.9"
        assert idx.search(np.ones(8, np.float32), 1)[0].id == "a"


class TestConcurrentMutation:
    """Regression for ADVICE r1 (high): concurrent add() during a device
    sync must never be dropped from the dirty set — the vector would stay
    permanently invisible to device searches."""

    def test_concurrent_add_and_search_loses_nothing(self):
        import threading

        import numpy as np

        from pyrope_tpu.index.flat import FlatIndex

        rng = np.random.default_rng(0)
        idx = FlatIndex(16, "L2")
        # seed + first sync so the incremental scatter path is active
        idx.add_batch([f"s{i}" for i in range(64)], rng.normal(size=(64, 16)).astype(np.float32))
        idx.search(np.zeros(16, np.float32), 1)

        n_writers, per_writer = 4, 100
        errs = []

        def writer(w):
            try:
                for i in range(per_writer):
                    idx.add(f"w{w}_{i}", rng.normal(size=16).astype(np.float32) + w)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        def searcher():
            try:
                for _ in range(50):
                    idx.search(np.zeros(16, np.float32), 5)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(w,)) for w in range(n_writers)]
        threads += [threading.Thread(target=searcher) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs

        # every written vector must now be visible to a device search
        assert idx.get_stats().count == 64 + n_writers * per_writer
        for w in range(n_writers):
            for i in range(0, per_writer, 17):
                q = idx._vecs[idx._id_to_row[f"w{w}_{i}"]]
                hits = idx.search(q, 1)
                assert hits and hits[0].id == f"w{w}_{i}"


class TestHostWriteCheap:
    def test_false_at_capacity_edge(self):
        """host_write_cheap must flip False exactly when the next add
        would cross a capacity bucket (the O(n) slab realloc must not be
        classed as a microseconds write — review fix ce8e14f)."""
        import numpy as np
        import pyrope_tpu as pt

        idx = pt.FlatIndex(4, "L2", min_capacity=4)
        for i in range(3):
            assert idx.host_write_cheap
            idx.add(str(i), np.ones(4, np.float32) * i)
        assert idx.host_write_cheap  # 3 rows in a 4-cap bucket
        idx.add("3", np.ones(4, np.float32) * 3)
        assert not idx.host_write_cheap  # full: next add reallocs
        idx.add("4", np.ones(4, np.float32) * 4)  # grows to the next bucket
        assert idx.host_write_cheap
        assert idx.get_stats().count == 5

    def test_delta_forwards_head(self):
        import numpy as np
        import pyrope_tpu as pt

        d = pt.DeltaIndex(
            pt.FlatIndex(4, "L2", min_capacity=4),
            pt.IvfFlatIndex(4, "L2", nlist=2),
        )
        for i in range(4):
            d.add(str(i), np.ones(4, np.float32) * i)
        assert not d.host_write_cheap  # head bucket full


# ---- hybrid exact path (bf16 Pallas scan + fp32-HIGHEST rerank) -------------

def _hybrid_pair(n, dim, metric=Metric.L2, seed=3, selection="hybrid"):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    hy = FlatIndex(dim, metric, selection=selection)
    hy.add_batch(ids, vecs)
    ex = FlatIndex(dim, metric)
    ex.add_batch(ids, vecs)
    return hy, ex, vecs


def _assert_same_hits(hy, ex, queries, k):
    a = hy.search_batch(queries, k)
    b = ex.search_batch(queries, k)
    for ra, rb in zip(a, b):
        assert [h.id for h in ra] == [h.id for h in rb]
        for ha, hb in zip(ra, rb):
            assert ha.score == pytest.approx(hb.score, rel=1e-5, abs=1e-5)


def test_hybrid_matches_exact_l2():
    hy, ex, vecs = _hybrid_pair(3000, 16)
    q = np.random.default_rng(5).normal(size=(8, 16)).astype(np.float32)
    _assert_same_hits(hy, ex, q, 10)
    assert hy.describe_scan() == "flat-pallas-hybrid"


def test_hybrid_matches_exact_ip_wide_k():
    hy, ex, _ = _hybrid_pair(1500, 16, metric=Metric.INNER_PRODUCT)
    q = np.random.default_rng(6).normal(size=(4, 16)).astype(np.float32)
    _assert_same_hits(hy, ex, q, 100)  # wide k: bitonic shortlist inside


def test_hybrid_explicit_shortlist_width():
    hy, ex, _ = _hybrid_pair(2000, 8, selection="hybrid:128")
    q = np.random.default_rng(7).normal(size=(4, 8)).astype(np.float32)
    _assert_same_hits(hy, ex, q, 10)


def test_hybrid_mutation_and_max_scans():
    hy, ex, vecs = _hybrid_pair(1200, 8)
    q = vecs[37] + 0.01
    # delete the nearest row, then upsert a closer one (hits _scatter4)
    for idx in (hy, ex):
        idx.delete("v37")
        idx.upsert("v999", (q + 0.001).astype(np.float32))
    _assert_same_hits(hy, ex, q[None, :], 5)
    hits = hy.search(q, 3)
    assert hits[0].id == "v999"
    opts = SearchOptions(max_scans=100)
    a = hy.search_batch(q[None, :], 5, opts)[0]
    b = ex.search_batch(q[None, :], 5, opts)[0]
    assert [h.id for h in a] == [h.id for h in b]


def test_hybrid_requires_fp32_storage():
    with pytest.raises(ValueError):
        FlatIndex(8, selection="hybrid", storage="bf16")


def test_hybrid_cosine_falls_back_to_exact():
    hy, _, vecs = _hybrid_pair(500, 8, metric=Metric.COSINE)
    assert hy.describe_scan() == "flat-exact"
    hits = hy.search(vecs[3], 1)
    assert hits[0].id == "v3"


def test_hybrid_routes_large_batches_to_fp32_pallas():
    """Hybrid keeps the bf16 shortlist kernel at every batch size (the
    batch crossover existed for a merge that is gone); large batches
    still match the exact scan."""
    hy, ex, vecs = _hybrid_pair(1200, 8)
    assert hy.describe_scan(batch=64) == "flat-pallas-hybrid"
    assert hy.describe_scan(batch=1024) == "flat-pallas-hybrid"
    q = np.random.default_rng(9).normal(size=(264, 8))
    _assert_same_hits(hy, ex, q.astype(np.float32), 5)
