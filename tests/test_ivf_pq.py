"""IvfPqIndex tests (mirrors Vector/IvfPqVectorIndexTests.cs plus the
reference gaps we close: main-slab delete, snapshot/load)."""

import numpy as np
import pytest

from pyrope_tpu import IvfPqIndex, Metric, SearchOptions
from pyrope_tpu.utils.datasets import ground_truth, recall_at_k, synthetic


def built_index(n=2000, dim=32, nlist=10, pq_m=8, ksub=64, metric=Metric.L2,
                **kw):
    base = synthetic(n, dim)
    idx = IvfPqIndex(dim, metric, nlist=nlist, pq_m=pq_m, ksub=ksub, **kw)
    idx.add_batch([str(i) for i in range(n)], base)
    idx.build()
    return idx, base


def test_buffer_search_before_build():
    idx = IvfPqIndex(16, nlist=4, pq_m=4)
    vecs = synthetic(30, 16)
    idx.add_batch([str(i) for i in range(30)], vecs)
    assert idx.search(vecs[11], 1)[0].id == "11"


def test_full_probe_matches_reconstruction_ranking():
    """Pure ADC (refine=0, the reference's scoring) at full probe must
    reproduce the ranking implied by the PQ reconstructions (the quantizer's
    ceiling) near-perfectly, and clear a loose floor vs exact truth (uniform
    random data is PQ's hardest case)."""
    idx, base = built_index(refine=0)
    q = synthetic(16, 32, seed=9)
    res = idx.search_batch(q, 10, SearchOptions(nprobe=10))
    ids = np.array([[int(h.id) for h in hits] + [-1] * (10 - len(hits)) for hits in res])

    # ceiling: rank by decoded reconstructions + residual centroids
    order = np.argsort([int(i) for i in idx._perm_ids])
    recon = idx.pq.decode(idx._codes)
    # rebuild absolute reconstructions: residual + assigned centroid
    assign = np.repeat(np.arange(len(idx._lens)), idx._lens)
    recon_abs = recon + idx._centroids[assign]
    recon_sorted = recon_abs[order]  # row i = id str(i)
    ceil_truth = ground_truth(recon_sorted, q, 10, "L2")
    assert recall_at_k(ids, ceil_truth, 10) >= 0.95

    truth = ground_truth(base, q, 10, "L2")
    assert recall_at_k(ids, truth, 10) >= 0.3


def test_exact_vector_found():
    idx, base = built_index(n=500, nlist=5)
    hits = idx.search(base[123], 5, SearchOptions(nprobe=5))
    assert "123" in [h.id for h in hits]


def test_ip_metric():
    idx, base = built_index(n=1000, nlist=8, metric=Metric.INNER_PRODUCT)
    q = synthetic(8, 32, seed=3)
    truth = ground_truth(base, q, 10, "IP")
    res = idx.search_batch(q, 10, SearchOptions(nprobe=8))
    ids = np.array([[int(h.id) for h in hits] + [-1] * (10 - len(hits)) for hits in res])
    assert recall_at_k(ids, truth, 10) >= 0.6


def test_cosine_metric_scale_invariance():
    idx, base = built_index(n=500, nlist=5, metric=Metric.COSINE)
    res1 = idx.search(base[42], 10, SearchOptions(nprobe=5))
    res2 = idx.search(base[42] * 7.0, 10, SearchOptions(nprobe=5))
    assert [h.id for h in res1] == [h.id for h in res2]
    assert "42" in [h.id for h in res1]


def test_delete_from_main_is_visible():
    idx, base = built_index(n=400, nlist=5)
    assert idx.delete("77")
    hits = idx.search(base[77], 20, SearchOptions(nprobe=5))
    assert all(h.id != "77" for h in hits)
    assert idx.get_stats().count == 399


def test_writes_after_build_buffer_wins():
    idx, base = built_index(n=300, nlist=5)
    nv = np.full(32, -3.0, np.float32)
    idx.add("new", nv)
    assert idx.search(nv, 1)[0].id == "new"
    idx.upsert("10", nv * 2)
    assert idx.get_stats().count == 301


def test_snapshot_load_roundtrip(tmp_path):
    idx, base = built_index(n=400, nlist=5)
    idx.delete("3")
    p = str(tmp_path / "pq.npz")
    idx.snapshot(p)
    fresh = IvfPqIndex(32)
    fresh.load(p)
    assert fresh.get_stats().count == 399
    hits = fresh.search(base[200], 5, SearchOptions(nprobe=5))
    assert "200" in [h.id for h in hits]


def test_memory_parity_accounting():
    idx, base = built_index(n=1000, dim=32, nlist=10, pq_m=4, ksub=64)
    mem = idx.memory_bytes()
    assert mem["codes"] == 1000 * 4  # 4 bytes/vector vs 128 raw
    assert mem["centroids"] == 10 * 32 * 4


class TestExactRerank:
    """The refine stage (VERDICT r1 #2): ADC-shortlist -> exact rerank."""

    def test_rerank_beats_pure_adc(self):
        base = synthetic(4000, 32)
        q = synthetic(32, 32, seed=9)
        truth = ground_truth(base, q, 10, "L2")

        def recall(refine):
            idx = IvfPqIndex(32, nlist=10, pq_m=4, ksub=64, refine=refine)
            idx.add_batch([str(i) for i in range(4000)], base)
            idx.build()
            res = idx.search_batch(q, 10, SearchOptions(nprobe=10))
            ids = np.array(
                [[int(h.id) for h in hits] + [-1] * (10 - len(hits)) for hits in res]
            )
            return recall_at_k(ids, truth, 10)

        r0, r64 = recall(0), recall(64)
        # at FULL probe, rerank recall is bounded only by the shortlist:
        # R=640 of 4000 rows must land far above the pure-ADC m=4 score
        assert r64 >= 0.9, (r0, r64)
        assert r64 > r0 + 0.2, (r0, r64)

    def test_rerank_scores_are_exact(self):
        """Refined scores must equal exact -||q-x||^2 up to the bf16 slab
        storage rounding (vs the ADC approximation, which is far off)."""
        idx, base = built_index(n=1000, nlist=5, refine=64, refine_storage="fp32")
        q = synthetic(4, 32, seed=5)
        res = idx.search_batch(q, 5, SearchOptions(nprobe=5))
        for bi, hits in enumerate(res):
            for h in hits:
                d2 = float(((base[int(h.id)] - q[bi]) ** 2).sum())
                assert abs(-d2 - h.score) < 1e-3 * max(1.0, d2), (h.score, -d2)

    def test_refine_snapshot_roundtrip(self, tmp_path):
        idx, base = built_index(n=500, nlist=5, refine=16)
        p = str(tmp_path / "pq.npz")
        idx.snapshot(p)
        idx2 = IvfPqIndex(32, nlist=5, pq_m=8, ksub=64, refine=0)
        idx2.load(p)
        assert idx2.refine == 16 and idx2.refine_storage == "fp32"
        a = [h.id for h in idx.search(base[7], 5, SearchOptions(nprobe=5))]
        b = [h.id for h in idx2.search(base[7], 5, SearchOptions(nprobe=5))]
        assert a == b

    def test_memory_accounting_reports_refine_slab(self):
        idx, _ = built_index(n=500, nlist=5, refine=16)
        mb = idx.memory_bytes()
        assert mb["refine_slab"] > 0
        idx2, _ = built_index(n=500, nlist=5, refine=0)
        assert "refine_slab" not in idx2.memory_bytes()


# ---- dense-mask ADC kernel parity -------------------------------------------


def _ids(results):
    return [[h.id for h in hits] for hits in results]


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("refine", [0, 8])
def test_dense_adc_matches_probe_adc(metric, refine):
    """refine=0: dense shared-slab ADC (cluster-decomposed tables) must
    reproduce the probe-sliced ADC scores up to fp summation order.
    refine>0: the dense path exact-scores ALL probed rows, so it must
    DOMINATE the probe path's ADC-shortlist→rerank position-by-position
    (it can only find equal-or-closer hits)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((900, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    res = {}
    for mode in ("dense", "probe"):
        idx = IvfPqIndex(
            16, metric, nlist=8, pq_m=4, ksub=16, refine=refine, scan_mode=mode
        )
        idx.add_batch([str(i) for i in range(900)], x)
        idx.build()
        res[mode] = idx.search_batch(q, 10, SearchOptions(nprobe=4))
    for d_hits, p_hits in zip(res["dense"], res["probe"]):
        d_ids, p_ids = {h.id for h in d_hits}, {h.id for h in p_hits}
        overlap = len(d_ids & p_ids) / max(len(p_ids), 1)
        # refine=0: same ADC scores -> near-identical sets. refine>0
        # compares exact scan (dense) vs ADC-shortlist+rerank (probe): at
        # this toy scale (ksub=16 tables over 16-dim) the shortlist can
        # legitimately miss exact-top rows, so the set bound is loose and
        # the real invariant is the position-wise score domination below.
        assert overlap >= (0.8 if refine == 0 else 0.5), (
            sorted(d_ids), sorted(p_ids))
        for dh, ph in zip(d_hits, p_hits):
            if refine > 0:
                assert dh.score >= ph.score - 1e-3  # dense can only improve
            else:
                assert dh.score == pytest.approx(ph.score, rel=1e-4, abs=1e-3)


def test_dense_adc_max_scans_and_delete():
    """Pure-ADC (refine=0) dense vs probe must produce identical hit sets
    under a max_scans budget and after deletes."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((640, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    out = {}
    for mode in ("dense", "probe"):
        idx = IvfPqIndex(8, "L2", nlist=5, pq_m=2, ksub=16, refine=0,
                         scan_mode=mode)
        idx.add_batch([str(i) for i in range(640)], x)
        idx.build()
        idx.delete("3")
        out[mode] = _ids(
            idx.search_batch(q, 5, SearchOptions(nprobe=5, max_scans=55))
        )
    assert out["dense"] == out["probe"]
    assert all("3" not in hits for hits in out["dense"])


def test_dense_exact_scan_respects_delete_and_budget():
    """refine>0 dense path (exact scan of the rerank slab) must honor
    tombstones and the max_scans budget."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    idx = IvfPqIndex(8, "L2", nlist=4, pq_m=2, ksub=16, refine=8,
                     scan_mode="dense")
    idx.add_batch([str(i) for i in range(400)], x)
    idx.build()
    assert idx.search_batch(x[7], 1)[0][0].id == "7"
    idx.delete("7")
    hits = idx.search_batch(x[7], 5, SearchOptions(nprobe=4))[0]
    assert "7" not in [h.id for h in hits]
    # a 1-row budget can return at most nprobe hits per query
    tiny = idx.search_batch(x[8], 10, SearchOptions(nprobe=4, max_scans=1))[0]
    assert len(tiny) <= 4


class TestRefineStorage:
    """Regression for the 1M-clustered recall cap (round 3): a bf16 rerank
    slab rounds scores by ~0.4%, the same magnitude as inter-neighbor
    margins inside a tight cluster, so the 'exact' rerank reorders
    near-ties and recall plateaus regardless of nprobe/refine width.
    fp32 (the default) must restore full-probe recall to ~1.0."""

    def _clustered(self, n=4000, dim=32, nc=10):
        from pyrope_tpu.utils.datasets import (
            synthetic_clustered,
            synthetic_clustered_queries,
        )

        base = synthetic_clustered(n, dim, n_clusters=nc)
        queries = synthetic_clustered_queries(32, dim, n_clusters=nc)
        return base, queries

    def _recall(self, base, queries, **kw):
        from pyrope_tpu.utils.datasets import id_lists_to_rows

        idx = IvfPqIndex(base.shape[1], nlist=10, pq_m=8, ksub=64,
                         refine=64, **kw)
        idx.add_batch([str(i) for i in range(len(base))], base)
        idx.build()
        truth = ground_truth(base, queries, 10, "L2")
        res = idx.search_batch(queries, 10, SearchOptions(nprobe=10))
        ids = [[h.id for h in r] for r in res]
        return recall_at_k(id_lists_to_rows(ids), truth, 10)

    def test_default_is_fp32(self):
        assert IvfPqIndex(16, nlist=4, pq_m=4).refine_storage == "fp32"

    def test_fp32_slab_restores_clustered_recall(self):
        base, queries = self._clustered()
        r_fp32 = self._recall(base, queries)  # default fp32
        r_bf16 = self._recall(base, queries, refine_storage="bf16")
        # full probe + R >= n/nlist: fp32 rerank is coverage-free and exact
        assert r_fp32 >= 0.99, r_fp32
        # the bf16 cap is the regression being pinned: near-tie reordering
        # keeps it measurably below the fp32 slab on clustered data
        assert r_bf16 < r_fp32 - 0.05, (r_bf16, r_fp32)

    def test_registry_param_roundtrip(self):
        from pyrope_tpu.registry import create_index
        from pyrope_tpu.types import IndexConfig, IndexParams

        cfg = IndexConfig(dim=16, algorithm="IVF_PQ",
                          params=IndexParams.from_dict(
                              {"refine_storage": "bf16", "nlist": 4,
                               "pq_m": 4}))
        assert create_index(cfg).tail.refine_storage == "bf16"
        with pytest.raises(ValueError):
            IndexParams.from_dict({"refine_storage": "fp64"})


class TestSq8resStorage:
    """refine_storage='sq8res' (VERDICT r4 #2): the rerank slab as per-row
    residual-SQ8 codes — compressed (N·(D+12) bytes, 1/4 of fp32 at D=128)
    AND high-recall (the quantization step tracks the cluster radius, not
    bf16's relative rounding)."""

    def _clustered(self, n=4000, dim=32, nc=10):
        from pyrope_tpu.utils.datasets import (
            synthetic_clustered,
            synthetic_clustered_queries,
        )

        base = synthetic_clustered(n, dim, n_clusters=nc)
        queries = synthetic_clustered_queries(32, dim, n_clusters=nc)
        return base, queries

    def _build(self, base, **kw):
        idx = IvfPqIndex(base.shape[1], nlist=10, pq_m=8, ksub=64,
                         refine=64, **kw)
        idx.add_batch([str(i) for i in range(len(base))], base)
        idx.build()
        return idx

    def _recall(self, idx, base, queries):
        from pyrope_tpu.utils.datasets import id_lists_to_rows

        truth = ground_truth(base, queries, 10, "L2")
        res = idx.search_batch(queries, 10, SearchOptions(nprobe=10))
        ids = [[h.id for h in r] for r in res]
        return recall_at_k(id_lists_to_rows(ids), truth, 10)

    def test_sq8res_beats_bf16_on_clustered(self):
        """The config's reason to exist: clustered near-tie margins survive
        residual quantization (cluster-radius step) but not bf16 rounding."""
        base, queries = self._clustered()
        r_sq8 = self._recall(self._build(base, refine_storage="sq8res"),
                             base, queries)
        r_bf16 = self._recall(self._build(base, refine_storage="bf16"),
                              base, queries)
        assert r_sq8 >= 0.97, r_sq8
        assert r_sq8 > r_bf16, (r_sq8, r_bf16)

    def test_sq8res_dense_routes_to_pallas_kernel(self):
        base, _ = self._clustered(n=2048)
        idx = self._build(base, refine_storage="sq8res", scan_mode="dense")
        # the residual-SQ8 slab is scanned by the XLA decomposition kernel,
        # with or without a max_scans budget
        assert idx.describe_scan(8) == "dense-sq8-xla", idx.describe_scan(8)
        assert idx.describe_scan(8, max_scans=100) == "dense-sq8-xla"

    def test_sq8res_probe_mode_reranks_off_codes(self):
        base, queries = self._clustered()
        idx = self._build(base, refine_storage="sq8res", scan_mode="probe")
        assert idx.describe_scan(8) == "probe-adc+rerank-sq8"
        assert self._recall(idx, base, queries) >= 0.9

    def test_sq8res_scores_near_exact(self):
        """Scores off the reconstruction must match exact -||q-x||^2 within
        the residual quantization step (far tighter than ADC)."""
        base, _ = self._clustered(n=1000)
        idx = self._build(base, refine_storage="sq8res")
        q = base[:4] + 0.01
        res = idx.search_batch(q, 5, SearchOptions(nprobe=10))
        for bi, hits in enumerate(res):
            for h in hits:
                d2 = float(((base[int(h.id)] - q[bi]) ** 2).sum())
                assert abs(-d2 - h.score) < 2e-2 * max(1.0, d2), (h.score, -d2)

    def test_sq8res_dense_and_probe_agree(self):
        base, queries = self._clustered(n=2000)
        a = self._build(base, refine_storage="sq8res", scan_mode="dense")
        b = self._build(base, refine_storage="sq8res", scan_mode="probe")
        ra = a.search_batch(queries, 10, SearchOptions(nprobe=10))
        rb = b.search_batch(queries, 10, SearchOptions(nprobe=10))
        for ha, hb in zip(ra, rb):
            ia, ib = {h.id for h in ha}, {h.id for h in hb}
            # full probe + R >= list size: both score the same reconstruction
            assert len(ia & ib) >= 9, (sorted(ia), sorted(ib))

    def test_sq8res_memory_is_quarter_of_fp32(self):
        base, _ = self._clustered(n=1000)
        sq8 = self._build(base, refine_storage="sq8res").memory_bytes()
        fp32 = self._build(base, refine_storage="fp32").memory_bytes()
        assert sq8["refine_slab"] == 1000 * (32 + 12)
        assert sq8["refine_slab"] < fp32["refine_slab"] / 2.9

    def test_sq8res_delete_and_snapshot_roundtrip(self, tmp_path):
        base, _ = self._clustered(n=800)
        idx = self._build(base, refine_storage="sq8res")
        idx.delete("7")
        hits = idx.search_batch(base[7], 5, SearchOptions(nprobe=10))[0]
        assert "7" not in [h.id for h in hits]
        p = str(tmp_path / "sq8.npz")
        idx.snapshot(p)
        fresh = IvfPqIndex(32)
        fresh.load(p)
        assert fresh.refine_storage == "sq8res"
        a = [h.id for h in idx.search(base[42], 5, SearchOptions(nprobe=10))]
        b = [h.id for h in fresh.search(base[42], 5, SearchOptions(nprobe=10))]
        assert a == b and "42" in a

    def test_sq8res_windowed_wide_cluster_table(self):
        """A wide cluster table (nlist 600) on the XLA sq8 dense scan: hit
        sets must match the probe-mode rerank (same reconstruction
        scores)."""
        rng = np.random.default_rng(15)
        base = rng.normal(size=(20000, 16)).astype(np.float32)
        ids = [str(i) for i in range(20000)]
        q = rng.normal(size=(8, 16)).astype(np.float32)
        a = IvfPqIndex(16, nlist=600, pq_m=4, ksub=64, refine=64,
                       refine_storage="sq8res", scan_mode="dense", nprobe=32)
        b = IvfPqIndex(16, nlist=600, pq_m=4, ksub=64, refine=64,
                       refine_storage="sq8res", scan_mode="probe", nprobe=32)
        for ix in (a, b):
            ix.add_batch(ids, base)
            ix.build()
        assert a.describe_scan(8) == "dense-sq8-xla", a.describe_scan(8)
        ra = a.search_batch(q, 10)
        rb = b.search_batch(q, 10)
        for ha, hb in zip(ra, rb):
            ia, ib = {h.id for h in ha}, {h.id for h in hb}
            # dense exact-scans all probed rows; probe reranks an ADC
            # shortlist — dense dominates, sets overlap heavily
            assert len(ia & ib) >= 7, (sorted(ia), sorted(ib))
            for dh, ph in zip(ha, hb):
                assert dh.score >= ph.score - 1e-3

    def test_sq8res_param_roundtrip(self):
        from pyrope_tpu.registry import create_index
        from pyrope_tpu.types import IndexConfig, IndexParams

        cfg = IndexConfig(dim=16, algorithm="IVF_PQ",
                          params=IndexParams.from_dict(
                              {"refine_storage": "sq8res", "nlist": 4,
                               "pq_m": 4}))
        assert create_index(cfg).tail.refine_storage == "sq8res"

    def test_sq8res_cosine_scale_invariance(self):
        base, _ = self._clustered(n=600)
        idx = IvfPqIndex(32, Metric.COSINE, nlist=5, pq_m=8, ksub=64,
                         refine=64, refine_storage="sq8res")
        idx.add_batch([str(i) for i in range(600)], base)
        idx.build()
        r1 = idx.search(base[42], 10, SearchOptions(nprobe=5))
        r2 = idx.search(base[42] * 7.0, 10, SearchOptions(nprobe=5))
        assert [h.id for h in r1] == [h.id for h in r2]
        assert "42" in [h.id for h in r1]
