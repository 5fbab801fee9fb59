"""IvfFlatIndex tests (mirrors Vector/IvfFlatVectorIndexTests.cs:22-95:
clustering correctness, centroids-after-build, buffer-search-before-build,
plus recall/maxscans/nprobe behavior)."""

import numpy as np
import pytest

from pyrope_tpu import IvfFlatIndex, Metric, SearchOptions
from pyrope_tpu.utils.datasets import ground_truth, recall_at_k, synthetic


def built_index(n=2000, dim=16, nlist=20, metric=Metric.L2, seed=0):
    base = synthetic(n, dim, seed=seed)
    idx = IvfFlatIndex(dim, metric, nlist=nlist)
    idx.add_batch([str(i) for i in range(n)], base)
    idx.build()
    return idx, base


def test_buffer_search_before_build():
    idx = IvfFlatIndex(8, nlist=4)
    vecs = synthetic(20, 8)
    idx.add_batch([str(i) for i in range(20)], vecs)
    hits = idx.search(vecs[13], 3)
    assert hits[0].id == "13"
    assert idx.get_centroids() is None


def test_centroids_after_build():
    idx, _ = built_index(n=300, nlist=10)
    cents = idx.get_centroids()
    assert cents is not None and cents.shape == (10, 16)


def test_exact_hit_after_build():
    idx, base = built_index()
    hits = idx.search(base[700], 1)
    assert hits[0].id == "700"
    assert hits[0].score == pytest.approx(0.0, abs=1e-3)


def test_recall_at_full_probe_is_exact():
    idx, base = built_index(n=1000, nlist=10)
    q = synthetic(16, 16, seed=9)
    truth = ground_truth(base, q, 10, "L2")
    res = idx.search_batch(q, 10, SearchOptions(nprobe=10))
    ids = np.array([[int(h.id) for h in hits] + [-1] * (10 - len(hits)) for hits in res])
    assert recall_at_k(ids, truth, 10) == 1.0


def test_default_nprobe_recall_reasonable():
    idx, base = built_index(n=2000, nlist=20)
    q = synthetic(32, 16, seed=11)
    truth = ground_truth(base, q, 10, "L2")
    res = idx.search_batch(q, 10)
    ids = np.array([[int(h.id) for h in hits] + [-1] * (10 - len(hits)) for hits in res])
    assert recall_at_k(ids, truth, 10) >= 0.5  # nprobe=3/20 lists


def test_writes_after_build_go_to_buffer_and_win():
    idx, base = built_index(n=500, nlist=8)
    nv = np.full(16, 0.5, np.float32)
    idx.add("new", nv)
    hits = idx.search(nv, 1)
    assert hits[0].id == "new"
    # upsert of an existing main id: buffer copy supersedes the main copy
    idx.upsert("42", nv * -1.0)
    hits = idx.search(nv * -1.0, 1)
    assert hits[0].id == "42"
    assert idx.get_stats().count == 501


def test_delete_from_main_and_buffer():
    idx, base = built_index(n=300, nlist=8)
    assert idx.delete("100")
    assert all(h.id != "100" for h in idx.search(base[100], 10))
    idx.add("tmp", np.ones(16, np.float32))
    assert idx.delete("tmp")
    assert not idx.delete("tmp")
    assert idx.get_stats().count == 299


def test_max_scans_budget():
    idx, base = built_index(n=1000, nlist=10)
    # max_scans=0 -> nothing from the main lists
    hits = idx.search(base[0], 5, SearchOptions(max_scans=0))
    assert hits == []


def test_build_merges_buffer_into_lists():
    idx, base = built_index(n=400, nlist=8)
    extra = synthetic(50, 16, seed=77) + 2.0
    for i, v in enumerate(extra):
        idx.add(f"x{i}", v)
    idx.build()
    assert idx._buffer.get_stats().count == 0
    assert idx.get_stats().count == 450
    hits = idx.search(extra[7], 1)
    assert hits[0].id == "x7"


def test_snapshot_load_roundtrip(tmp_path):
    idx, base = built_index(n=300, nlist=8)
    idx.delete("5")
    idx.add("buffered", np.full(16, 3.0, np.float32))
    p = str(tmp_path / "ivf.npz")
    idx.snapshot(p)
    fresh = IvfFlatIndex(16)
    fresh.load(p)
    assert fresh.get_stats().count == 300  # 299 main + 1 buffer
    assert fresh.search(base[10], 1)[0].id == "10"
    assert fresh.search(np.full(16, 3.0, np.float32), 1)[0].id == "buffered"
    assert all(h.id != "5" for h in fresh.search(base[5], 10))


def test_cosine_ivf():
    idx, base = built_index(n=500, nlist=8, metric=Metric.COSINE)
    hits = idx.search(base[123] * 5.0, 1)  # scale-invariant
    assert hits[0].id == "123"
    assert hits[0].score == pytest.approx(1.0, abs=1e-3)


# ---- dense-mask scan kernel parity -----------------------------------------


def _hit_ids(results):
    return [[h.id for h in hits] for hits in results]


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_dense_and_probe_scan_identical(metric):
    """The dense full-matmul kernel and the sparse probe-slice kernel must
    return identical hit sets at every nprobe (same probe semantics)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((800, 16)).astype(np.float32)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    hits = {}
    for mode in ("dense", "probe"):
        idx = IvfFlatIndex(16, metric, nlist=10, scan_mode=mode)
        idx.add_batch([str(i) for i in range(800)], x)
        idx.build()
        hits[mode] = {
            np_: _hit_ids(idx.search_batch(q, 5, SearchOptions(nprobe=np_)))
            for np_ in (1, 3, 10)
        }
    assert hits["dense"] == hits["probe"]


def test_dense_scan_respects_max_scans_budget():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((600, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    out = {}
    for mode in ("dense", "probe"):
        idx = IvfFlatIndex(8, "L2", nlist=6, scan_mode=mode)
        idx.add_batch([str(i) for i in range(600)], x)
        idx.build()
        out[mode] = _hit_ids(
            idx.search_batch(q, 10, SearchOptions(nprobe=6, max_scans=37))
        )
    assert out["dense"] == out["probe"]


def test_dense_scan_after_delete():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    idx = IvfFlatIndex(8, "L2", nlist=5, scan_mode="dense")
    idx.add_batch([str(i) for i in range(300)], x)
    idx.build()
    top = idx.search_batch(x[17], 1)[0][0]
    assert top.id == "17"
    idx.delete("17")
    hits = idx.search_batch(x[17], 5, SearchOptions(nprobe=5))[0]
    assert "17" not in [h.id for h in hits]


def test_pick_scan_mode_auto_thresholds():
    from pyrope_tpu.index.ivf_flat import pick_scan_mode

    assert pick_scan_mode("dense", 10**9, 1, 1) == "dense"
    assert pick_scan_mode("probe", 10, 1, 1) == "probe"
    # small slab -> dense
    assert pick_scan_mode("auto", 100_000, 3, 1152) == "dense"
    # huge slab, tiny probed volume -> probe
    assert pick_scan_mode("auto", 8_000_000, 3, 1152) == "probe"
    # huge slab but probed volume rivals a full scan -> dense ... unless the
    # [B, npad] transients would blow past the HBM cap (ADVICE r2: factor
    # batch into the shortcut so an unusual bucket cannot OOM the chip)
    assert pick_scan_mode("auto", 8_000_000, 96, 8192, batch=32) == "dense"
    assert pick_scan_mode("auto", 8_000_000, 96, 8192, batch=64) == "probe"
    assert pick_scan_mode("auto", 262_144, 3, 1152, batch=1024) == "dense"
    assert pick_scan_mode("auto", 262_144, 3, 1152, batch=4096) == "probe"
    # ... but the OOM guard only protects the XLA fallback's [B, npad]
    # transients: a batch eligible for the fused Pallas kernel (tile
    # streaming, [B, k] scratch) stays dense at any batch size
    assert pick_scan_mode("auto", 262_144, 3, 1152, batch=4096,
                          fused=True) == "dense"
    assert pick_scan_mode("auto", 8_000_000, 96, 8192, batch=64,
                          fused=True) == "dense"
    # the sparse gather blowup is PER QUERY: a bigger batch tips wide-probe
    # configs to dense (one slab pass amortizes over ~256 queries)
    assert pick_scan_mode("auto", 1_000_000, 96, 1408, batch=8) == "probe"
    assert pick_scan_mode("auto", 1_000_000, 96, 1408, batch=64) == "dense"


def test_scan_mode_snapshot_roundtrip(tmp_path):
    idx = IvfFlatIndex(8, "L2", nlist=4, scan_mode="dense")
    idx.add_batch([str(i) for i in range(50)], synthetic(50, 8))
    idx.build()
    p = str(tmp_path / "ivf.npz")
    idx.snapshot(p)
    idx2 = IvfFlatIndex(8, "L2")
    idx2.load(p)
    assert idx2.scan_mode == "dense"


def test_selection_pallas_probe_mode_raises():
    """selection='pallas' (the exact fused kernel, which lost to XLA on the
    H100) is rejected at construction; the exact default scans with the
    XLA kernels in either scan mode, budgets included."""
    import pytest

    from pyrope_tpu.types import SearchOptions
    from pyrope_tpu.utils.datasets import synthetic

    with pytest.raises(ValueError, match="selection"):
        IvfFlatIndex(16, "L2", nlist=8, nprobe=2, selection="pallas")
    base = synthetic(2048, 16)
    idx = IvfFlatIndex(16, "L2", nlist=8, nprobe=2, scan_mode="probe")
    idx.add_batch([str(i) for i in range(2048)], base)
    idx.build()
    assert idx.describe_scan(8) == "probe"
    idx.scan_mode = "dense"
    assert idx.describe_scan(8, max_scans=512) == "dense-xla"
    hits = idx.search_batch(base[:8], 5, SearchOptions(max_scans=512))
    assert hits[0]


def test_selection_hybrid_matches_dense_exact():
    """hybrid (bf16 scan top-R + fp32-HIGHEST rerank) returns the same hit
    sets and scores as the fp32 dense path."""
    from pyrope_tpu.utils.datasets import synthetic

    base = synthetic(4096, 16)
    ids = [str(i) for i in range(4096)]
    hy = IvfFlatIndex(16, "L2", nlist=8, nprobe=4, selection="hybrid",
                      scan_mode="dense")
    ex = IvfFlatIndex(16, "L2", nlist=8, nprobe=4, scan_mode="dense")
    for idx in (hy, ex):
        idx.add_batch(ids, base)
        idx.build()
    assert hy.describe_scan(8) == "dense-pallas-hybrid"
    q = base[:8] + 0.01
    ha = hy.search_batch(q, 10)
    hb = ex.search_batch(q, 10)
    for ra, rb in zip(ha, hb):
        assert [h.id for h in ra] == [h.id for h in rb]
        for x, y in zip(ra, rb):
            assert abs(x.score - y.score) <= 1e-4 + 1e-5 * abs(y.score)


def test_selection_hybrid_validation():
    import pytest

    with pytest.raises(ValueError, match="hybrid"):
        IvfFlatIndex(8, "L2", selection="hybrid", compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="selection"):
        IvfFlatIndex(8, "L2", selection="bogus")


def test_selection_hybrid_windowed():
    """A wide cluster table (nlist 600) routes hybrid through the same fused
    kernel; hit sets still match the exact XLA dense scan."""
    from pyrope_tpu.utils.datasets import synthetic

    n, nlist = 8192, 600
    base = synthetic(n, 8)
    ids = [str(i) for i in range(n)]
    hy = IvfFlatIndex(8, "L2", nlist=nlist, nprobe=32, selection="hybrid",
                      scan_mode="dense")
    ex = IvfFlatIndex(8, "L2", nlist=nlist, nprobe=32, selection="exact",
                      scan_mode="dense")
    for idx in (hy, ex):
        idx.add_batch(ids, base)
        idx.build()
    assert hy.describe_scan(8) == "dense-pallas-hybrid"
    assert ex.describe_scan(8) == "dense-xla"
    q = base[:8] + 0.01
    ha = hy.search_batch(q, 10)
    hb = ex.search_batch(q, 10)
    for ra, rb in zip(ha, hb):
        assert [h.id for h in ra] == [h.id for h in rb]


def test_dim768_default_dense_scan_no_tile_crash():
    """Regression (ADVICE r4): IvfFlatIndex(dim=768, n=2000) once crashed at
    query time on the default dense scan because the slab (2432 rows) was
    not a multiple of the kernel's row tile. The fused kernel masks its
    last tile, so any slab length runs."""
    n, dim = 2000, 768
    base = synthetic(n, dim)
    idx = IvfFlatIndex(dim, "L2", nlist=16, nprobe=4)
    idx.add_batch([str(i) for i in range(n)], base)
    idx.build()
    assert idx.describe_scan(8) == "dense-xla"
    hits = idx.search_batch(base[:8] + 1e-3, 10)
    assert hits[0][0].id == "0"


def test_pallas_dense_ok_dim_aware():
    """The hybrid dense route (the fused kernel) runs at any width, slab
    length and cluster-table width — here d=768 over a 2432-row slab —
    and cosine hybrid falls back to the exact XLA kernel."""
    n, dim = 2000, 768
    base = synthetic(n, dim)
    ids = [str(i) for i in range(n)]
    hy = IvfFlatIndex(dim, "L2", nlist=16, nprobe=4, selection="hybrid",
                      scan_mode="dense")
    ex = IvfFlatIndex(dim, "L2", nlist=16, nprobe=4, scan_mode="dense")
    for idx in (hy, ex):
        idx.add_batch(ids, base)
        idx.build()
    assert hy.describe_scan(8) == "dense-pallas-hybrid"
    q = base[:8] + 1e-3
    for ra, rb in zip(hy.search_batch(q, 10), ex.search_batch(q, 10)):
        assert [h.id for h in ra] == [h.id for h in rb]
    cos = IvfFlatIndex(16, "COSINE", nlist=4, selection="hybrid",
                       scan_mode="dense")
    cos.add_batch([str(i) for i in range(200)], synthetic(200, 16))
    cos.build()
    assert cos.describe_scan(8) == "dense-xla"
