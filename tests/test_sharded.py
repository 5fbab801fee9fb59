"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pyrope_tpu import FlatIndex, Metric, SearchOptions
from pyrope_tpu.ops.kmeans import kmeans_train
from pyrope_tpu.parallel import ShardedFlatIndex, make_mesh, sharded_kmeans_step
from pyrope_tpu.parallel.mesh import DATA_AXIS
from pyrope_tpu.utils.datasets import synthetic


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_flat_matches_single_device():
    base = synthetic(2000, 32)
    q = synthetic(16, 32, seed=5)
    ref = FlatIndex(32)
    ref.add_batch([str(i) for i in range(2000)], base)
    sh = ShardedFlatIndex(32, mesh=make_mesh())
    sh.add_batch([str(i) for i in range(2000)], base)
    r1 = ref.search_batch(q, 10)
    r2 = sh.search_batch(q, 10)
    for a, b in zip(r1, r2):
        assert [h.id for h in a] == [h.id for h in b]
        np.testing.assert_allclose(
            [h.score for h in a], [h.score for h in b], rtol=1e-5, atol=1e-5
        )


def test_sharded_flat_delete_and_maxscans():
    base = synthetic(500, 16)
    sh = ShardedFlatIndex(16)
    sh.add_batch([str(i) for i in range(500)], base)
    sh.delete("123")
    hits = sh.search(base[123], 5)
    assert all(h.id != "123" for h in hits)
    hits = sh.search(base[400], 3, SearchOptions(max_scans=50))
    assert all(int(h.id) < 50 for h in hits)


def test_sharded_flat_metrics():
    base = synthetic(300, 16)
    for metric in (Metric.INNER_PRODUCT, Metric.COSINE):
        sh = ShardedFlatIndex(16, metric)
        sh.add_batch([str(i) for i in range(300)], base)
        ref = FlatIndex(16, metric)
        ref.add_batch([str(i) for i in range(300)], base)
        q = synthetic(4, 16, seed=3)
        a = sh.search_batch(q, 5)
        b = ref.search_batch(q, 5)
        for x, y in zip(a, b):
            assert [h.id for h in x] == [h.id for h in y]


def test_sharded_kmeans_step_matches_host():
    mesh = make_mesh()
    x = synthetic(1024, 16)
    cents0 = x[:8].copy()
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(DATA_AXIS, None)))
    vs = jax.device_put(jnp.ones(1024, bool), NamedSharding(mesh, P(DATA_AXIS)))
    cs = jnp.asarray(cents0)
    out = np.asarray(
        sharded_kmeans_step(xs, vs, cs, metric=Metric.L2, mesh=mesh)
    )
    # host reference: one Lloyd iteration
    d2 = ((x[:, None, :] - cents0[None, :, :]) ** 2).sum(-1)
    assign = d2.argmin(1)
    expect = np.stack([
        x[assign == j].mean(0) if (assign == j).any() else cents0[j]
        for j in range(8)
    ])
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


class TestShardedIvf:
    def test_matches_single_device_ivf(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh

        rng = np.random.default_rng(0)
        n, dim = 4000, 32
        base = rng.random((n, dim), dtype=np.float32)
        ids = [str(i) for i in range(n)]
        q = rng.random((8, dim), dtype=np.float32)

        ref = pt.IvfFlatIndex(dim, "L2", nlist=16)
        ref.add_batch(ids, base)
        ref.build()
        sh = ShardedIvfFlatIndex(dim, "L2", mesh=make_mesh(8), nlist=16)
        sh.add_batch(ids, base)
        sh.build()

        opts = pt.SearchOptions(nprobe=8)
        r_ref = ref.search_batch(q, 10, opts)
        r_sh = sh.search_batch(q, 10, opts)
        for a, b in zip(r_ref, r_sh):
            assert [h.id for h in a] == [h.id for h in b]
            for ha, hb in zip(a, b):
                assert abs(ha.score - hb.score) < 1e-3

    def test_buffer_delete_and_upsert_semantics(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh

        rng = np.random.default_rng(1)
        base = rng.random((500, 16), dtype=np.float32)
        sh = ShardedIvfFlatIndex(16, "L2", mesh=make_mesh(4), nlist=8)
        sh.add_batch([str(i) for i in range(500)], base)
        sh.build()
        # streaming add lands in the buffer and is searchable
        fresh = rng.random(16).astype(np.float32)
        assert sh.add("fresh", fresh)
        assert sh.search(fresh, 1)[0].id == "fresh"
        # delete a built row
        assert sh.delete("42")
        hits = sh.search(base[42], 5, pt.SearchOptions(nprobe=8))
        assert all(h.id != "42" for h in hits)
        # compaction merges buffer into the sharded slab
        sh.build()
        assert sh.search(fresh, 1)[0].id == "fresh"

    def test_recall_parity(self):
        import numpy as np
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh
        from pyrope_tpu.utils.datasets import ground_truth, recall_at_k
        import pyrope_tpu as pt

        rng = np.random.default_rng(2)
        n, dim = 5000, 32
        base = rng.random((n, dim), dtype=np.float32)
        q = rng.random((16, dim), dtype=np.float32)
        sh = ShardedIvfFlatIndex(dim, "L2", mesh=make_mesh(8), nlist=16)
        sh.add_batch([str(i) for i in range(n)], base)
        sh.build()
        res = sh.search_batch(q, 10, pt.SearchOptions(nprobe=16))  # probe all
        truth = ground_truth(base, q, 10, "L2")
        rows = np.array([[int(h.id) for h in r] + [-1] * (10 - len(r)) for r in res])
        assert recall_at_k(rows, truth, 10) > 0.99  # all lists probed => exact


class TestShardedFlatSnapshot:
    def test_snapshot_load_roundtrip_preserves_mesh(self, tmp_path):
        import numpy as np
        from pyrope_tpu.parallel import ShardedFlatIndex, make_mesh

        mesh = make_mesh(4)
        idx = ShardedFlatIndex(8, "L2", mesh=mesh)
        rng = np.random.default_rng(0)
        vecs = rng.random((100, 8), dtype=np.float32)
        idx.add_batch([f"v{i}" for i in range(100)], vecs)
        p = str(tmp_path / "s.npz")
        idx.snapshot(p)
        idx.load(p)  # previously crashed: __init__-based reset
        assert idx.mesh is mesh  # caller-provided mesh preserved
        assert idx.get_stats().count == 100
        assert idx.search(vecs[5], 1)[0].id == "v5"


class TestShardedIvfPq:
    def test_matches_single_device_ivfpq(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfPqIndex, make_mesh

        rng = np.random.default_rng(0)
        n, dim = 3000, 32
        base = rng.random((n, dim), dtype=np.float32)
        ids = [str(i) for i in range(n)]
        q = rng.random((8, dim), dtype=np.float32)

        # refine=400 -> R covers the whole 3000-row corpus on both paths, so
        # the shortlists are complete and results must agree (a smaller R is
        # a per-shard ADVANTAGE for the sharded path: it ADC-shortlists per
        # shard and so covers more of the probed rows than one global top-R)
        ref = pt.IvfPqIndex(dim, "L2", nlist=8, pq_m=4, ksub=64, refine=400)
        ref.add_batch(ids, base)
        ref.build()
        sh = ShardedIvfPqIndex(dim, "L2", mesh=make_mesh(8), nlist=8, pq_m=4,
                               ksub=64, refine=400)
        sh.add_batch(ids, base)
        sh.build()
        opts = pt.SearchOptions(nprobe=8)
        r_ref = ref.search_batch(q, 10, opts)
        r_sh = sh.search_batch(q, 10, opts)
        for a, b in zip(r_ref, r_sh):
            # exact-rerank scores are computed over different gather widths
            # on the two paths, so fp ties may reorder; a position may hold
            # a different id ONLY when the two scores are a near-tie
            for ha, hb in zip(a, b):
                assert abs(ha.score - hb.score) < 1e-2
                if ha.id != hb.id:
                    assert abs(ha.score - hb.score) < 1e-3, (ha, hb)

    def test_buffer_and_delete(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfPqIndex, make_mesh

        rng = np.random.default_rng(1)
        base = rng.random((400, 16), dtype=np.float32)
        sh = ShardedIvfPqIndex(16, "L2", mesh=make_mesh(4), nlist=4, pq_m=4, ksub=32)
        sh.add_batch([str(i) for i in range(400)], base)
        sh.build()
        fresh = rng.random(16).astype(np.float32)
        assert sh.add("fresh", fresh)
        assert sh.search(fresh, 1)[0].id == "fresh"
        assert sh.delete("7")
        hits = sh.search(base[7], 5, pt.SearchOptions(nprobe=4))
        assert all(h.id != "7" for h in hits)


class TestShardedSnapshotRoundtrips:
    def test_sharded_ivf_snapshot_load(self, tmp_path):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh

        mesh = make_mesh(4)
        sh = ShardedIvfFlatIndex(16, "L2", mesh=mesh, nlist=4)
        rng = np.random.default_rng(3)
        base = rng.random((300, 16), dtype=np.float32)
        sh.add_batch([str(i) for i in range(300)], base)
        sh.build()
        p = str(tmp_path / "sivf.npz")
        sh.snapshot(p)
        sh.load(p)
        assert sh.mesh is mesh
        hits = sh.search(base[11], 3, pt.SearchOptions(nprobe=4))
        assert hits[0].id == "11"


class TestBatchDataMesh:
    def test_2d_mesh_matches_1d(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedFlatIndex, make_mesh
        from pyrope_tpu.parallel.mesh import make_mesh_2d

        rng = np.random.default_rng(0)
        n, dim = 2048, 16
        base = rng.random((n, dim), dtype=np.float32)
        ids = [str(i) for i in range(n)]
        q = rng.random((16, dim), dtype=np.float32)

        one_d = ShardedFlatIndex(dim, "L2", mesh=make_mesh(8))
        one_d.add_batch(ids, base)
        two_d = ShardedFlatIndex(dim, "L2", mesh=make_mesh_2d(2, 4))
        two_d.add_batch(ids, base)

        r1 = one_d.search_batch(q, 10)
        r2 = two_d.search_batch(q, 10)
        for a, b in zip(r1, r2):
            assert [h.id for h in a] == [h.id for h in b]


class TestShardedSq8:
    def test_matches_single_device_sq8(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedFlatIndex, make_mesh

        rng = np.random.default_rng(3)
        base = rng.random((2000, 32), dtype=np.float32)
        ids = [str(i) for i in range(2000)]
        q = rng.random((8, 32), dtype=np.float32)

        ref = pt.FlatIndex(32, "L2", storage="sq8")
        ref.add_batch(ids, base)
        sh = ShardedFlatIndex(32, "L2", mesh=make_mesh(8), storage="sq8")
        sh.add_batch(ids, base)
        for a, b in zip(ref.search_batch(q, 10), sh.search_batch(q, 10)):
            assert [h.id for h in a] == [h.id for h in b]
            for ha, hb in zip(a, b):
                assert abs(ha.score - hb.score) < 1e-2

    def test_sq8_delete_visibility(self):
        import numpy as np
        from pyrope_tpu.parallel import ShardedFlatIndex, make_mesh

        rng = np.random.default_rng(4)
        base = rng.random((300, 16), dtype=np.float32)
        sh = ShardedFlatIndex(16, "L2", mesh=make_mesh(4), storage="sq8")
        sh.add_batch([str(i) for i in range(300)], base)
        assert sh.search(base[7], 1)[0].id == "7"
        sh.delete("7")
        assert sh.search(base[7], 1)[0].id != "7"


class TestShardedHnsw:
    def test_matches_single_device_hnsw(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedHnswIndex, make_mesh
        from pyrope_tpu.types import SearchOptions

        rng = np.random.default_rng(5)
        base = rng.random((1500, 32), dtype=np.float32)
        ids = [str(i) for i in range(1500)]
        q = rng.random((16, 32), dtype=np.float32)

        ref = pt.HnswIndex(32, "L2", m=8, ef_construction=100, ef_search=32, seed=11)
        ref.add_batch(ids, base)
        sh = ShardedHnswIndex(
            32, "L2", mesh=make_mesh(8), m=8, ef_construction=100,
            ef_search=32, seed=11,
        )
        sh.add_batch(ids, base)
        opts = SearchOptions(ef_search=32)
        # identical graph (same seed) + identical beam program per query
        # slice -> identical results
        for a, b in zip(ref.search_batch(q, 10, opts), sh.search_batch(q, 10, opts)):
            assert [h.id for h in a] == [h.id for h in b]
            for ha, hb in zip(a, b):
                assert abs(ha.score - hb.score) < 1e-4

    def test_ragged_batch_pads(self):
        import numpy as np
        from pyrope_tpu.parallel import ShardedHnswIndex, make_mesh

        rng = np.random.default_rng(6)
        base = rng.random((500, 16), dtype=np.float32)
        sh = ShardedHnswIndex(16, "L2", mesh=make_mesh(8), m=8)
        sh.add_batch([str(i) for i in range(500)], base)
        res = sh.search_batch(rng.random((5, 16), dtype=np.float32), 3)
        assert len(res) == 5 and all(len(r) <= 3 for r in res)


class TestShardedDelta:
    def test_delta_composes_sharded_halves(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import (
            ShardedFlatIndex,
            ShardedIvfPqIndex,
            make_mesh,
        )

        rng = np.random.default_rng(7)
        base = rng.random((1200, 32), dtype=np.float32)
        mesh = make_mesh(8)
        delta = pt.DeltaIndex(
            ShardedFlatIndex(32, "L2", mesh=mesh),
            ShardedIvfPqIndex(32, "L2", mesh=mesh, nlist=8, pq_m=4, ksub=64),
        )
        delta.add_batch([str(i) for i in range(1000)], base[:1000])
        delta.build()  # compaction: head -> sharded tail
        # post-compaction streaming adds land in the sharded head
        delta.add_batch([str(i) for i in range(1000, 1200)], base[1000:])
        assert delta.get_stats().count == 1200
        hit = delta.search(base[1100], 1)[0]
        assert hit.id == "1100"
        hit = delta.search(base[50], 3, pt.SearchOptions(nprobe=8))
        assert "50" in [h.id for h in hit]


class TestTwoDMeshIvf:
    def test_2d_batch_data_mesh_matches_1d(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh, make_mesh_2d

        rng = np.random.default_rng(8)
        base = rng.random((2000, 32), dtype=np.float32)
        ids = [str(i) for i in range(2000)]
        q = rng.random((8, 32), dtype=np.float32)
        opts = pt.SearchOptions(nprobe=8)

        one_d = ShardedIvfFlatIndex(32, "L2", mesh=make_mesh(4), nlist=8)
        one_d.add_batch(ids, base)
        one_d.build()
        two_d = ShardedIvfFlatIndex(32, "L2", mesh=make_mesh_2d(2, 4), nlist=8)
        two_d.add_batch(ids, base)
        two_d.build()
        for a, b in zip(one_d.search_batch(q, 10, opts), two_d.search_batch(q, 10, opts)):
            assert [h.id for h in a] == [h.id for h in b]
            for ha, hb in zip(a, b):
                assert abs(ha.score - hb.score) < 1e-3


class TestTwoDMeshIvfPq:
    def test_2d_batch_data_mesh_matches_1d(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfPqIndex, make_mesh, make_mesh_2d

        rng = np.random.default_rng(9)
        base = rng.random((2000, 32), dtype=np.float32)
        ids = [str(i) for i in range(2000)]
        q = rng.random((8, 32), dtype=np.float32)
        opts = pt.SearchOptions(nprobe=8)

        kw = dict(nlist=8, pq_m=4, ksub=16, refine=8)
        one_d = ShardedIvfPqIndex(32, "L2", mesh=make_mesh(4), **kw)
        one_d.add_batch(ids, base)
        one_d.build()
        two_d = ShardedIvfPqIndex(32, "L2", mesh=make_mesh_2d(2, 4), **kw)
        two_d.add_batch(ids, base)
        two_d.build()
        for a, b in zip(one_d.search_batch(q, 10, opts),
                        two_d.search_batch(q, 10, opts)):
            assert [h.id for h in a] == [h.id for h in b]
            for ha, hb in zip(a, b):
                assert abs(ha.score - hb.score) < 1e-3


class TestShardedDenseScan:
    """Both sharded scan kernels (dense full-matmul-masked and sparse
    probe-sliced) must match the single-chip index per mode."""

    def _data(self, n=3000, dim=16, nq=6, seed=3):
        rng = np.random.default_rng(seed)
        base = rng.random((n, dim), dtype=np.float32)
        q = rng.random((nq, dim), dtype=np.float32)
        return base, [str(i) for i in range(n)], q

    @pytest.mark.parametrize("mode", ["dense", "probe"])
    def test_sharded_ivf_mode_matches_single(self, mode):
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh

        base, ids, q = self._data()
        ref = pt.IvfFlatIndex(16, "L2", nlist=12, scan_mode=mode)
        ref.add_batch(ids, base)
        ref.build()
        sh = ShardedIvfFlatIndex(16, "L2", mesh=make_mesh(8), nlist=12,
                                 scan_mode=mode)
        sh.add_batch(ids, base)
        sh.build()
        for nprobe in (2, 12):
            opts = pt.SearchOptions(nprobe=nprobe)
            for a, b in zip(ref.search_batch(q, 10, opts),
                            sh.search_batch(q, 10, opts)):
                assert [h.id for h in a] == [h.id for h in b]

    @pytest.mark.parametrize("mode", ["dense", "probe"])
    def test_sharded_ivf_max_scans_local_budget(self, mode):
        """max_scans splits across shards (ceil(ms/ndev) per shard); dense
        and probe sharded kernels must agree with each other."""
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh

        base, ids, q = self._data(seed=4)
        out = {}
        for m in ("dense", "probe"):
            sh = ShardedIvfFlatIndex(16, "L2", mesh=make_mesh(8), nlist=12,
                                     scan_mode=m)
            sh.add_batch(ids, base)
            sh.build()
            opts = pt.SearchOptions(nprobe=12, max_scans=160)
            out[m] = [[h.id for h in hits]
                      for hits in sh.search_batch(q, 10, opts)]
        assert out["dense"] == out["probe"]

    @pytest.mark.parametrize("refine", [0, 8])
    def test_sharded_ivfpq_dense_matches_probe(self, refine):
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfPqIndex, make_mesh

        base, ids, q = self._data(n=2600, seed=5)
        res = {}
        for m in ("dense", "probe"):
            sh = ShardedIvfPqIndex(16, "L2", mesh=make_mesh(8), nlist=8,
                                   pq_m=4, ksub=16, refine=refine, scan_mode=m)
            sh.add_batch(ids, base)
            sh.build()
            res[m] = sh.search_batch(q, 10, pt.SearchOptions(nprobe=4))
        for d_hits, p_hits in zip(res["dense"], res["probe"]):
            d_ids, p_ids = {h.id for h in d_hits}, {h.id for h in p_hits}
            assert len(d_ids & p_ids) / max(len(p_ids), 1) >= 0.8
            for dh, ph in zip(d_hits, p_hits):
                if refine > 0:
                    assert dh.score >= ph.score - 1e-3  # dense exact-scan dominates
                else:
                    assert dh.score == pytest.approx(ph.score, rel=1e-4, abs=1e-3)

    def test_sharded_ivfpq_dense_matches_single_chip(self):
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfPqIndex, make_mesh

        base, ids, q = self._data(n=2600, seed=6)
        ref = pt.IvfPqIndex(16, "L2", nlist=8, pq_m=4, ksub=16, refine=8,
                            scan_mode="dense")
        ref.add_batch(ids, base)
        ref.build()
        sh = ShardedIvfPqIndex(16, "L2", mesh=make_mesh(8), nlist=8,
                               pq_m=4, ksub=16, refine=8, scan_mode="dense")
        sh.add_batch(ids, base)
        sh.build()
        opts = pt.SearchOptions(nprobe=8)
        for a, b in zip(ref.search_batch(q, 10, opts),
                        sh.search_batch(q, 10, opts)):
            a_ids, b_ids = {h.id for h in a}, {h.id for h in b}
            assert len(a_ids & b_ids) / max(len(a_ids), 1) >= 0.9


class TestShardedPallasDense:
    """The sharded dense scan (the XLA dense kernel per shard, for narrow
    and wide cluster tables, with or without a max_scans budget) returns
    the same hit sets as the single-device index."""

    def test_narrow_path_and_parity(self):
        from pyrope_tpu.index.ivf_flat import IvfFlatIndex
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh

        base = synthetic(4096, 32)
        ids = [str(i) for i in range(4096)]
        sh = ShardedIvfFlatIndex(32, "L2", mesh=make_mesh(8), nlist=16,
                                 nprobe=8)
        sh.add_batch(ids, base)
        sh.build()
        assert sh.describe_scan(64, 8) == "dense-xla"
        assert sh.describe_scan(64, 8, max_scans=100) == "dense-xla"

        ref = IvfFlatIndex(32, "L2", nlist=16, nprobe=8)
        ref.add_batch(ids, base)
        ref.build()
        q = synthetic(64, 32)
        a = sh.search_batch(q, 10)
        b = ref.search_batch(q, 10)
        for i in range(64):
            assert [h.id for h in a[i]] == [h.id for h in b[i]]

    def test_windowed_path_and_parity(self):
        """A wide cluster table (nlist=640) with 16k-row shards (131k rows)
        on the per-shard dense kernel."""
        from pyrope_tpu.index.ivf_flat import IvfFlatIndex
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh

        n = 131072
        base = synthetic(n, 16)
        ids = [str(i) for i in range(n)]
        sh = ShardedIvfFlatIndex(16, "L2", mesh=make_mesh(8), nlist=640,
                                 nprobe=64)
        sh.add_batch(ids, base)
        sh.build()
        assert sh.describe_scan(64, 64) == "dense-xla"
        ref = IvfFlatIndex(16, "L2", nlist=640, nprobe=64)
        ref.add_batch(ids, base)
        ref.build()
        q = synthetic(64, 16)
        a = sh.search_batch(q, 10)
        b = ref.search_batch(q, 10)
        ov = np.mean(
            [len({h.id for h in a[i]} & {h.id for h in b[i]}) / 10
             for i in range(64)]
        )
        assert ov == 1.0, ov


def test_sharded_ivfpq_pallas_exact_scan_parity():
    """The sharded IVF-PQ refine>0 dense path exact-scans the per-shard
    rerank slab with the same hit sets as the single-device index, with
    or without a max_scans budget."""
    from pyrope_tpu.index.ivf_pq import IvfPqIndex
    from pyrope_tpu.parallel import make_mesh
    from pyrope_tpu.parallel.sharded_ivf_pq import ShardedIvfPqIndex

    base = synthetic(4096, 32)
    ids = [str(i) for i in range(4096)]
    sh = ShardedIvfPqIndex(32, "L2", mesh=make_mesh(8), nlist=16, pq_m=4,
                           ksub=64, nprobe=8, refine=16)
    sh.add_batch(ids, base)
    sh.build()
    assert sh.describe_scan(64, 8) == "dense-exact-xla"
    assert sh.describe_scan(64, 8, max_scans=100) == "dense-exact-xla"
    ref = IvfPqIndex(32, "L2", nlist=16, pq_m=4, ksub=64, nprobe=8,
                     refine=16)
    ref.add_batch(ids, base)
    ref.build()
    q = synthetic(64, 32)
    a = sh.search_batch(q, 10)
    b = ref.search_batch(q, 10)
    for i in range(64):
        assert {h.id for h in a[i]} == {h.id for h in b[i]}


def test_sharded_flat_pallas_parity_and_budget_rebase():
    """The sharded exact scan matches the single-device index; the global
    max_scans budget is rebased to each shard's block (shard s owns rows
    [s*L, (s+1)*L)), matching the first-ms-slab-rows semantics exactly.
    selection='pallas' is no longer a selection."""
    from pyrope_tpu.parallel import ShardedFlatIndex, make_mesh

    base = synthetic(5000, 32)
    ids = [str(i) for i in range(5000)]
    with pytest.raises(ValueError):
        ShardedFlatIndex(32, "L2", mesh=make_mesh(8), selection="pallas")
    sh = ShardedFlatIndex(32, "L2", mesh=make_mesh(8))
    sh.add_batch(ids, base)
    ref = FlatIndex(32, "L2")
    ref.add_batch(ids, base)
    q = synthetic(64, 32)
    a = sh.search_batch(q, 10)
    b = ref.search_batch(q, 10)
    for i in range(64):
        assert [h.id for h in a[i]] == [h.id for h in b[i]]
    a2 = sh.search_batch(q, 10, SearchOptions(max_scans=700))
    b2 = ref.search_batch(q, 10, SearchOptions(max_scans=700))
    for i in range(64):
        assert [h.id for h in a2[i]] == [h.id for h in b2[i]]
    for h in a[0][:3]:
        assert sh.delete(h.id)
    a3 = sh.search_batch(q[:8], 10)
    assert not ({h.id for h in a3[0]} & {h.id for h in a[0][:3]})


class TestClusterShardedIvf:
    """shard_by='cluster' (VERDICT r3 #6): whole lists per shard, probes
    routed to owners. Parity vs single-device on both kernels + LPT slab
    balance under Zipf cluster-size skew."""

    def _pair(self, n=4000, dim=32, nlist=16, zipf=False, **kw):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh
        from pyrope_tpu.utils.datasets import synthetic_zipf

        rng = np.random.default_rng(3)
        base = (synthetic_zipf(n, dim, n_clusters=nlist) if zipf
                else rng.random((n, dim), dtype=np.float32))
        ids = [str(i) for i in range(n)]
        ref = pt.IvfFlatIndex(dim, "L2", nlist=nlist,
                              scan_mode=kw.get("scan_mode", "auto"))
        ref.add_batch(ids, base)
        ref.build()
        sh = ShardedIvfFlatIndex(dim, "L2", mesh=make_mesh(8), nlist=nlist,
                                 shard_by="cluster", **kw)
        sh.add_batch(ids, base)
        sh.build()
        return ref, sh, base, rng

    def _assert_match(self, ref, sh, q, k, opts):
        r_ref = ref.search_batch(q, k, opts)
        r_sh = sh.search_batch(q, k, opts)
        for a, b in zip(r_ref, r_sh):
            assert [h.id for h in a] == [h.id for h in b]
            for ha, hb in zip(a, b):
                assert abs(ha.score - hb.score) < 1e-3

    def test_cluster_probe_matches_single_device(self):
        import pyrope_tpu as pt

        ref, sh, base, rng = self._pair(scan_mode="probe")
        q = rng.random((8, 32), dtype=np.float32)
        self._assert_match(ref, sh, q, 10, pt.SearchOptions(nprobe=8))

    def test_cluster_probe_no_drop_cap(self):
        import pyrope_tpu as pt

        # probe_cap = nprobe: every owned probe fits — exact parity even if
        # one shard owned every probed list
        ref, sh, base, rng = self._pair(scan_mode="probe", probe_cap=8)
        q = rng.random((8, 32), dtype=np.float32)
        self._assert_match(ref, sh, q, 10, pt.SearchOptions(nprobe=8))

    def test_cluster_dense_matches_single_device(self):
        import pyrope_tpu as pt

        ref, sh, base, rng = self._pair(scan_mode="dense")
        q = rng.random((8, 32), dtype=np.float32)
        self._assert_match(ref, sh, q, 10, pt.SearchOptions(nprobe=8))

    def test_cluster_lpt_balance_under_zipf(self):
        import numpy as np

        # Zipf sizes: largest natural cluster ~ n/H(K); greedy LPT must
        # still balance per-shard slab populations
        _, sh, _, _ = self._pair(n=8000, nlist=32, zipf=True)
        dev = sh._sync()
        per_shard = np.asarray(dev["lens"]).sum(axis=1).astype(float)
        assert per_shard.max() <= 1.3 * per_shard.mean()
        # ownership is a partition: every list has exactly one owner
        lens_g = np.asarray(dev["lens"]).sum(axis=0)
        owner = np.asarray(dev["owner"])
        assert owner.shape[0] == lens_g.shape[0]

    def test_cluster_validation(self):
        import pytest
        from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh

        with pytest.raises(ValueError, match="shard_by"):
            ShardedIvfFlatIndex(8, "L2", mesh=make_mesh(4), shard_by="bogus")


class TestMultisliceMesh:
    """Multi-slice (slice × data) meshes — SURVEY §5.8's DCN dimension.
    Rows shard over both axes; the merge runs ICI-within-slice first, then
    one [B, k] list per slice crosses the slice axis. Multi-slice is a mesh
    shape, not a new index class."""

    def _mesh(self, n_slices=2, per_slice=4):
        from pyrope_tpu.parallel import make_mesh_multislice

        return make_mesh_multislice(n_slices, per_slice)

    def test_mesh_axes_and_row_shards(self):
        from pyrope_tpu.parallel.mesh import row_axes, row_shard_count

        mesh = self._mesh()
        assert mesh.axis_names == ("slice", "data")
        assert row_axes(mesh) == ("slice", "data")
        assert row_shard_count(mesh) == 8
        assert row_shard_count(make_mesh()) == 8

    def test_multislice_flat_matches_single_device(self):
        base = synthetic(2000, 32)
        q = synthetic(16, 32, seed=5)
        ref = FlatIndex(32)
        ref.add_batch([str(i) for i in range(2000)], base)
        sh = ShardedFlatIndex(32, mesh=self._mesh())
        sh.add_batch([str(i) for i in range(2000)], base)
        r1 = ref.search_batch(q, 10)
        r2 = sh.search_batch(q, 10)
        for a, b in zip(r1, r2):
            assert [h.id for h in a] == [h.id for h in b]
            np.testing.assert_allclose(
                [h.score for h in a], [h.score for h in b], rtol=1e-5, atol=1e-5
            )

    def test_multislice_maxscans_and_delete(self):
        base = synthetic(512, 16)
        sh = ShardedFlatIndex(16, mesh=self._mesh(4, 2))
        sh.add_batch([str(i) for i in range(512)], base)
        sh.delete("100")
        hits = sh.search(base[100], 5)
        assert all(h.id != "100" for h in hits)
        # global max_scans budget crosses slice boundaries correctly
        hits = sh.search(base[400], 3, SearchOptions(max_scans=50))
        assert all(int(h.id) < 50 for h in hits)

    def test_multislice_sq8(self):
        base = synthetic(600, 16)
        ref = FlatIndex(16, storage="sq8")
        sh = ShardedFlatIndex(16, storage="sq8", mesh=self._mesh())
        for ix in (ref, sh):
            ix.add_batch([str(i) for i in range(600)], base)
        q = synthetic(4, 16, seed=3)
        a = ref.search_batch(q, 5)
        b = sh.search_batch(q, 5)
        for x, y in zip(a, b):
            assert [h.id for h in x] == [h.id for h in y]

    def test_multislice_pallas_matches_exact(self):
        n, d = 4096, 32  # 512 rows/shard
        base = synthetic(n, d)
        ref = FlatIndex(d, selection="exact")
        sh = ShardedFlatIndex(d, selection="exact", mesh=self._mesh())
        for ix in (ref, sh):
            ix.add_batch([str(i) for i in range(n)], base)
        assert sh._sharded_fn(10, 8)[1] == "xla"
        q = synthetic(8, d, seed=9)
        a = ref.search_batch(q, 10)
        b = sh.search_batch(q, 10)
        for x, y in zip(a, b):
            assert [h.id for h in x] == [h.id for h in y]

    def test_multislice_kmeans_step_matches_1d(self):
        from jax.sharding import NamedSharding
        from pyrope_tpu.parallel.mesh import row_axes

        rng = np.random.default_rng(0)
        x = rng.random((512, 16)).astype(np.float32)
        valid = np.ones(512, bool)
        cents = x[:8].copy()
        mesh1 = make_mesh()
        mesh2 = self._mesh()
        out = []
        for mesh in (mesh1, mesh2):
            sh = NamedSharding(mesh, P(row_axes(mesh), None))
            vh = NamedSharding(mesh, P(row_axes(mesh)))
            c = sharded_kmeans_step(
                jax.device_put(jnp.asarray(x), sh),
                jax.device_put(jnp.asarray(valid), vh),
                jnp.asarray(cents), metric=Metric.L2, mesh=mesh,
            )
            out.append(np.asarray(c))
        np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-6)


class TestShardedHnswCorpus:
    """Corpus-sharded HNSW (VERDICT r4 #7): per-shard k-means cell
    sub-graphs, graph memory scales with the mesh; recall parity vs the
    replicated single graph on the 8-device CPU mesh."""

    def _clustered(self, n=4000, dim=32, nc=16):
        from pyrope_tpu.utils.datasets import (
            synthetic_clustered,
            synthetic_clustered_queries,
        )

        return (synthetic_clustered(n, dim, n_clusters=nc),
                synthetic_clustered_queries(32, dim, n_clusters=nc))

    def test_recall_parity_vs_replicated(self):
        import numpy as np
        import pyrope_tpu as pt
        from pyrope_tpu.parallel import ShardedHnswCorpusIndex, make_mesh
        from pyrope_tpu.types import SearchOptions
        from pyrope_tpu.utils.datasets import (
            ground_truth,
            id_lists_to_rows,
            recall_at_k,
        )

        base, q = self._clustered()
        ids = [str(i) for i in range(len(base))]
        truth = ground_truth(base, q, 10, "L2")
        opts = SearchOptions(ef_search=64)

        ref = pt.HnswIndex(32, "L2", m=8, ef_construction=100, seed=11)
        ref.add_batch(ids, base)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=make_mesh(8), m=8,
                                    ef_construction=100, seed=11)
        sh.add_batch(ids, base)
        sh.build()

        def rec(ix):
            res = ix.search_batch(q, 10, opts)
            return recall_at_k(
                id_lists_to_rows([[h.id for h in r] for r in res]), truth, 10)

        r_ref, r_sh = rec(ref), rec(sh)
        # partitioned sub-graphs search every cell with a full-width beam:
        # recall must hold parity with the replicated single graph
        assert r_sh >= r_ref - 0.02, (r_sh, r_ref)
        assert r_sh >= 0.9, r_sh

    def test_graph_memory_shards_over_mesh(self):
        import numpy as np
        from pyrope_tpu.parallel import ShardedHnswCorpusIndex, make_mesh

        base, q = self._clustered(n=2000)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=make_mesh(8), m=8)
        sh.add_batch([str(i) for i in range(len(base))], base)
        sh.build()
        sh.search_batch(q[:4], 5)
        mem = sh.memory_bytes()
        assert mem["graph_per_device"] * 8 == mem["graph_total"]
        # every stacked graph array is actually sharded over the mesh
        for key in ("x", "adj0", "adj_up", "alive"):
            arr = sh._dev[key]
            assert len(arr.sharding.device_set) == 8, key
        # capacity balance: no shard holds more than ceil(n/nd) rows
        counts = [s.get_stats().count for s in sh._subs]
        assert max(counts) <= -(-2000 // 8), counts

    def test_delete_and_post_build_add(self):
        import numpy as np
        from pyrope_tpu.parallel import ShardedHnswCorpusIndex, make_mesh
        from pyrope_tpu.types import SearchOptions

        base, _ = self._clustered(n=1000)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=make_mesh(8), m=8)
        sh.add_batch([str(i) for i in range(1000)], base)
        sh.build()
        opts = SearchOptions(ef_search=48)
        assert sh.search(base[7], 1, opts)[0].id == "7"
        assert sh.delete("7")
        assert all(h.id != "7" for h in sh.search(base[7], 10, opts))
        # post-build add routes to a shard's incremental insert
        nv = base[7] + 0.001
        assert sh.add("new", nv)
        assert sh.search(nv, 1, opts)[0].id == "new"
        assert sh.get_stats().count == 1000  # 1000 - 1 + 1

    def test_snapshot_roundtrip(self, tmp_path):
        import numpy as np
        from pyrope_tpu.parallel import ShardedHnswCorpusIndex, make_mesh
        from pyrope_tpu.types import SearchOptions

        base, q = self._clustered(n=800)
        mesh = make_mesh(8)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=mesh, m=8)
        sh.add_batch([str(i) for i in range(800)], base)
        sh.build()
        p = str(tmp_path / "shnsw.json")
        sh.snapshot(p)
        fresh = ShardedHnswCorpusIndex(32, "L2", mesh=mesh, m=8)
        fresh.load(p)
        opts = SearchOptions(ef_search=48)
        a = [[h.id for h in r] for r in sh.search_batch(q[:8], 5, opts)]
        b = [[h.id for h in r] for r in fresh.search_batch(q[:8], 5, opts)]
        assert a == b
