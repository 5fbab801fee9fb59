"""DeviceFlatIndex (frozen device-resident slab) + chunked exact top-k.

The device-resident path exists for corpora past the host-slab wall
(bench.py DEVICE_CONFIGS, 10M x 128); these tests verify its semantics at
small N on the CPU backend: parity with FlatIndex, the frozen contract,
implicit ids, COSINE normalize-at-ingest, snapshot interop with the
mutable family, and the chunked ground-truth helper it is verified by.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pyrope_tpu import DeviceFlatIndex, FlatIndex, Metric, SearchOptions
from pyrope_tpu.ops.topk import chunked_exact_topk
from pyrope_tpu.utils.datasets import ground_truth


def make_corpus(n=60, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim)).astype(np.float32)


def test_parity_with_flat_index():
    vecs = make_corpus()
    q = make_corpus(n=8, dim=16, seed=1)
    host = FlatIndex(16, "L2")
    host.add_batch([str(i) for i in range(len(vecs))], vecs)
    dev = DeviceFlatIndex(jnp.asarray(vecs), "L2", selection="exact")
    h_hits = host.search_batch(q, 5)
    d_hits = dev.search_batch(q, 5)
    for hrow, drow in zip(h_hits, d_hits):
        assert [h.id for h in hrow] == [d.id for d in drow]
        for h, d in zip(hrow, drow):
            assert h.score == pytest.approx(d.score, rel=1e-5, abs=1e-5)


def test_pallas_selection_matches_ground_truth():
    """The default selection (the XLA exact scan) matches brute-force
    ground truth; 'pallas' and 'hybrid' are not selections of this index."""
    vecs = make_corpus(n=100)
    q = make_corpus(n=4, dim=16, seed=2)
    for bad in ("pallas", "hybrid"):
        with pytest.raises(ValueError):
            DeviceFlatIndex(jnp.asarray(vecs), "L2", selection=bad)
    dev = DeviceFlatIndex(jnp.asarray(vecs), "L2")
    truth = ground_truth(vecs, q, 5)
    hits = dev.search_batch(q, 5)
    got = np.array([[int(h.id) for h in row] for row in hits])
    assert (got == truth).all()


def test_numpy_input_uploaded():
    vecs = make_corpus(n=20)
    dev = DeviceFlatIndex(vecs, "L2", selection="exact")
    hits = dev.search(vecs[7], 1)
    assert hits[0].id == "7"
    assert hits[0].score == pytest.approx(0.0, abs=1e-3)


def test_n_valid_masks_padding_tail():
    vecs = make_corpus(n=32)
    padded = np.concatenate([vecs, np.zeros((8, 16), np.float32)])
    dev = DeviceFlatIndex(jnp.asarray(padded), "L2", n_valid=32,
                          selection="exact")
    # a zero query would otherwise hit the zero pad rows at distance 0
    hits = dev.search(np.zeros(16, np.float32), 40)
    assert len(hits) == 32
    assert all(int(h.id) < 32 for h in hits)
    assert len(dev) == 32


def test_frozen_mutation_raises():
    dev = DeviceFlatIndex(make_corpus(n=10), "L2")
    with pytest.raises(RuntimeError, match="frozen"):
        dev.add("x", np.zeros(16, np.float32))
    with pytest.raises(RuntimeError, match="frozen"):
        dev.upsert("0", np.zeros(16, np.float32))
    with pytest.raises(RuntimeError, match="frozen"):
        dev.delete("0")


def test_explicit_ids_and_scan():
    vecs = make_corpus(n=6)
    ids = [f"doc-{i}" for i in range(6)]
    dev = DeviceFlatIndex(vecs, "L2", ids=ids, selection="exact")
    hits = dev.search(vecs[3], 1)
    assert hits[0].id == "doc-3"
    scanned = dict(dev.scan())
    assert set(scanned) == set(ids)
    np.testing.assert_allclose(scanned["doc-2"], vecs[2], rtol=1e-6)


def test_cosine_normalizes_at_ingest():
    vecs = make_corpus(n=30, dim=12)
    q = make_corpus(n=1, dim=12, seed=3)[0]
    dev = DeviceFlatIndex(vecs, "COSINE", selection="exact")
    hits = dev.search(q, 5)
    cos = (vecs @ q) / (
        np.linalg.norm(vecs, axis=1) * np.linalg.norm(q)
    )
    order = np.argsort(-cos)[:5]
    assert [int(h.id) for h in hits] == [int(i) for i in order]
    for h, i in zip(hits, order):
        assert h.score == pytest.approx(float(cos[i]), rel=1e-3, abs=1e-3)


def test_max_scans_budget():
    vecs = make_corpus(n=50)
    dev = DeviceFlatIndex(vecs, "L2", selection="exact")
    q = vecs[40]
    hits = dev.search(q, 1, SearchOptions(max_scans=10))
    # row 40 is beyond the scan budget: the best hit must come from rows <10
    assert int(hits[0].id) < 10


def test_snapshot_roundtrip_into_flat_index(tmp_path):
    vecs = make_corpus(n=25)
    dev = DeviceFlatIndex(vecs, "L2", selection="exact")
    path = str(tmp_path / "snap.npz")
    dev.snapshot(path)
    host = FlatIndex(16, "L2")
    host.load(path)
    q = make_corpus(n=3, dim=16, seed=4)
    for hrow, drow in zip(host.search_batch(q, 5), dev.search_batch(q, 5)):
        assert [h.id for h in hrow] == [d.id for d in drow]


def test_device_load_roundtrip(tmp_path):
    vecs = make_corpus(n=25)
    dev = DeviceFlatIndex(vecs, "L2", selection="exact")
    path = str(tmp_path / "snap.npz")
    dev.snapshot(path)
    dev2 = DeviceFlatIndex(np.zeros((4, 16), np.float32), "L2",
                           selection="exact")
    dev2.load(path)
    q = make_corpus(n=3, dim=16, seed=5)
    for a, b in zip(dev.search_batch(q, 5), dev2.search_batch(q, 5)):
        assert [h.id for h in a] == [h.id for h in b]


def test_device_load_keeps_implicit_ids(tmp_path):
    # implicit-id snapshots must reload WITHOUT materializing the explicit
    # id list / _id_to_row dict (~0.6 GB at 10M rows — ADVICE r3)
    vecs = make_corpus(n=25)
    dev = DeviceFlatIndex(vecs, "L2", selection="exact")
    assert dev._row_ids is None
    path = str(tmp_path / "snap.npz")
    dev.snapshot(path)
    dev2 = DeviceFlatIndex(np.zeros((4, 16), np.float32), "L2",
                           selection="exact")
    dev2.load(path)
    assert dev2._row_ids is None and dev2._id_to_row is None
    hits = dev2.search(vecs[7], 1)
    assert hits[0].id == "7"
    # explicit-id snapshots keep their ids through load
    dev3 = DeviceFlatIndex(vecs, "L2", ids=[f"d{i}" for i in range(25)],
                           selection="exact")
    path2 = str(tmp_path / "snap2.npz")
    dev3.snapshot(path2)
    dev4 = DeviceFlatIndex(np.zeros((4, 16), np.float32), "L2",
                           selection="exact")
    dev4.load(path2)
    assert dev4.search(vecs[7], 1)[0].id == "d7"


def test_stats_and_memory():
    dev = DeviceFlatIndex(make_corpus(n=40), "L2")
    st = dev.get_stats()
    assert st.count == 40 and st.dim == 16 and st.metric == Metric.L2
    assert dev.memory_bytes() > 0
    assert dev.describe_scan() == "device-exact"


def test_bad_inputs():
    vecs = make_corpus(n=10)
    with pytest.raises(ValueError, match="n_valid"):
        DeviceFlatIndex(vecs, "L2", n_valid=11)
    with pytest.raises(ValueError, match="ids"):
        DeviceFlatIndex(vecs, "L2", ids=["a"])
    with pytest.raises(ValueError, match="duplicate"):
        DeviceFlatIndex(vecs, "L2", ids=["a"] * 10)
    with pytest.raises(ValueError, match="dtype"):
        DeviceFlatIndex(jnp.asarray(vecs, jnp.int32), "L2")


# ---- chunked exact ground truth -------------------------------------------


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_chunked_exact_topk_matches_host(metric):
    vecs = make_corpus(n=300, dim=8)
    q = make_corpus(n=7, dim=8, seed=6)
    x = jnp.asarray(vecs)
    sq = jnp.sum(x * x, axis=-1)
    alive = jnp.ones(300, bool)
    vals, idx = chunked_exact_topk(x, sq, alive, jnp.asarray(q), 10, metric,
                                   chunk_rows=64)
    truth = ground_truth(vecs, q, 10, metric)
    assert (idx == truth).all()
    # one-shot (single chunk) must agree with the chunked merge
    v1, i1 = chunked_exact_topk(x, sq, alive, jnp.asarray(q), 10, metric,
                                chunk_rows=1024)
    assert (i1 == idx).all()
    np.testing.assert_allclose(v1, vals, rtol=1e-5, atol=1e-5)


def test_chunked_exact_topk_short_tail_chunk():
    # n % chunk_rows < k leaves a tail chunk with fewer rows than k:
    # lax.top_k requires k <= row count, so the per-chunk k must clamp to
    # the chunk's size (ADVICE r3 — latent crash, e.g. n=1_048_577 with
    # chunk_rows=1<<20 leaves a 1-row tail at k=10)
    vecs = make_corpus(n=130, dim=8)
    q = make_corpus(n=3, dim=8, seed=7)
    x = jnp.asarray(vecs)
    sq = jnp.sum(x * x, axis=-1)
    alive = jnp.ones(130, bool)
    vals, idx = chunked_exact_topk(x, sq, alive, jnp.asarray(q), 10, "L2",
                                   chunk_rows=128)  # tail chunk = 2 rows
    truth = ground_truth(vecs, q, 10, "L2")
    assert (idx == truth).all()
    assert np.isfinite(np.asarray(vals)).all()


def test_chunked_exact_topk_respects_alive_mask():
    vecs = make_corpus(n=50, dim=8)
    q = vecs[45:46]
    x = jnp.asarray(vecs)
    sq = jnp.sum(x * x, axis=-1)
    alive = jnp.asarray(np.arange(50) < 40)
    _, idx = chunked_exact_topk(x, sq, alive, jnp.asarray(q), 5, "L2",
                                chunk_rows=16)
    assert (idx[idx >= 0] < 40).all()
