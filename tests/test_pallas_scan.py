"""Fused scan+top-k kernel (interpret mode on the CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyrope_tpu.ops import pallas_scan
from pyrope_tpu.ops.pallas_scan import pallas_flat_topk, pallas_ivf_topk
from pyrope_tpu.types import Metric


def ref_topk(q, x, sq, alive, ms, k, metric):
    dots = q @ x.T
    if metric == Metric.L2:
        scores = -np.maximum((q * q).sum(1)[:, None] - 2 * dots + sq[None, :], 0)
    else:
        scores = dots
    mask = alive & (np.arange(x.shape[0]) < ms)
    scores = np.where(mask[None, :], scores, -np.inf)
    idx = np.argsort(-scores, axis=1)[:, :k]
    return scores, idx


def _flat(q, x, sq, alive, ms, k, metric=Metric.L2):
    vals, idx = pallas_flat_topk(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq), jnp.asarray(alive),
        ms, k=k, metric=metric,
    )
    return np.asarray(vals), np.asarray(idx)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_exact_vs_numpy(metric):
    rng = np.random.default_rng(0)
    n, b, d, k = 4096, 64, 32, 10
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    alive[7:50] = False
    ms = 4000
    vals, idx = _flat(q, x, sq, alive, ms, k, metric)
    scores, ref_idx = ref_topk(q, x, sq, alive, ms, k, metric)
    for bi in range(b):
        assert set(idx[bi]) == set(ref_idx[bi])
    assert np.allclose(vals, np.take_along_axis(scores, idx, axis=1),
                       rtol=1e-4, atol=1e-4)


def test_fewer_live_than_k_reports_minus_one():
    rng = np.random.default_rng(1)
    n, b, d, k = 1024, 64, 16, 10
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.zeros(n, bool)
    alive[:3] = True  # only 3 live rows
    vals, idx = _flat(q, x, sq, alive, n, k)
    assert set(idx[0][:3]) == {0, 1, 2}
    assert all(i == -1 for i in idx[0][3:])
    assert np.isneginf(vals[:, 3:]).all()


def test_shape_validation():
    with pytest.raises(ValueError):  # cosine callers pre-normalize + IP
        pallas_flat_topk(
            jnp.zeros((64, 8)), jnp.zeros((1024, 8)), jnp.zeros(1024),
            jnp.ones(1024, bool), 1024, k=5, metric=Metric.COSINE,
        )
    with pytest.raises(ValueError):  # query width != slab width
        pallas_flat_topk(
            jnp.zeros((64, 8)), jnp.zeros((1024, 16)), jnp.zeros(1024),
            jnp.ones(1024, bool), 1024, k=5, metric=Metric.L2,
        )


def test_flat_index_pallas_selection():
    """FlatIndex reaches the kernel through selection='hybrid' (bf16 scan,
    fp32 rerank); 'pallas' is no longer a selection."""
    rng = np.random.default_rng(2)
    from pyrope_tpu.index.flat import FlatIndex

    n, d = 3000, 16
    vecs = rng.random((n, d), np.float32)
    with pytest.raises(ValueError):
        FlatIndex(d, "L2", selection="pallas")
    exact = FlatIndex(d, "L2")
    pall = FlatIndex(d, "L2", selection="hybrid")
    ids = [str(i) for i in range(n)]
    exact.add_batch(ids, vecs)
    pall.add_batch(ids, vecs)
    q = rng.random((5, d), np.float32)
    r1 = exact.search_batch(q, 10)
    r2 = pall.search_batch(q, 10)
    assert [[h.id for h in row] for row in r1] == [[h.id for h in row] for row in r2]
    # delete + max_scans also flow through the kernel
    pall.delete("42")
    hits = pall.search(vecs[42], 5)
    assert all(h.id != "42" for h in hits)


# ---- wide k, ties, tilings -------------------------------------------------

def _stable_ref(q, x, sq, alive, ms, k, metric):
    """(value desc, row asc) reference order — np stable argsort."""
    scores, _ = ref_topk(q, x, sq, alive, ms, k, metric)
    return scores, np.argsort(-scores, axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("k", [50, 100])
def test_wide_k_bitonic_exact_order(k):
    """Wide k keeps the exact (score desc, row asc) order, including ties
    between duplicate rows that land in different splits of the slab."""
    rng = np.random.default_rng(13)
    n, b, d = 16384, 16, 16
    x = rng.random((n, d), np.float32)
    x[200] = x[100]          # duplicate rows force score ties
    x[4096 + 7] = x[100]     # ...across splits too
    q = rng.random((b, d), np.float32)
    q[0] = x[100]
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    alive[50:90] = False
    ms = n - 100
    vals, idx = _flat(q, x, sq, alive, ms, k)
    scores, ref_idx = _stable_ref(q, x, sq, alive, ms, k, Metric.L2)
    np.testing.assert_array_equal(idx, ref_idx)  # exact order incl. ties
    np.testing.assert_allclose(
        vals, np.take_along_axis(scores, ref_idx, axis=1), rtol=1e-5, atol=1e-5
    )


def test_wide_k_fewer_live_than_k_reports_minus_one():
    rng = np.random.default_rng(14)
    n, b, d, k = 4096, 8, 16, 100
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.zeros(n, bool)
    alive[:7] = True
    vals, idx = _flat(q, x, sq, alive, n, k)
    assert set(idx[0][:7]) == set(range(7))
    assert (idx[:, 7:] == -1).all()
    assert np.isneginf(vals[:, 7:]).all()


def test_wide_k_fallback_matches_bitonic(monkeypatch):
    """Two tilings of the same scan (row tile, batch tile, and so the
    number of splits) return identical hit lists."""
    rng = np.random.default_rng(15)
    n, b, d, k = 3000, 40, 16, 40
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    v1, i1 = _flat(q, x, sq, alive, n, k)
    monkeypatch.setattr(pallas_scan, "ROW_TILE", 64)
    monkeypatch.setattr(pallas_scan, "MAX_BATCH_TILE", 16)
    pallas_scan._build.cache_clear()
    pallas_flat_topk.clear_cache()
    try:
        v2, i2 = _flat(q, x, sq, alive, n, k)
    finally:
        pallas_scan._build.cache_clear()
        pallas_flat_topk.clear_cache()
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-5)


# ---- fused dense-mask IVF kernel -------------------------------------------

def _mk_ivf_case(seed, n, b, d, kc, nprobe=3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    alive[5:40] = False
    # cluster-major crow: contiguous runs
    lens = rng.multinomial(n, np.ones(kc) / kc)
    crow = np.repeat(np.arange(kc, dtype=np.int32), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pos = (np.arange(n) - offs[crow]).astype(np.int32)
    probe = np.stack([
        rng.choice(kc, size=nprobe, replace=False) for _ in range(b)
    ]).astype(np.int32)
    allowed = np.zeros((b, kc), np.int32)
    allowed[np.arange(b)[:, None], probe] = lens[probe]
    return q, x, sq, alive, crow, pos, allowed, probe


def _ivf(q, x, sq, alive, crow, pos, allowed, k, metric=Metric.L2, **kw):
    vals, idx = pallas_ivf_topk(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq), jnp.asarray(alive),
        jnp.asarray(crow), jnp.asarray(pos), jnp.asarray(allowed), k=k,
        metric=metric, **kw,
    )
    return np.asarray(vals), np.asarray(idx)


def _ivf_ref(q, x, sq, alive, crow, pos, allowed, k, metric=Metric.L2):
    dots = q @ x.T
    if metric == Metric.L2:
        scores = -np.maximum((q * q).sum(1)[:, None] - 2 * dots
                             + sq[None, :], 0)
    else:
        scores = dots
    member = pos[None, :] < allowed[:, crow]
    scores = np.where(member & alive[None, :], scores, -np.inf)
    ref_idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    ref_idx = np.where(
        np.take_along_axis(scores, ref_idx, axis=1) > -np.inf, ref_idx, -1
    )
    return scores, ref_idx


def test_wide_k_ivf_kernel():
    n, b, d, k, kc = 8192, 8, 16, 64, 17
    case = _mk_ivf_case(16, n, b, d, kc)[:7]
    _, idx = _ivf(*case, k)
    _, ref_idx = _ivf_ref(*case, k)
    np.testing.assert_array_equal(idx, ref_idx)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_ivf_kernel_vs_numpy(metric):
    n, b, d, k, kc = 4096, 64, 32, 10, 17
    case = _mk_ivf_case(3, n, b, d, kc)[:7]
    vals, idx = _ivf(*case, k, metric)
    scores, ref_idx = _ivf_ref(*case, k, metric)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(
        vals, np.take_along_axis(scores, ref_idx, axis=1), rtol=1e-4,
        atol=1e-4)


def test_ivf_kernel_wide_table_with_budgets():
    """A 1000-list table (the wide-cluster-table regime) with per-list
    max_scans budgets below the list lengths: the per-row lookup masks
    rows past each probed list's budget, exactly like dense_probe_mask."""
    n, b, d, k, kc = 16384, 16, 32, 10, 1000
    q, x, sq, alive, crow, pos, allowed, probe = _mk_ivf_case(
        11, n, b, d, kc, nprobe=40)
    allowed = np.minimum(allowed, 7)  # budget: first 7 rows of each list
    _, idx = _ivf(q, x, sq, alive, crow, pos, allowed, k)
    _, ref_idx = _ivf_ref(q, x, sq, alive, crow, pos, allowed, k)
    np.testing.assert_array_equal(idx, ref_idx)
    assert (pos[np.maximum(idx, 0)][idx >= 0] < 7).all()


def test_ivf_kernel_matches_dense_probe_mask():
    """The kernel's per-row budget lookup and the XLA dense path's [B, N]
    mask (index/ivf_flat.dense_probe_mask) select the same rows."""
    from pyrope_tpu.index.ivf_flat import dense_probe_mask, probe_budget_table
    from pyrope_tpu.ops.distance import score_matrix
    from pyrope_tpu.ops.topk import masked_topk

    n, b, d, k, kc = 6000, 12, 24, 10, 40
    q, x, sq, alive, crow, pos, _, probe = _mk_ivf_case(5, n, b, d, kc, 6)
    eff = jnp.asarray(np.full(probe.shape, 50, np.int32))
    allowed = probe_budget_table(jnp.asarray(probe), eff, kc)
    _, idx = _ivf(q, x, sq, alive, crow, pos, allowed, k)
    mask = dense_probe_mask(jnp.asarray(probe), eff, jnp.asarray(crow),
                            jnp.asarray(pos), jnp.asarray(alive), kc)
    scores = score_matrix(jnp.asarray(q), jnp.asarray(x), Metric.L2,
                          x_sqnorm=jnp.asarray(sq))
    _, ref = masked_topk(scores, mask, k)
    np.testing.assert_array_equal(idx, np.asarray(ref))


def test_ivf_kernel_bf16_slab_promote():
    """bf16 slabs (the hybrid shortlist scan) score bf16 x bf16 with fp32
    accumulation: the reference is the same arithmetic on the bf16-rounded
    query and rows."""
    n, b, d, k, kc = 4096, 16, 32, 10, 9
    q, x, sq, alive, crow, pos, allowed, _ = _mk_ivf_case(6, n, b, d, kc)
    x16 = jnp.asarray(x, jnp.bfloat16)
    xr = np.asarray(x16.astype(jnp.float32))
    qr = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    _, idx = _ivf(q, x16, sq, alive, crow, pos, allowed, k)
    scores, ref_idx = _ivf_ref(q, xr, sq, alive, crow, pos, allowed, k)
    dots16 = qr @ xr.T  # the kernel's bf16-operand dot
    scores16 = -np.maximum((q * q).sum(1)[:, None] - 2 * dots16 + sq, 0)
    scores16 = np.where(np.isfinite(scores), scores16, -np.inf)
    ref16 = np.argsort(-scores16, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx, ref16)
    assert (idx == ref_idx).mean() > 0.9  # bf16 rounding reorders few


def test_ivf_index_pallas_matches_exact_dense():
    """The IVF route through the kernel (hybrid: bf16 shortlist + fp32
    rerank) at a width that is not a power of two matches the exact dense
    scan."""
    import pyrope_tpu as pt

    rng = np.random.default_rng(7)
    base = rng.normal(size=(3000, 24)).astype(np.float32)
    ids = [str(i) for i in range(3000)]
    q = rng.normal(size=(8, 24)).astype(np.float32)
    a = pt.IvfFlatIndex(24, "L2", nlist=16, nprobe=4, selection="exact",
                        scan_mode="dense")
    b = pt.IvfFlatIndex(24, "L2", nlist=16, nprobe=4, selection="hybrid",
                        scan_mode="dense")
    for ix in (a, b):
        ix.add_batch(ids, base)
        ix.build()
    ra = a.search_batch(q, 10)
    rb = b.search_batch(q, 10)
    for ha, hb in zip(ra, rb):
        assert [h.id for h in ha] == [h.id for h in hb]
        assert np.allclose([h.score for h in ha], [h.score for h in hb])
    assert b.describe_scan(8) == "dense-pallas-hybrid"


def test_ivf_pallas_falls_back_on_max_scans():
    """A max_scans budget stays on the fused kernel (the probe-budget table
    carries it) and produces the XLA kernel's budgeted hit set."""
    import pyrope_tpu as pt

    rng = np.random.default_rng(8)
    base = rng.normal(size=(2000, 16)).astype(np.float32)
    ids = [str(i) for i in range(2000)]
    q = rng.normal(size=(4, 16)).astype(np.float32)
    a = pt.IvfFlatIndex(16, "L2", nlist=8, nprobe=8, selection="exact",
                        scan_mode="dense")
    b = pt.IvfFlatIndex(16, "L2", nlist=8, nprobe=8, selection="hybrid",
                        scan_mode="dense")
    for ix in (a, b):
        ix.add_batch(ids, base)
        ix.build()
    opts = pt.SearchOptions(max_scans=500)
    assert b.describe_scan(8, max_scans=500) == "dense-pallas-hybrid"
    ra = a.search_batch(q, 5, opts)
    rb = b.search_batch(q, 5, opts)
    for ha, hb in zip(ra, rb):
        assert [h.id for h in ha] == [h.id for h in hb]


def test_ivfpq_dense_pallas_matches_xla_exact():
    """refine>0 dense path (the XLA exact scan of the rerank slab): probing
    every list, it must return the brute-force exact top-k."""
    import pyrope_tpu as pt

    rng = np.random.default_rng(9)
    base = rng.normal(size=(4000, 32)).astype(np.float32)
    ids = [str(i) for i in range(4000)]
    q = rng.normal(size=(8, 32)).astype(np.float32)
    ix = pt.IvfPqIndex(32, "L2", nlist=16, pq_m=4, ksub=16, nprobe=16,
                       scan_mode="dense")
    ix.add_batch(ids, base)
    ix.build()
    assert ix.describe_scan(8) == "dense-exact-xla"
    got = ix.search_batch(q, 10)
    d2 = ((q[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    ref = np.argsort(d2, axis=1, kind="stable")[:, :10]
    for bi, hits in enumerate(got):
        assert [int(h.id) for h in hits] == list(ref[bi])
        np.testing.assert_allclose([h.score for h in hits],
                                   -d2[bi, ref[bi]], rtol=1e-4, atol=1e-3)


def test_ivf_index_windowed_matches_probe():
    """A wide cluster table (nlist 600) on the dense path: hit sets equal
    the probe kernel's."""
    import pyrope_tpu as pt

    rng = np.random.default_rng(12)
    base = rng.normal(size=(20000, 16)).astype(np.float32)
    ids = [str(i) for i in range(20000)]
    q = rng.normal(size=(8, 16)).astype(np.float32)
    a = pt.IvfFlatIndex(16, "L2", nlist=600, nprobe=32, scan_mode="probe")
    b = pt.IvfFlatIndex(16, "L2", nlist=600, nprobe=32, scan_mode="dense")
    for ix in (a, b):
        ix.add_batch(ids, base)
        ix.build()
    assert b.describe_scan(8) == "dense-xla", b.describe_scan(8)
    ra = a.search_batch(q, 10)
    rb = b.search_batch(q, 10)
    for ha, hb in zip(ra, rb):
        assert [h.id for h in ha] == [h.id for h in hb]
        assert np.allclose([h.score for h in ha], [h.score for h in hb],
                           atol=1e-4)


def test_high_dim_flat_kernel_vs_numpy():
    """The fused flat kernel at an embedding-realistic width (d=768): the
    dot loops over six 128-column chunks."""
    rng = np.random.default_rng(7)
    n, b, d, k = 4096, 16, 768, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    assert pallas_scan._plan(b, n, d, 16)["nk"] == 6
    _, idx = _flat(q, x, sq, alive, n, k)
    _, ref_idx = ref_topk(q, x, sq, alive, n, k, Metric.L2)
    for bi in range(b):
        assert set(idx[bi]) == set(ref_idx[bi])


def test_high_dim_ivf_windowed_index():
    """IVF dense path at d=768 with a wide cluster table, against the
    probe kernel."""
    import pyrope_tpu as pt

    rng = np.random.default_rng(13)
    n, d = 6000, 768
    base = rng.normal(size=(n, d)).astype(np.float32)
    ids = [str(i) for i in range(n)]
    q = rng.normal(size=(4, d)).astype(np.float32)
    a = pt.IvfFlatIndex(d, "L2", nlist=600, nprobe=64, scan_mode="probe")
    b = pt.IvfFlatIndex(d, "L2", nlist=600, nprobe=64, scan_mode="dense")
    for ix in (a, b):
        ix.add_batch(ids, base)
        ix.build()
    assert b.describe_scan(4) == "dense-xla", b.describe_scan(4)
    ra = a.search_batch(q, 10)
    rb = b.search_batch(q, 10)
    for ha, hb in zip(ra, rb):
        assert [h.id for h in ha] == [h.id for h in hb]


# ---- wrapper: tiling plan, padding, route -----------------------------------

@pytest.mark.parametrize("b,n,d,kslots", [
    (1, 1, 8, 16), (5, 3000, 24, 16), (64, 4096, 32, 16),
    (1024, 1_000_000, 128, 16), (4096, 100_000, 128, 16),
    (256, 100_000, 768, 16), (1024, 1_000_000, 128, 128),
])
def test_plan_covers_slab(b, n, d, kslots):
    """Every slab row falls in exactly one split, no split is empty, and
    tiles obey Triton's power-of-two shapes."""
    p = pallas_scan._plan(b, n, d, kslots)
    rows_per = p["tiles_per"] * pallas_scan.ROW_TILE
    assert p["splits"] * rows_per >= n
    assert (p["splits"] - 1) * rows_per < n
    assert p["nb"] * p["bt"] >= b
    for v in (p["bt"], p["dk"], pallas_scan.ROW_TILE):
        assert v >= 16 and v & (v - 1) == 0
    assert p["nk"] * p["dk"] >= d
    assert p["nb"] * p["splits"] <= max(pallas_scan.TARGET_BLOCKS, p["nb"])


@pytest.mark.parametrize("backend,expect", [
    ("cpu", True), ("gpu", False), ("metal", None), ("rocm", None),
])
def test_interpret_only_on_cpu(monkeypatch, backend, expect):
    """Interpret mode only on the CPU; the GPU compiles through Triton; any
    other backend has no route and raises instead of interpreting."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is None:
        with pytest.raises(RuntimeError, match="no Pallas route"):
            pallas_scan.interpret_mode()
    else:
        assert pallas_scan.interpret_mode() is expect


def test_odd_batch_and_rows_pad_inside_wrapper():
    """Batch and slab sizes that are not tile multiples are padded (queries)
    or masked (rows) inside the wrapper; results come back [B, k]."""
    rng = np.random.default_rng(21)
    n, b, d, k = 1000, 7, 20, 12
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    vals, idx = _flat(q, x, sq, alive, n, k)
    assert vals.shape == (b, k) and idx.shape == (b, k)
    _, ref_idx = _stable_ref(q, x, sq, alive, n, k, Metric.L2)
    np.testing.assert_array_equal(idx, ref_idx)


def test_traced_max_scans_in_jit():
    """max_scans may be a traced scalar (shard_map bodies pass per-shard
    budgets): one compiled program serves every budget."""
    rng = np.random.default_rng(22)
    n, b, d, k = 2048, 8, 16, 5
    x = jnp.asarray(rng.random((n, d), np.float32))
    q = jnp.asarray(rng.random((b, d), np.float32))
    sq = jnp.sum(x * x, axis=1)
    alive = jnp.ones(n, bool)
    fn = jax.jit(lambda ms: pallas_flat_topk(q, x, sq, alive, ms, k=k))
    for ms in (10, 300):
        _, idx = fn(jnp.int32(ms))
        assert (np.asarray(idx) < ms).all()


def _triton_module_text(monkeypatch, n, d, dtype):
    """Lower the flat kernel for the GPU (no card needed) and return the
    Triton module's text."""
    from jax._src.lib.mlir import ir
    from jax._src.pallas.triton import lowering as triton_lowering

    monkeypatch.setattr(pallas_scan, "interpret_mode", lambda: False)
    args = (jax.ShapeDtypeStruct((64, d), jnp.float32),
            jax.ShapeDtypeStruct((n, d), dtype),
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.bool_))
    fn = jax.jit(lambda q, x, s, a: pallas_scan._fused_topk(
        q, x, s, a, 10, Metric.L2, n, None))
    mod = fn.trace(*args).lower(lowering_platforms=("cuda",)).compiler_ir(
        "stablehlo")
    blobs = []

    def walk(op):
        op = op.operation
        if op.name == "stablehlo.custom_call":
            cfg = ir.DictAttr(op.attributes["mhlo.backend_config"])
            blobs.append(ir.StringAttr(cfg["ir"]).value_bytes)
        for region in op.regions:
            for block in region.blocks:
                for child in block.operations:
                    walk(child)

    walk(mod)
    assert len(blobs) == 1
    with triton_lowering._new_ir_context():
        return str(ir.Module.parse(blobs[0]))


@pytest.mark.parametrize("n,dtype,offset_bits", [
    (2**31 // 128 + 1000, jnp.bfloat16, "i64"),   # 2^31+ elements, 4.3 GB
    (2**30 // 128 + 1000, jnp.float32, "i64"),    # 4.3 GB fp32
    (100_000, jnp.bfloat16, "i32"),
])
def test_slab_beyond_int32_elements_addresses_in_64_bits(
        monkeypatch, n, dtype, offset_bits):
    """A slab past 2^31 elements (16.8M x 128, the hybrid route at real
    scale) is accepted, and the Triton kernel addresses it with 64-bit
    offsets, so row * d never wraps; smaller slabs keep 32-bit ones."""
    import re

    text = _triton_module_text(monkeypatch, n, 128, dtype)
    elt = "bf16" if dtype == jnp.bfloat16 else "f32"
    slab_ptrs = re.findall(
        rf"tt\.addptr [^\n]*tensor<128x128x!tt\.ptr<{elt}>>, "
        r"tensor<128x128x(i\d+)>", text)
    assert slab_ptrs and set(slab_ptrs) == {offset_bits}
