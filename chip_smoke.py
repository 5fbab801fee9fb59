#!/usr/bin/env python
"""Smoke check of the served search path on the GPU.

    python chip_smoke.py          # one card: served, kernel and HNSW phases
    python chip_smoke.py --four   # four cards: the sharded paths only

One card: a RESP server (PyropeEngine + RespServer, in-process) serves a
SIFT1M-shaped corpus (1,000,000 x 128 fp32, L2; ANN-Benchmarks'
sift-128-euclidean) from an IVF_FLAT index with nlist 1000, answering
VEC.SEARCH ... TOPK 10 NPROBE 32 through the RESP client; every exact
route and every fused-kernel route is compared with a plain reference at
real widths; the HNSW beam search runs once at 50k x 128. Four cards:
ShardedFlatIndex (10M x 128) and ShardedIvfFlatIndex (4M x 128) against
their one-card counterparts. Data is generated from ``--seed``.

Any failed phase raises and the script exits non-zero; it exits 2
without a result when JAX finds no GPU. The last line of stdout is one
JSON object {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np

K = 10


def log(*a) -> None:
    print(*a, flush=True)


def card_info() -> str:
    """Name and power limit of the card, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---- served phase -----------------------------------------------------------

def start_server():
    """PyropeApp with auth off and no HTTP plane, on its own event loop in
    a daemon thread. Returns (app, loop)."""
    from pyrope_tpu.security import AuthSettings
    from pyrope_tpu.server.app import PyropeApp
    from pyrope_tpu.server.engine import EngineConfig

    app = PyropeApp(config=EngineConfig(auth=AuthSettings(enabled=False)),
                    resp_port=0, http_port=0)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(app.start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    if not started.wait(120):
        raise RuntimeError("RESP server did not start")
    return app, loop


def stop_server(app, loop) -> None:
    asyncio.run_coroutine_threadsafe(app.stop(), loop).result(60)
    loop.call_soon_threadsafe(loop.stop)


def probed_exact_reference(tail, queries: np.ndarray, nprobe: int,
                           k: int) -> list[list[tuple[str, float]]]:
    """NumPy float64 reference over the BUILT index's own centroids and
    lists: rank centroids, take the top ``nprobe`` lists, exact-scan their
    rows. Returns per query [(id, -d²), ...] best first."""
    cents = tail.get_centroids().astype(np.float64)
    xperm = tail._xperm
    offs, lens, ids = tail._offsets, tail._lens, tail._perm_ids
    out = []
    for q in queries.astype(np.float64):
        cd = ((cents - q) ** 2).sum(1)
        lists = np.argsort(cd, kind="stable")[:nprobe]
        rows = np.concatenate([np.arange(offs[c], offs[c] + lens[c])
                               for c in lists])
        d2 = ((xperm[rows].astype(np.float64) - q) ** 2).sum(1)
        best = np.argsort(d2, kind="stable")[:k]
        out.append([(ids[rows[i]], float(-d2[i])) for i in best])
    return out


def brute_force_ids(base: np.ndarray, queries: np.ndarray, k: int,
                    chunk: int = 100_000) -> np.ndarray:
    """Exact top-k row ids over the whole corpus, float64, chunked."""
    q = queries.astype(np.float64)
    qq = (q * q).sum(1)[:, None]
    best_d = np.full((len(q), 0), np.inf)
    best_i = np.zeros((len(q), 0), np.int64)
    for s in range(0, len(base), chunk):
        x = base[s:s + chunk].astype(np.float64)
        d = qq - 2 * q @ x.T + (x * x).sum(1)[None, :]
        cand_d = np.concatenate([best_d, d], 1)
        cand_i = np.concatenate(
            [best_i, np.broadcast_to(np.arange(s, s + len(x)), d.shape)], 1)
        order = np.argsort(cand_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cand_d, order, 1)
        best_i = np.take_along_axis(cand_i, order, 1)
    return best_i


def served_phase(n: int = 1_000_000, dim: int = 128, nlist: int = 1000,
                 nprobe: int = 32, n_requests: int = 1024, clients: int = 8,
                 n_recall: int = 128, seed: int = 42,
                 min_match: float = 0.999, tie_tol: float = 1e-5) -> dict:
    """Bulk-load through the engine, build, serve VEC.SEARCH over RESP, and
    check every answer against the probed-exact NumPy reference: ids must
    agree in ``min_match`` of the (query, rank) slots, and every slot that
    differs must be an fp32 near-tie (served and reference scores at that
    rank within ``tie_tol`` relative). Recall@10 against brute force is
    reported over the first ``n_recall`` queries."""
    from pyrope_tpu.cache import CachePolicyConfig
    from pyrope_tpu.server.resp_client import RespClient
    from pyrope_tpu.types import IndexConfig, IndexParams, Metric
    from pyrope_tpu.utils.datasets import (
        synthetic_clustered,
        synthetic_clustered_queries,
    )
    from pyrope_tpu.utils.parsing import encode_vector

    t0 = time.perf_counter()
    base = synthetic_clustered(n, dim, n_clusters=nlist, seed=seed)
    queries = synthetic_clustered_queries(n_requests, dim, n_clusters=nlist,
                                          seed=seed + 1, base_seed=seed)
    log(f"[served] generated {n}x{dim} corpus + {n_requests} queries "
        f"in {time.perf_counter() - t0:.1f}s")
    app, loop = start_server()
    try:
        eng = app.engine
        # result cache off (a user policy, PUT /v1/cache/policies): its
        # semantic tier answers a near-duplicate query with a neighbour's
        # results by design, and this check needs every request to reach
        # the index
        eng.policy.store.update(CachePolicyConfig(enable_cache=False))
        eng.create_index("smoke", "sift", IndexConfig(
            dim=dim, metric=Metric.L2, algorithm="IVF_FLAT",
            params=IndexParams.from_dict({"nlist": nlist, "nprobe": nprobe}),
        ))
        t0 = time.perf_counter()
        ids = [str(i) for i in range(n)]
        w = eng.add_batch("smoke", "sift", ids, base)
        if not w.ok:
            raise RuntimeError(f"bulk load failed: {w}")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not eng.build_index("smoke", "sift"):
            raise RuntimeError("build_index failed")
        build_s = time.perf_counter() - t0
        tail = eng.registry.try_get("smoke", "sift").index.tail
        log(f"[served] bulk load {load_s:.1f}s, build {build_s:.1f}s "
            f"(IVF_FLAT nlist={nlist})")

        replies: list = [None] * n_requests
        errors: list = []

        def client(c_idx: int):
            try:
                with RespClient("127.0.0.1", app.resp.port, timeout=600) as c:
                    for i in range(c_idx, n_requests, clients):
                        replies[i] = c.vec_search(
                            "smoke", "sift", encode_vector(queries[i]), K,
                            "NPROBE", nprobe)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        serve_s = time.perf_counter() - t0
        if errors or any(r is None for r in replies):
            raise RuntimeError(f"RESP search failed: {errors[:3]}")
        paths = {tail.describe_scan(b, nprobe) for b in (1, 8, 64)}
        ref = probed_exact_reference(tail, queries, nprobe, K)
    finally:
        stop_server(app, loop)

    got = [[(h[0], float(h[1])) for h in r] for r in replies]
    slots = match = 0
    diffs = []
    for qi, (g, r) in enumerate(zip(got, ref)):
        for rank in range(K):
            slots += 1
            gid = g[rank][0] if rank < len(g) else None
            if gid == r[rank][0]:
                match += 1
            else:
                diffs.append((qi, rank, gid, r[rank][0],
                              g[rank][1] if rank < len(g) else None,
                              r[rank][1]))
    truth = brute_force_ids(base, queries[:n_recall], K)
    recall = float(np.mean([
        len({int(h[0]) for h in g} & set(truth[qi].tolist())) / K
        for qi, g in enumerate(got[:n_recall])
    ]))
    frac = match / slots
    not_ties = [d for d in diffs if d[4] is None
                or abs(d[4] - d[5]) > tie_tol * max(1.0, abs(d[5]))]
    log(f"[served] {n_requests} VEC.SEARCH TOPK {K} NPROBE {nprobe} over "
        f"RESP in {serve_s:.2f}s; scan paths {sorted(paths)}")
    log(f"[served] ids match the probed-exact float64 reference in "
        f"{match}/{slots} slots ({frac:.4%}); {len(diffs) - len(not_ties)} "
        f"differing slots are fp32 near-ties; recall@{K} vs brute force "
        f"{recall:.4f} ({min(n_recall, n_requests)} queries)")
    for d in diffs[:20]:
        log(f"[served]   differs: query {d[0]} rank {d[1]}: served {d[2]} "
            f"({d[4]}) vs reference {d[3]} ({d[5]})")
    if frac < min_match or not_ties:
        raise AssertionError(f"served ids match {frac:.4%} (need "
                             f"{min_match:.1%}); {len(not_ties)} differing "
                             f"slots are not near-ties")
    return {"match": frac, "recall": recall, "diffs": len(diffs)}


# ---- kernel phase -----------------------------------------------------------

# name: (rows, dim, batch, k, nlist, nprobe)
KERNEL_SHAPES = {
    "flat_1m_b1024_k10": (1_000_000, 128, 1024, 10, 0, 0),
    "flat_1m_b1024_k100": (1_000_000, 128, 1024, 100, 0, 0),
    "ivf_100k_nl100_np96_b4096_k10": (100_000, 128, 4096, 10, 100, 96),
    "ivf_1m_nl1000_np32_b1024_k10": (1_000_000, 128, 1024, 10, 1000, 32),
}


def _kernel_case(n, dim, b, nlist, seed):
    """Device-generated slab, queries and (for IVF) a cluster-major list
    layout with random centroids."""
    import jax
    import jax.numpy as jnp

    kx, kq, kc, ka = jax.random.split(jax.random.PRNGKey(seed), 4)
    x = jax.random.normal(kx, (n, dim), jnp.float32)
    c = {"x": x, "x16": x.astype(jnp.bfloat16),
         "sq": jnp.sum(x * x, axis=1), "alive": jnp.ones(n, bool),
         "q": jax.random.normal(kq, (b, dim), jnp.float32)}
    if nlist:
        crow = jnp.sort(jax.random.randint(ka, (n,), 0, nlist)).astype(
            jnp.int32)
        lens = jnp.bincount(crow, length=nlist).astype(jnp.int32)
        offs = (jnp.cumsum(lens) - lens).astype(jnp.int32)
        c.update(crow=crow, lens=lens, offs=offs,
                 pos=jnp.arange(n, dtype=jnp.int32) - offs[crow],
                 cents=jax.random.normal(kc, (nlist, dim), jnp.float32),
                 cvalid=jnp.ones(nlist, bool))
    return c


def _reference(c, k, nprobe, bf16=False):
    """The plain version: score_matrix (HIGHEST for fp32, bf16 operands for
    the shortlist scan) + probe mask + lax.top_k, written out here."""
    import jax
    import jax.numpy as jnp

    from pyrope_tpu.ops.distance import score_matrix
    from pyrope_tpu.types import Metric

    @jax.jit
    def ref(c):
        x = c["x16"] if bf16 else c["x"]
        s = score_matrix(c["q"], x, Metric.L2, x_sqnorm=c["sq"],
                         compute_dtype=jnp.bfloat16 if bf16 else None)
        if "crow" in c:
            cs = score_matrix(c["q"], c["cents"], Metric.L2)
            _, probe = jax.lax.top_k(cs, nprobe)
            member = jnp.zeros(cs.shape, bool).at[
                jnp.arange(cs.shape[0])[:, None], probe].set(True)
            s = jnp.where(member[:, c["crow"]], s, -jnp.inf)
        return jax.lax.top_k(s, k)

    return ref(c)


def _compare(name, route, precision, got, want, tol) -> dict:
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    if not (np.isfinite(gv).all() and np.isfinite(wv).all()):
        raise AssertionError(f"{name}/{route}: missing hits in a full scan")
    same = gi == wi
    err = float(np.max(np.abs(gv - wv)))
    near = np.abs(gv - wv) <= tol * np.maximum(1.0, np.abs(wv))
    bad = int((~same & ~near).sum())
    row = {"shape": name, "route": route, "precision": precision,
           "tolerance": f"ids equal, or scores within {tol:g} relative",
           "max_score_err": err, "id_match": float(same.mean()),
           "mismatch_beyond_tol": bad}
    log(f"[kernel] {json.dumps(row)}")
    if bad or err > tol * max(1.0, float(np.max(np.abs(wv)))):
        raise AssertionError(f"{name}/{route}: {bad} mismatches beyond tol, "
                             f"max err {err}")
    return row


def kernel_phase(shapes: dict | None = None, seed: int = 7) -> list[dict]:
    """Every scan route of the served index families at real widths: the
    exact XLA routes and the fused kernel (bf16 shortlist scan, and the
    hybrid route = kernel + exact rerank) against the plain reference."""
    import jax
    import jax.numpy as jnp

    from pyrope_tpu.index.flat import (
        _dense_search_fn,
        _hybrid_search_fn,
        hybrid_shortlist,
    )
    from pyrope_tpu.index.ivf_flat import (
        _ivf_dense_fn,
        _ivf_dense_pallas_hybrid_fn,
        probe_budget_table,
        rank_probes,
    )
    from pyrope_tpu.ops.pallas_scan import pallas_flat_topk, pallas_ivf_topk
    from pyrope_tpu.types import Metric

    rows = []
    for name, (n, dim, b, k, nlist, nprobe) in (shapes or KERNEL_SHAPES).items():
        c = _kernel_case(n, dim, b, nlist, seed)
        r = hybrid_shortlist(k, 0)
        ms = jnp.int32(n)
        exact = _reference(c, k, nprobe)
        short = _reference(c, r, nprobe, bf16=True)
        if nlist:
            args = (c["cents"], c["cvalid"], c["x"], c["sq"], c["alive"],
                    c["offs"], c["lens"], c["crow"], c["pos"], c["q"], ms)
            route = _ivf_dense_fn(Metric.L2, k, nprobe, None)(*args)
            probe, _, eff = jax.jit(rank_probes, static_argnums=(5, 7, 8))(
                c["q"], c["cents"], c["cvalid"], c["offs"], c["lens"],
                nprobe, ms, Metric.L2, None)
            allowed = probe_budget_table(probe, eff, nlist)
            kern = pallas_ivf_topk(c["q"], c["x16"], c["sq"], c["alive"],
                                   c["crow"], c["pos"], allowed, k=r)
            hyb = _ivf_dense_pallas_hybrid_fn(Metric.L2, k, r, nprobe)(
                c["cents"], c["cvalid"], c["x"], c["x16"], c["sq"],
                c["alive"], c["offs"], c["lens"], c["crow"], c["pos"],
                c["q"], ms)
            exact_name = "xla dense-mask scan (index/ivf_flat)"
        else:
            route = _dense_search_fn(Metric.L2, k, None, "exact")(
                c["x"], c["sq"], c["alive"], c["q"], ms)
            kern = pallas_flat_topk(c["q"], c["x16"], c["sq"], c["alive"],
                                    ms, k=r)
            hyb = _hybrid_search_fn(Metric.L2, k, r)(
                c["x"], c["x16"], c["sq"], c["alive"], c["q"], ms)
            exact_name = "xla flat scan (index/flat)"
        rows.append(_compare(name, exact_name, "fp32 HIGHEST (IEEE)",
                             route, exact, 1e-6))
        rows.append(_compare(name, f"triton fused scan+top-{r}",
                             "bf16 operands, fp32 accumulate", kern, short,
                             1e-3))
        rows.append(_compare(name, f"hybrid (kernel top-{r} + fp32 rerank)",
                             "bf16 scan, fp32 HIGHEST rerank", hyb, exact,
                             1e-6))
        del c, exact, short, route, kern, hyb
        gc.collect()
    return rows


# ---- HNSW phase -------------------------------------------------------------

def hnsw_phase(n: int = 50_000, dim: int = 128, n_queries: int = 256,
               seed: int = 11, min_recall: float = 0.9,
               require_native: bool = True) -> float:
    """Native-built graph, batched device beam search once: it compiles,
    runs, and agrees with the exact scan (recall@10)."""
    import pyrope_tpu as pt
    from pyrope_tpu.native import native_available
    from pyrope_tpu.utils.datasets import (
        synthetic_clustered,
        synthetic_clustered_queries,
    )

    if require_native and not native_available():
        raise RuntimeError("native HNSW builder unavailable (g++ build failed)")
    base = synthetic_clustered(n, dim, seed=seed)
    q = synthetic_clustered_queries(n_queries, dim, seed=seed + 1,
                                    base_seed=seed)
    idx = pt.HnswIndex(dim, "L2", m=16, ef_construction=200, ef_search=64)
    t0 = time.perf_counter()
    idx.add_batch([str(i) for i in range(n)], base)
    idx.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hits = idx.search_batch(q, K)
    search_s = time.perf_counter() - t0
    truth = brute_force_ids(base, q, K)
    recall = float(np.mean([
        len({int(h.id) for h in row} & set(truth[i].tolist())) / K
        for i, row in enumerate(hits)
    ]))
    log(f"[hnsw] {n}x{dim}: build {build_s:.1f}s, {n_queries} queries "
        f"(first call, compile included) {search_s:.1f}s, recall@{K} vs "
        f"exact {recall:.4f}")
    if recall < min_recall:
        raise AssertionError(f"HNSW recall@{K} {recall:.4f} < {min_recall}")
    return recall


# ---- four cards -------------------------------------------------------------

def sharded_flat_phase(n: int = 10_000_000, dim: int = 128, b: int = 256,
                       n_dev: int = 4, seed: int = 3) -> None:
    """ShardedFlatIndex over a 1-D mesh of ``n_dev`` devices against the
    one-device chunked exact scan: ids identical."""
    import jax
    import jax.numpy as jnp

    from pyrope_tpu.ops.topk import chunked_exact_topk
    from pyrope_tpu.parallel import ShardedFlatIndex, make_mesh

    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dim), dtype=np.float32)
    q = rng.standard_normal((b, dim), dtype=np.float32)
    sh = ShardedFlatIndex(dim, "L2", mesh=make_mesh(n_dev))
    t0 = time.perf_counter()
    sh.add_batch([str(i) for i in range(n)], base)
    got = sh.search_batch(q, K)
    shard_s = time.perf_counter() - t0
    dev0 = jax.devices()[0]
    x = jax.device_put(base, dev0)
    _, want = chunked_exact_topk(x, jnp.sum(x * x, axis=1),
                                 jnp.ones(n, bool), jax.device_put(q, dev0),
                                 K, "L2")
    got_i = np.array([[int(h.id) for h in row] for row in got])
    same = float((got_i == want).mean())
    log(f"[four] ShardedFlatIndex {n}x{dim} over {n_dev} devices "
        f"(load+first search {shard_s:.1f}s): ids identical to the "
        f"one-device chunked exact scan in {same:.4%} of slots")
    if same != 1.0:
        raise AssertionError(f"sharded flat ids differ ({same:.4%})")


def sharded_ivf_phase(n: int = 4_000_000, dim: int = 128, nlist: int = 1000,
                      nprobe: int = 32, b: int = 256, n_dev: int = 4,
                      seed: int = 5, min_match: float = 0.999,
                      tie_ulps: float = 4.0) -> None:
    """ShardedIvfFlatIndex against the one-device IvfFlatIndex holding the
    SAME centroids and lists, on a clustered corpus. Ids must agree in
    ``min_match`` of the (query, rank) slots, and every slot that differs
    must be an fp32 near-tie: the two rows' exact (float64) distances to
    the query differ by at most ``tie_ulps`` fp32 roundings of the
    ‖q‖² + ‖x‖² terms both sides compute the distance from."""
    from pyrope_tpu.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu.parallel import ShardedIvfFlatIndex, make_mesh
    from pyrope_tpu.utils.datasets import (
        synthetic_clustered,
        synthetic_clustered_queries,
    )

    base = synthetic_clustered(n, dim, n_clusters=nlist, seed=seed)
    q = synthetic_clustered_queries(b, dim, n_clusters=nlist, seed=seed + 1,
                                    base_seed=seed)
    sh = ShardedIvfFlatIndex(dim, "L2", mesh=make_mesh(n_dev), nlist=nlist,
                             nprobe=nprobe)
    t0 = time.perf_counter()
    sh.add_batch([str(i) for i in range(n)], base)
    sh.build()
    got = sh.search_batch(q, K)
    shard_s = time.perf_counter() - t0
    one = IvfFlatIndex(dim, "L2", nlist=nlist, nprobe=nprobe)
    one._centroids = sh._centroids
    one._xperm = sh._xperm
    one._perm_ids = sh._perm_ids
    one._main_pos = None
    one._alive = sh._alive.copy()
    one._offsets, one._lens = sh._offsets, sh._lens
    one._main_live, one._built = sh._main_live, True
    want = one.search_batch(q, K)
    if any(len(ra) != len(rw) for ra, rw in zip(got, want)):
        raise AssertionError("sharded IVF returned a different hit count")
    q64 = q.astype(np.float64)
    eps = float(np.finfo(np.float32).eps)
    diffs, not_ties = [], 0
    for qi, (ra, rw) in enumerate(zip(got, want)):
        for r, (a, w) in enumerate(zip(ra, rw)):
            if a.id == w.id:
                continue
            xa = base[int(a.id)].astype(np.float64)
            xw = base[int(w.id)].astype(np.float64)
            gap = abs(((q64[qi] - xa) ** 2).sum() - ((q64[qi] - xw) ** 2).sum())
            tol = tie_ulps * eps * ((q64[qi] ** 2).sum()
                                    + max((xa ** 2).sum(), (xw ** 2).sum()))
            not_ties += gap > tol
            diffs.append((qi, r, a.id, w.id, gap, tol))
    slots = sum(len(r) for r in want)
    same = 1.0 - len(diffs) / max(slots, 1)
    log(f"[four] ShardedIvfFlatIndex {n}x{dim} clustered, nlist {nlist} "
        f"nprobe {nprobe} over {n_dev} devices (load+build+first search "
        f"{shard_s:.1f}s; paths {sh.describe_scan(b)} / "
        f"{one.describe_scan(b)}): ids identical to the one-device index in "
        f"{slots - len(diffs)}/{slots} slots ({same:.4%}); "
        f"{len(diffs) - not_ties} differing slots are fp32 near-ties")
    for d in diffs[:20]:
        log(f"[four]   differs: query {d[0]} rank {d[1]}: sharded {d[2]} vs "
            f"one device {d[3]}; exact distance gap {d[4]:.3g} "
            f"(tie tolerance {d[5]:.3g})")
    if same < min_match or not_ties:
        raise AssertionError(f"sharded IVF ids match {same:.4%} (need "
                             f"{min_match:.1%}); {not_ties} differing slots "
                             f"are not near-ties")


# ---- main -------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    ap.add_argument("--seed", type=int, default=None,
                    help="derive every phase's data from this seed (default: "
                         "each phase's own fixed seed)")
    args = ap.parse_args()

    def seed(offset: int) -> dict:
        return {} if args.seed is None else {"seed": args.seed + offset}

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    from pyrope_tpu.server.app import enable_compilation_cache

    enable_compilation_cache()
    devs = jax.devices()
    log(f"devices: {len(devs)} x {devs[0].device_kind}")
    if args.four:
        if len(devs) < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {len(devs)}")
        sharded_flat_phase(**seed(3))
        gc.collect()
        sharded_ivf_phase(**seed(4))
        count = 4
    else:
        served_phase(**seed(0))
        gc.collect()
        kernel_phase(**seed(1))
        gc.collect()
        hnsw_phase(**seed(2))
        count = len(devs)
    log(f"card: {card_info()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
