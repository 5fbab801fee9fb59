#!/usr/bin/env python
"""End-to-end RESP serving benchmark at the REFERENCE's workload.

The reference's headline (673.2 QPS, BASELINE.md) is measured end to end:
concurrent client workers driving the server's RESP port over the full
pipeline (parse -> auth -> quota -> cache -> engine -> metadata join),
ref: benchmarks/.../Program.cs:344-396 (4 concurrent workers). The engine
rows in BENCH_DETAIL measure the device path only — this script is the
apples-to-apples server-level row: same 100k x 128 corpus, same IVF
config, concurrent RESP clients, cache OFF (every request reaches the
device), micro-batcher coalescing singles into shared device batches
(server/batcher.py — the device analog of the reference's worker pool).

Three cell families (--cells), matching BASELINE.md's three serving rows:
  search    — concurrent VEC.SEARCH, cache OFF (ref 673.2 QPS at 100k IVF)
  upsert    — 4 concurrent VEC.UPSERT writers, vec/s (ref 10,486-22,969)
  cache_hit — repeated single query, cache ON (ref 6,121.9 QPS hit path;
              hits are host-side: L0 result cache, no device dispatch)

Usage:
    python scripts/serving_bench.py [--n 100000] [--dim 128]
        [--nprobe 3 96] [--concurrency 4 64] [--duration 10]
        [--cells search upsert cache_hit]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pyrope_tpu.cache import CachePolicyConfig  # noqa: E402
from pyrope_tpu.server.app import enable_compilation_cache  # noqa: E402
from pyrope_tpu.server.resp_client import RespClient  # noqa: E402
from pyrope_tpu.types import IndexConfig, IndexParams  # noqa: E402
from pyrope_tpu.utils.parsing import encode_vector  # noqa: E402

from load_test import run_cell, start_app  # noqa: E402  (same directory)


def _upsert_worker(port: int, index: str, ids: list[str], vecs: np.ndarray,
                   out: list, errors: list, pipeline: int = 1) -> None:
    lat = []
    try:
        with RespClient("127.0.0.1", port, timeout=120) as c:
            if pipeline <= 1:
                for i, vid in enumerate(ids):
                    t0 = time.perf_counter()
                    c.vec_upsert("lt", index, vid, encode_vector(vecs[i]))
                    lat.append((time.perf_counter() - t0) * 1000)
            else:
                # RESP pipelining: keep up to ``pipeline`` commands in
                # flight per writer; latency is send->reply for each op
                # (includes queueing behind the window, honestly)
                n = len(ids)
                sent: list[float] = []
                i_send = i_read = 0
                while i_read < n:
                    while i_send < n and i_send - i_read < pipeline:
                        sent.append(time.perf_counter())
                        c.send("VEC.UPSERT", "lt", index, ids[i_send],
                               "VECTOR", encode_vector(vecs[i_send]))
                        i_send += 1
                    r = c.read_reply()
                    if r != "VEC_OK":
                        raise RuntimeError(f"upsert reply: {r!r}")
                    lat.append((time.perf_counter() - sent[i_read]) * 1000)
                    i_read += 1
    except Exception as e:  # noqa: BLE001 — a dead writer must fail the cell
        errors.append(repr(e))
    out.append((len(lat), lat))


def run_upsert_cell(port: int, index: str, base: np.ndarray,
                    writers: int = 4, pipeline: int = 1,
                    procs: bool = False) -> dict:
    """Load ``base`` through concurrent RESP VEC.UPSERT writers (disjoint id
    ranges), reference-style: 4 writer workers, vec/s over the whole load
    (ref: benchmarks Program.cs load phase; BASELINE.md 'Vector load
    throughput'). ``procs`` runs writers as separate processes that
    import no JAX (scripts/resp_writer.py)."""
    from pyrope_tpu.utils.stats import LatencySummary

    n = len(base)
    bounds = np.linspace(0, n, writers + 1, dtype=int)
    if procs:
        import subprocess
        import tempfile

        writer = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "resp_writer.py")
        with tempfile.TemporaryDirectory() as tmp:
            cmds = []
            for w in range(writers):
                lo, hi = int(bounds[w]), int(bounds[w + 1])
                path = os.path.join(tmp, f"w{w}.npy")
                np.save(path, base[lo:hi])
                cmds.append([sys.executable, writer, "--port", str(port),
                             "--index", index, "--vecs", path,
                             "--lo", str(lo), "--pipeline", str(pipeline)])
            t0 = time.perf_counter()
            ps = [subprocess.Popen(c, stdout=subprocess.PIPE, text=True)
                  for c in cmds]
            outs = [json.loads(p.communicate(timeout=600)[0]) for p in ps]
        rows = [(o["n"], o["wall_s"], o["lat_ms"], o["error"]) for o in outs]
        wall = time.perf_counter() - t0
        total = sum(r[0] for r in rows)
        errors = [r[3] for r in rows if r[3]]
        s = LatencySummary.from_samples([x for r in rows for x in r[2]] or [0])
        return {
            "cell": "upsert", "writers": writers, "pipeline": pipeline,
            "writer_procs": True, "n": n,
            "vec_per_s": round(total / wall, 1),
            "p50_ms": round(s.p50_ms, 2), "p99_ms": round(s.p99_ms, 2),
            "requests": total, "errors": len(errors),
            "error_sample": errors[:3],
        }
    results: list = []
    errors: list = []
    threads = [
        threading.Thread(
            target=_upsert_worker,
            args=(port, index,
                  [f"v{i}" for i in range(bounds[w], bounds[w + 1])],
                  base[bounds[w]:bounds[w + 1]], results, errors, pipeline),
        )
        for w in range(writers)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total = sum(k for k, _ in results)
    s = LatencySummary.from_samples([x for _, ls in results for x in ls])
    return {
        "cell": "upsert", "writers": writers, "pipeline": pipeline, "n": n,
        "vec_per_s": round(total / wall, 1),
        "p50_ms": round(s.p50_ms, 2), "p99_ms": round(s.p99_ms, 2),
        "requests": total, "errors": len(errors), "error_sample": errors[:3],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--nprobe", type=int, nargs="+", default=[3, 96])
    ap.add_argument("--concurrency", type=int, nargs="+", default=[4, 16, 64])
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--pool", type=int, default=4096,
                    help="distinct queries (large pool + cache OFF => no "
                         "result-cache shortcuts; every request hits the device)")
    ap.add_argument("--cells", nargs="+",
                    default=["search", "upsert", "cache_hit"],
                    choices=["search", "upsert", "cache_hit"])
    ap.add_argument("--writers", type=int, default=4)
    ap.add_argument("--pipeline", type=int, default=1,
                    help="outstanding VEC.UPSERTs per writer (RESP pipelining)")
    ap.add_argument("--writer-procs", action="store_true",
                    help="writers as processes, not threads (no GIL convoy "
                         "with the in-process server; the honest model of "
                         "a remote load generator)")
    ap.add_argument("--inflight", type=int, default=None,
                    help="override MicroBatcher max_inflight (1 maximizes "
                         "coalescing; 2 overlaps one batch's host round "
                         "trip with the next)")
    ap.add_argument("--linger-ms", type=float, default=None,
                    help="post-acquire hold that merges closed-loop "
                         "cohorts (see MicroBatcher.linger_ms)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="override MicroBatcher max_batch (pair with "
                         "concurrency >= max_batch; buckets are warmed)")
    args = ap.parse_args()

    enable_compilation_cache()
    app, _loop = start_app()
    port = app.resp.port
    # cache OFF for every cell: this row measures the serving path to the
    # device, not the cache hit path (load_test.py covers that matrix)
    app.engine.policy.store.update(
        CachePolicyConfig(enable_cache=False, default_ttl_seconds=60)
    )
    if ((args.inflight is not None or args.linger_ms is not None
         or args.max_batch is not None) and app.engine.batcher is not None):
        from pyrope_tpu.server.batcher import MicroBatcher

        cfg = app.engine.config
        app.engine.batcher = MicroBatcher(
            cfg.microbatch_max if args.max_batch is None else args.max_batch,
            cfg.microbatch_wait_ms,
            max_inflight=(cfg.microbatch_inflight if args.inflight is None
                          else args.inflight),
            linger_ms=(cfg.microbatch_linger_ms if args.linger_ms is None
                       else args.linger_ms),
        )

    rng = np.random.default_rng(42)
    base = rng.standard_normal((args.n, args.dim)).astype(np.float32)
    queries = rng.standard_normal((args.pool, args.dim)).astype(np.float32)

    out = {"n": args.n, "dim": args.dim, "cells": []}

    if "upsert" in args.cells:
        # reference-style load phase: concurrent RESP writers into a fresh
        # buffer index (no build — upserts land in the host-side buffer,
        # exactly like the reference's pre-compaction load)
        app.engine.create_index(
            "lt", "ingest",
            IndexConfig(dim=args.dim, algorithm="IVF_FLAT",
                        params=IndexParams.from_dict({"nlist": 100})),
        )
        cell = run_upsert_cell(port, "ingest", base, writers=args.writers,
                               pipeline=args.pipeline,
                               procs=args.writer_procs)
        cell["coalescer"] = app.resp.write_coalescer.to_dict()
        out["cells"].append(cell)
        print(json.dumps(cell), file=sys.stderr)

    if "search" not in args.cells and "cache_hit" not in args.cells:
        print(json.dumps(out, indent=1))
        return

    for nprobe in args.nprobe:
        name = f"idx_np{nprobe}"
        app.engine.create_index(
            "lt", name,
            IndexConfig(dim=args.dim, algorithm="IVF_FLAT",
                        params=IndexParams.from_dict(
                            {"nlist": 100, "nprobe": nprobe})),
        )
        print(f"[{name}] loading {args.n} x {args.dim} ...", file=sys.stderr)
        t0 = time.perf_counter()
        app.engine.add_batch("lt", name, [f"v{i}" for i in range(args.n)], base)
        ok = app.engine.build_index("lt", name)
        print(f"[{name}] load+build {time.perf_counter() - t0:.1f}s ok={ok}",
              file=sys.stderr)
        with RespClient("127.0.0.1", port, timeout=300) as c:  # warm compile
            c.vec_search("lt", name, encode_vector(queries[0]), 10)
        # warm every batch bucket the micro-batcher can form (shapes.py
        # batch_bucket): first-touch compiles cost seconds and would
        # otherwise land inside the timed window as p99 spikes. Same k_exec
        # (round_k(10)=10) and default SearchOptions as the serving path.
        from pyrope_tpu.types import SearchOptions
        st = app.engine.registry.try_get("lt", name)
        wq = queries[:1]
        mb = app.engine.batcher.max_batch if app.engine.batcher else 64
        for b in (8, 16, 32, 64, 128, 256):
            if b > max(mb, 64):
                break
            st.index.search_batch(np.repeat(wq, b, axis=0), 10,
                                  SearchOptions())
        print(f"[{name}] batch buckets warmed", file=sys.stderr)

        if "search" in args.cells:
            for conc in args.concurrency:
                app.engine.flush_cache()
                mb0 = app.engine.batcher.to_dict() if app.engine.batcher else {}
                cell = run_cell(app, port, queries, conc, args.duration,
                                index=name)
                cell["cell"] = "search"
                cell["nprobe"] = nprobe
                # PER-CELL microbatch stats (to_dict is cumulative since
                # process start; max_batch_seen stays cumulative — an upper
                # bound for this cell)
                if app.engine.batcher:
                    mb1 = app.engine.batcher.to_dict()
                    cell["microbatch"] = {
                        "batches": mb1["batches"] - mb0.get("batches", 0),
                        "queries": mb1["queries"] - mb0.get("queries", 0),
                        "max_batch_seen_cum": mb1["max_batch_seen"],
                    }
                    bt = cell["microbatch"]["batches"]
                    cell["microbatch"]["avg_batch"] = round(
                        cell["microbatch"]["queries"] / bt, 2) if bt else 0.0
                out["cells"].append(cell)
                print(json.dumps(cell), file=sys.stderr)

        if "cache_hit" in args.cells:
            # the reference's semantic-cache row: repeated identical query,
            # cache ON — every request after the first is an L0 result-cache
            # hit served host-side (ref: 6,121.9 QPS, phase6 summary)
            app.engine.policy.store.update(
                CachePolicyConfig(enable_cache=True, default_ttl_seconds=300)
            )
            app.engine.flush_cache()
            for conc in args.concurrency:
                cell = run_cell(app, port, queries[:1], conc, args.duration,
                                index=name)
                cell["cell"] = "cache_hit"
                cell["nprobe"] = nprobe
                out["cells"].append(cell)
                print(json.dumps(cell), file=sys.stderr)
            app.engine.policy.store.update(
                CachePolicyConfig(enable_cache=False, default_ttl_seconds=60)
            )

    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
