#!/usr/bin/env python
"""Profile the batched HNSW beam search on the device.

This script isolates where a beam batch spends its time — upper descent
vs layer-0 steps vs the
visited-set scatter/gather vs result fetch — by timing jitted stage
variants, and optionally writes an xprof trace for the full search.

Usage:
    python scripts/profile_hnsw.py [--n 100000] [--batch 256] [--ef 50]
        [--xprof /tmp/hnsw_trace]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pyrope_tpu.server.app import enable_compilation_cache  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ef", type=int, default=50)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--xprof", default=None,
                    help="directory for a jax.profiler trace of one batch")
    args = ap.parse_args()

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from pyrope_tpu.index.hnsw import HnswIndex, beam_schedule
    from pyrope_tpu.types import SearchOptions
    from pyrope_tpu.utils.datasets import (
        synthetic_clustered,
        synthetic_clustered_queries,
    )

    base = synthetic_clustered(args.n, args.dim)
    queries = synthetic_clustered_queries(args.batch, args.dim)
    idx = HnswIndex(args.dim, "L2", m=16, ef_construction=200,
                    ef_search=args.ef)
    t0 = time.perf_counter()
    idx.add_batch([str(i) for i in range(args.n)], base)
    print(f"build: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    q = jnp.asarray(queries)
    opts = SearchOptions(ef_search=args.ef)
    # warm + fence
    vals, rows = idx.device_search(q, 10, opts)
    jax.block_until_ready(vals)

    t0 = time.perf_counter()
    for _ in range(args.reps):
        vals, rows = idx.device_search(q, 10, opts)
    np.asarray(vals)
    dt = time.perf_counter() - t0
    pool, steps = beam_schedule(args.ef, 10)
    print(f"beam: pool={pool} steps={steps} "
          f"{args.reps} x b{args.batch} in {dt:.3f}s -> "
          f"{args.reps * args.batch / dt:.0f} QPS")

    if args.xprof:
        with jax.profiler.trace(args.xprof):
            vals, rows = idx.device_search(q, 10, opts)
            np.asarray(vals)
        print(f"xprof trace written to {args.xprof}")


if __name__ == "__main__":
    main()
