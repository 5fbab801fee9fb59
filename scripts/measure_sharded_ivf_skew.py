#!/usr/bin/env python
"""Measure per-shard probe-path scan work for the two sharded-IVF layouts
(VERDICT r4 #9: the docs/sharded_ivf_layouts.md table should be measured,
not argued).

Runs ENTIRELY on the CPU backend (never touches the card): builds the real
IVF partition (seeded k-means), ranks the real probe sets per query, and
computes each shard's PADDED ROWS SCANNED exactly as the kernels do —
round-robin shards scan nprobe slices of l_pad_rr each (query-independent
by construction); cluster shards scan min(owned, p_cap) slots of l_pad_cl
each (make_sharded_ivf_cluster_probe_search's static shapes), with owned
probes beyond p_cap dropped.

Usage: python scripts/measure_sharded_ivf_skew.py [--n 100000] [--nd 8]
"""

from __future__ import annotations

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from pyrope_tpu.ops.kmeans import kmeans_build  # noqa: E402
from pyrope_tpu.parallel.sharded_ivf import (  # noqa: E402
    cluster_layout,
    roundrobin_layout,
)
from pyrope_tpu.types import Metric  # noqa: E402
from pyrope_tpu.utils.datasets import (  # noqa: E402
    synthetic_clustered,
    synthetic_clustered_queries,
    synthetic_zipf,
    synthetic_zipf_queries,
)
from pyrope_tpu.utils.shapes import round_up  # noqa: E402


def ivf_partition(x: np.ndarray, nlist: int):
    cents, assign, _ = kmeans_build(x, nlist, Metric.L2, seed=42)
    lens = np.bincount(assign, minlength=nlist).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    return cents, lens, offsets


def probe_sets(q: np.ndarray, cents: np.ndarray, nprobe: int) -> np.ndarray:
    d2 = ((q * q).sum(1)[:, None] - 2 * q @ cents.T
          + (cents * cents).sum(1)[None, :])
    return np.argsort(d2, axis=1)[:, :nprobe]


def measure(corpus: str, queries: str, n: int, dim: int, nlist: int,
            nprobe: int, nd: int, n_queries: int) -> dict:
    if corpus == "zipf":
        x = synthetic_zipf(n, dim, n_clusters=nlist)
    else:
        x = synthetic_clustered(n, dim, n_clusters=nlist)
    if queries == "zipf":
        q = synthetic_zipf_queries(n_queries, dim, n_clusters=nlist)
    else:
        q = synthetic_clustered_queries(n_queries, dim, n_clusters=nlist)
    cents, lens, offsets = ivf_partition(x, nlist)
    kpad = int(round_up(nlist, 8))
    lens_p = np.zeros(kpad, np.int32)
    lens_p[:nlist] = lens
    offs_p = np.zeros(kpad, np.int32)
    offs_p[:nlist] = offsets

    probes = probe_sets(q, cents, nprobe)                  # [B, nprobe]

    # round-robin: every shard scans every probe's local slice, padded
    _, _, l_pad_rr, _, _ = roundrobin_layout(lens_p, offs_p, nd, kpad)
    rr_work = np.full(nd, probes.shape[0] * nprobe * l_pad_rr, np.int64)

    # cluster: each shard scans its OWNED probes' full lists, p_cap slots
    _, _, l_pad_cl, _, _, owner = cluster_layout(lens_p, offs_p, nd, kpad)
    p_cap = min(4 * (-(-nprobe // nd)), nprobe)            # index default
    own = owner[probes]                                    # [B, nprobe]
    cl_work = np.zeros(nd, np.int64)
    dropped = 0
    for s in range(nd):
        counts = (own == s).sum(axis=1)                    # owned per query
        cl_work[s] = int(np.minimum(counts, p_cap).sum()) * l_pad_cl
        dropped += int(np.maximum(counts - p_cap, 0).sum())
    return {
        "corpus": corpus, "queries": queries,
        "l_pad_rr": l_pad_rr, "l_pad_cl": l_pad_cl, "p_cap": p_cap,
        "rr": rr_work, "cl": cl_work,
        "drop_pct": 100.0 * dropped / probes.size,
    }


def fmt(work: np.ndarray) -> str:
    m = work.mean()
    return (f"min {work.min()/1e6:7.2f}M  mean {m/1e6:7.2f}M  "
            f"max {work.max()/1e6:7.2f}M  max/mean {work.max()/m:5.2f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--nlist", type=int, default=100)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--nd", type=int, default=8)
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args()

    print(f"n={args.n} dim={args.dim} nlist={args.nlist} "
          f"nprobe={args.nprobe} nd={args.nd} B={args.queries}\n")
    for corpus, queries in (("clustered", "clustered"), ("zipf", "clustered"),
                            ("zipf", "zipf")):
        r = measure(corpus, queries, args.n, args.dim, args.nlist,
                    args.nprobe, args.nd, args.queries)
        print(f"[corpus={corpus:9s} queries={queries:9s}] "
              f"l_pad rr={r['l_pad_rr']} cl={r['l_pad_cl']} "
              f"p_cap={r['p_cap']}")
        print(f"  row-sharded padded rows/shard: {fmt(r['rr'])}")
        print(f"  cluster-LPT padded rows/shard: {fmt(r['cl'])}  "
              f"dropped probes {r['drop_pct']:.2f}%")
        print()


if __name__ == "__main__":
    main()
