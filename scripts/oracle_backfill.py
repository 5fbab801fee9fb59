#!/usr/bin/env python
"""Backfill recall_ref for bench rows whose corpus exceeds the default
oracle cap (--oracle-max-n 200k) — the opt-in 1M oracle run, decoupled
from the device bench so the card is never held hostage to hours of
single-core CPU k-means (VERDICT r2 #2: "recall_ref from one opt-in
--oracle-max-n 1000000 run").

Runs ENTIRELY on the CPU backend: the corpus is deterministic (seeded
synthetic/clustered generators), the reference oracle is pure numpy
(pyrope_tpu/utils/ref_oracle.py), and ground truth is a blocked numpy
scan — so this process reproduces exactly the data a bench row measured
without touching the device. Results are merged into the existing
BENCH_DETAIL.json rows (recall_ref + n_oracle updated in place).

Usage:
    python scripts/oracle_backfill.py ivf1m_np256 ivfpq1m_clustered ivfpq1m_adc
"""

from __future__ import annotations

import json
import os
import sys
import time

# Force the CPU backend BEFORE pyrope_tpu import: even importing the
# package creates device arrays, and a second JAX process on the card
# fails for want of memory while a bench holds it.
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402
from pyrope_tpu.utils.datasets import (  # noqa: E402
    ground_truth,
    recall_at_k,
    synthetic,
    synthetic_clustered,
    synthetic_clustered_queries,
    synthetic_queries,
)


def backfill(name: str, topk: int = 10, n_queries: int = 1024) -> dict:
    algo, n_base, dim, kwargs = bench.CONFIGS[name]
    kwargs = dict(kwargs)
    batch = kwargs.pop("batch", 64)  # bench.py default --batch
    opt_kwargs = kwargs.pop("opts", {})
    if algo not in ("IVF_FLAT", "IVF_PQ", "DELTA", "FLAT_SQ8"):
        raise SystemExit(f"{name}: algo {algo} needs the built index; "
                         "run its oracle inside bench.py instead")
    if name in bench.CLUSTERED:
        nc = kwargs.get("nlist", 100)
        base = synthetic_clustered(n_base, dim, n_clusters=nc)
        queries = synthetic_clustered_queries(max(n_queries, batch), dim,
                                              n_clusters=nc)
    else:
        base = synthetic(n_base, dim)
        queries = synthetic_queries(max(n_queries, batch), dim)

    gt_q = queries[:batch]
    n_oracle = min(len(gt_q), 256)
    print(f"[{name}] ground truth over {n_oracle} queries x {n_base} rows...",
          flush=True)
    t0 = time.perf_counter()
    truth = ground_truth(base, gt_q[:n_oracle], topk, "L2")
    print(f"[{name}] ground truth: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    recall_ref = bench.oracle_recall(
        algo, {**kwargs, **opt_kwargs}, base, gt_q[:n_oracle],
        truth, topk, idx=None, oracle_max_n=n_base,
    )
    print(f"[{name}] oracle: recall_ref={recall_ref} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return {"config": name, "batch": batch, "recall_ref": recall_ref,
            "n_oracle": n_oracle}


def main() -> None:
    names = sys.argv[1:]
    if not names:
        raise SystemExit(__doc__)
    detail_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               os.pardir, "BENCH_DETAIL.json")
    results = [backfill(n) for n in names]
    with open(detail_path) as f:
        detail = json.load(f)
    # BENCH_DETAIL is keyed (config, batch): the oracle's query subset is
    # queries[:batch][:256], so a result only describes the row measured at
    # the SAME batch (a --batch override rerun creates sibling rows)
    by_key = {(r["config"], r.get("batch")): r for r in detail}
    for res in results:
        row = by_key.get((res["config"], res["batch"]))
        if row is None:
            print(f"WARNING: no bench row for {res['config']} at batch "
                  f"{res['batch']} — oracle result not merged (run the bench "
                  f"config first)", flush=True)
            continue
        row["recall_ref"] = res["recall_ref"]
        row["n_oracle"] = res["n_oracle"]
    with open(detail_path, "w") as f:
        json.dump(detail, f, indent=2)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
