#!/usr/bin/env python
"""End-to-end tour of pyrope_tpu (analog of the reference's
example/pyrope_colab_demo.ipynb).

Covers: the embedded index API, every index family, snapshot/load,
the multi-level cache + policy stack, quotas/degradation, and the
Redis-protocol server.

Run: python examples/quickstart.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pyrope_tpu as pt  # noqa: E402
from pyrope_tpu.server.app import enable_compilation_cache  # noqa: E402

enable_compilation_cache()
rng = np.random.default_rng(42)


def section(title):
    print(f"\n=== {title} ===")


# ---------------------------------------------------------------------------
section("1. Embedded index API — exact Flat scan")
n, dim = 20_000, 128
base = rng.random((n, dim), dtype=np.float32)
ids = [f"doc{i}" for i in range(n)]

flat = pt.FlatIndex(dim, "L2")
flat.add_batch(ids, base)
q = base[123] + 1e-4
for hit in flat.search(q, top_k=3):
    print(f"  {hit.id}  score={hit.score:.4f}")

section("2. IVF-Flat — build + probed search")
ivf = pt.IvfFlatIndex(dim, "L2", nlist=64)
ivf.add_batch(ids, base)
t0 = time.perf_counter()
ivf.build()
print(f"  built in {time.perf_counter()-t0:.1f}s; "
      f"centroids: {ivf.get_centroids().shape}")
print("  nprobe=8 top hit:",
      ivf.search(q, 3, pt.SearchOptions(nprobe=8))[0].id)

section("3. IVF-PQ — 32x compression with ADC scan")
pq = pt.IvfPqIndex(dim, "L2", nlist=64, pq_m=8, ksub=256)
pq.add_batch(ids, base)
pq.build()
print("  top hit:", pq.search(q, 3)[0].id)

section("4. HNSW — native C++ graph build, device beam search")
from pyrope_tpu.native import native_available  # noqa: E402

print("  native builder available:", native_available())
hnsw = pt.HnswIndex(dim, "L2", m=16, ef_construction=100, ef_search=50)
t0 = time.perf_counter()
hnsw.add_batch(ids[:5000], base[:5000])
print(f"  built 5000 in {time.perf_counter()-t0:.1f}s")
print("  top hit:", hnsw.search(q, 3)[0].id)

section("5. Delta LSM — streaming adds, merged search, compaction")
delta = pt.DeltaIndex(pt.FlatIndex(dim, "L2"), pt.IvfFlatIndex(dim, "L2", nlist=64))
delta.add_batch(ids, base)
delta.add("fresh-doc", q)  # lands in the mutable head
print("  pre-compaction:", delta.search(q, 1)[0].id)
delta.build()  # compaction: head rows migrate into the IVF tail
print("  post-compaction:", delta.search(q, 1)[0].id)

section("6. Snapshot / load (all families support it)")
os.makedirs("/tmp/pyrope_demo", exist_ok=True)
flat.snapshot("/tmp/pyrope_demo/flat.npz")
restored = pt.FlatIndex(dim, "L2")
restored.load("/tmp/pyrope_demo/flat.npz")
print("  restored count:", restored.get_stats().count)

section("7. Full engine — cache cascade, quotas, trace")
from pyrope_tpu.cache import StaticPolicyEngine  # noqa: E402
from pyrope_tpu.security import AuthSettings  # noqa: E402
from pyrope_tpu.server.engine import EngineConfig, PyropeEngine  # noqa: E402
from pyrope_tpu.service import TenantQuota  # noqa: E402

eng = PyropeEngine(EngineConfig(auth=AuthSettings(enabled=False)))
eng.policy = StaticPolicyEngine(ttl_seconds=60)
eng.tenants.create("demo", api_key="demo-key",
                   quotas=TenantQuota(max_qps=10_000, priority=0))
eng.create_index("demo", "docs", pt.IndexConfig(dim=dim, algorithm="IVF_FLAT"))
eng.add_batch("demo", "docs", ids, base)
r1 = eng.search("demo", "docs", q, 5, trace=True, request_id="demo-1")
print(f"  miss: {r1.trace.latency_ms:.2f} ms (engine {r1.trace.engine_ms:.2f} ms)")
r2 = eng.search("demo", "docs", q, 5, trace=True, request_id="demo-2")
print(f"  hit:  {r2.trace.latency_ms:.2f} ms via {r2.trace.cache_level}")

section("8. The wire protocol (same grammar as the reference)")
print("""  redis-cli VEC.ADD demo docs doc1 VECTOR '[0.1, ...]' META '{"lang":"en"}' TAGS a,b
  redis-cli VEC.SEARCH demo docs TOPK 10 VECTOR '[0.1, ...]' FILTER a WITH_META TRACE
  curl -H 'X-API-KEY: ...' localhost:8080/v1/indexes/demo/docs/stats
  (start with: python -m pyrope_tpu.server)""")

print("\nDone.")
