#!/usr/bin/env python
"""Benchmark harness — device analog of the reference bench CLI
(ref: src/Pyrope.Benchmarks/Program.cs: dataset load :192-263, timed search
loop with per-query latency capture :344-396, QPS + quantile summary
:169-172), plus recall@10 vs exact ground truth which the reference never
measures (SURVEY §4).

Prints exactly ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
Detailed per-config results go to stderr and BENCH_DETAIL.json (git-ignored).

Default config: IVF-Flat 100k x 128d synthetic, nprobe=96, device batch
4096, topK=10 — the recall-matched serving row (the dense-mask scan runs
wide probes at full-scan cost). The reference's best published number for
this workload is 673.2 QPS at its default nprobe=3 (recall ~0.14;
BASELINE.md). No H100 number is recorded here: see PERF.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from pyrope_tpu.server.app import enable_compilation_cache

BASELINES = {
    # reference QPS numbers from BASELINE.md
    "flat1k": 1894.3,
    "flat10k": 272.5,
    "flat100k": 69.6,
    "ivf100k": 673.2,
    "ivf500k": 192.7,
    "sq8_100k": 461.4,
    "hnsw10k": None,       # reference publishes no HNSW QPS for this shape
    "ivfpq100k": None,
    "ivfpq100k_m16": None,
    "delta20k": None,
    # the reference's 1M-vector run STALLED at 93% load and published no
    # number (docs/benchmarks/20260118_benchmark_500k_ivf.md:43-55); these
    # configs exist to demonstrate the scale headroom
    "flat1m": None,
    "flat1m_approx": None,
    "flat100k_approx": None,
    "delta_hnsw_pq": None,
    # recall-matched composite vs the ref's compacted 460.4 (BASELINE.md:22)
    "delta_hnsw_pq_wide": 460.4,
    "ivf1m": None,  # reference DNF'd at 1M (stalled at 93% load)
    "ivf100k_clustered": None,
    "ivf1m_clustered": None,
    "hnsw100k_clustered": None,
    "hnsw1m_clustered": None,
    # recall-matched operating points: same IVF partition, wider probes —
    # the reference CAN run these (nprobe is a SearchOptions knob there too)
    # but published only nprobe=3; recall_ref is the oracle at the same nprobe
    "ivf100k_np16": 673.2,
    "ivf100k_np32": 673.2,
    "ivf100k_np64": 673.2,
    "ivf100k_np96": 673.2,
    "flat100k_b1024": 69.6,
    "ivf100k_b1024": 673.2,
    "ivf100k_np96_b1024": 673.2,
    "ivf100k_np96_b4096": 673.2,
    "ivfpq100k_b1024": None,
    "ivfpq100k_m16_b1024": None,
    "ivf1m_b1024": None,  # reference DNF'd at 1M
    # recall-matched Delta operating point (VERDICT r2 #5): the reference's
    # Delta compaction benchmark peaks at 460.4 QPS (BASELINE.md:22)
    "delta20k_np96": 460.4,
    # cosine serving row (ref treats cosine first-class, VectorMath.cs:102-125)
    "flat100k_cos_b1024": None,
    # uniform-1M recall frontier: where wide-probe IVF meets the exact scan
    "ivf1m_np256": None,
    # same frontier at the serving batch (a [1024, 1M] dense transient)
    "ivf1m_np256_b1024": None,
    # IVF-PQ at the scale PQ exists for (VERDICT r2 #2): probe-mode ADC
    # kernels; _adc = refine=0 memory-parity pure ADC
    "ivfpq1m_clustered": None,
    "ivfpq1m_adc": None,
    # same int8 workload as sq8_100k (ref P10-14: 461.4 QPS), serving batch
    "sq8_100k_b1024": 461.4,
    "flat100k_ip_b1024": 69.6,  # ref's 100k flat row is the closest analog
    "flat1m_hybrid": None,
    "flat1m_hybrid_b256": None,
    "flat1m_hybrid_k100": None,
    "ivf100k_np96_hybrid_b256": None,
    "ivf1m_np256_hybrid_b256": None,
    # ref P10-13 advanced-SIMD headline: 10k x 1024d exact scan, 147.9 QPS
    "flat10k_d1024_b1024": 147.9,
    "flat100k_d1024_b1024": None,
    "ivf1m_d768_b1024": None,
    # 10x past the reference's practical wall (its 1M run stalled at 93%
    # load and published nothing; docs/benchmarks/20260118_benchmark_500k_ivf.md)
    "flat10m_device_b1024": None,
    "flat10m_device_fp32_b1024": None,
}

# Device-resident scale configs: the corpus is GENERATED IN DEVICE MEMORY
# (seeded jax.random) and served by DeviceFlatIndex — no host slab, no
# upload. 10M x 128 fp32 is 5.1 GB of host memory the host path would have
# to fill and copy; the device path generates it in one kernel. Ground
# truth comes from ops/topk.chunked_exact_topk (XLA fp32-HIGHEST, chunked
# so its score transient fits).
DEVICE_CONFIGS = {
    # name: (n, dim, slab_dtype, batch)
    "flat10m_device_b1024": (10_000_000, 128, "bf16", 1024),
    "flat10m_device_fp32_b1024": (10_000_000, 128, "fp32", 1024),
}

CONFIGS = {
    # name: (algo, n_base, dim, kwargs)
    "flat1k": ("FLAT", 1_000, 128, {}),
    "flat10k": ("FLAT", 10_000, 128, {}),
    "flat100k": ("FLAT", 100_000, 128, {}),
    "sq8_100k": ("FLAT_SQ8", 100_000, 128, {}),
    "ivf100k": ("IVF_FLAT", 100_000, 128, {"nlist": 100}),
    "ivf500k": ("IVF_FLAT", 500_000, 128, {"nlist": 100}),
    "ivfpq100k": ("IVF_PQ", 100_000, 128, {"nlist": 100, "pq_m": 4, "ksub": 256}),
    # quality configuration: 8x compression instead of 32x
    "ivfpq100k_m16": ("IVF_PQ", 100_000, 128, {"nlist": 100, "pq_m": 16, "ksub": 256}),
    "hnsw10k": ("HNSW", 10_000, 128, {"m": 16, "ef_construction": 200, "ef_search": 50}),
    "delta20k": ("DELTA", 20_000, 128, {}),
    "flat1m": ("FLAT", 1_000_000, 128, {}),
    "flat100k_approx": ("FLAT_APPROX", 100_000, 128, {}),
    "flat1m_approx": ("FLAT_APPROX", 1_000_000, 128, {}),
    # BASELINE.json config 5: Delta(head=HNSW, tail=IVF_PQ), streaming adds
    "delta_hnsw_pq": ("DELTA_HNSW_PQ", 20_000, 128, {}),
    # IVF at the scale where the reference DNF'd (train_dtype bf16 speeds
    # the Lloyd iterations; the SEARCH scan stays exact fp32)
    "ivf1m": ("IVF_FLAT", 1_000_000, 128, {"nlist": 1000, "train_dtype": "bfloat16"}),
    # clustered corpus: the realistic ANN regime (recall has headroom)
    "ivf100k_clustered": ("IVF_FLAT", 100_000, 128, {"nlist": 100}),
    # the scale the reference DNF'd at, on data where IVF actually pays:
    # 1M clustered, serving batch (uniform 1M needs ~nprobe 500/1000 for
    # recall 0.9 — that regime belongs to the exact flat1m rows)
    "ivf1m_clustered": ("IVF_FLAT", 1_000_000, 128,
                        {"nlist": 1000, "train_dtype": "bfloat16",
                         "batch": 1024}),
    "hnsw100k_clustered": ("HNSW", 100_000, 128,
                           {"m": 16, "ef_construction": 200, "ef_search": 50}),
    # graph ANN at the reference's DNF scale (native C++ builder; the
    # clustered corpus uses 100 natural clusters — HNSW has no nlist)
    "hnsw1m_clustered": ("HNSW", 1_000_000, 128,
                         {"m": 16, "ef_construction": 200, "ef_search": 50}),
    # nprobe sweep at 100k: the recall-matched headline rows (VERDICT r1 #1)
    "ivf100k_np16": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "nprobe": 16}),
    "ivf100k_np32": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "nprobe": 32}),
    "ivf100k_np64": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "nprobe": 64}),
    "ivf100k_np96": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "nprobe": 96}),
    # device-batch 1024: the throughput-oriented serving shape (the
    # committed r1 rows were all dispatch-bound batch 64)
    "flat100k_b1024": ("FLAT", 100_000, 128, {"batch": 1024}),
    "ivf100k_b1024": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "batch": 1024}),
    # recall-matched headline at the device-throughput batch: the dense-mask
    # scan makes wide probes run at flat-scan speed (see index/ivf_flat.py)
    "ivf100k_np96_b1024": ("IVF_FLAT", 100_000, 128,
                           {"nlist": 100, "nprobe": 96, "batch": 1024}),
    # device batch 4096: each dispatch carries 4x the queries of b1024, so
    # per-dispatch overhead amortizes further — measures whether the
    # recall-matched row is kernel-bound or dispatch-bound
    "ivf100k_np96_b4096": ("IVF_FLAT", 100_000, 128,
                           {"nlist": 100, "nprobe": 96, "batch": 4096}),
    "ivfpq100k_b1024": ("IVF_PQ", 100_000, 128,
                        {"nlist": 100, "pq_m": 4, "ksub": 256, "batch": 1024}),
    "ivfpq100k_m16_b1024": ("IVF_PQ", 100_000, 128,
                            {"nlist": 100, "pq_m": 16, "ksub": 256, "batch": 1024}),
    # 1M at the serving batch: auto scan_mode keeps nprobe=3 on the sparse
    # probe kernel (see index/ivf_flat.pick_scan_mode)
    "ivf1m_b1024": ("IVF_FLAT", 1_000_000, 128,
                    {"nlist": 1000, "train_dtype": "bfloat16", "batch": 1024}),
    # recall-matched Delta: tail SearchOptions(nprobe=96) passes through the
    # composite (ref: DeltaVectorIndex.cs:76-122 forwards options)
    "delta20k_np96": ("DELTA", 20_000, 128, {"opts": {"nprobe": 96}}),
    # recall-matched point of the HNSW+PQ composite (BASELINE.json config 5):
    # tail IVF-PQ honors nprobe, head HNSW honors ef_search through the
    # Delta SearchOptions pass-through (ref: DeltaVectorIndex.cs:76-122)
    "delta_hnsw_pq_wide": ("DELTA_HNSW_PQ", 20_000, 128,
                           {"opts": {"nprobe": 96, "ef_search": 200}}),
    # cosine at the serving batch: exact scan must print recall 1.0
    "flat100k_cos_b1024": ("FLAT_COS", 100_000, 128, {"batch": 1024}),
    # uniform 1M, wide probe, batch 64 (the XLA dense kernel's [B, npad]
    # transient caps the batch — see dense_max_elems): probing ~1/4 of a
    # structureless corpus approaches the exact full scan (flat1m)
    "ivf1m_np256": ("IVF_FLAT", 1_000_000, 128,
                    {"nlist": 1000, "train_dtype": "bfloat16", "nprobe": 256}),
    # the serving-batch point of the same frontier: the XLA dense kernel
    # needs a [1024, 1M] fp32 transient, the probe kernel replicates 256
    # probed lists per query
    "ivf1m_np256_b1024": ("IVF_FLAT", 1_000_000, 128,
                          {"nlist": 1000, "train_dtype": "bfloat16",
                           "nprobe": 256, "batch": 1024}),
    # PQ at 1M clustered: the quality row (m=16 + exact rerank); the ADC
    # kernels are pinned by ivfpq1m_adc (refine=0 pure ADC) and the
    # explicit-probe ivfpq1m_probe row
    "ivfpq1m_clustered": ("IVF_PQ", 1_000_000, 128,
                          {"nlist": 1000, "pq_m": 16, "ksub": 256,
                           "train_dtype": "bfloat16"}),
    # the probed-lists ADC + exact-rerank path, pinned (scan_mode="probe"):
    # measures the ADC shortlist kernels at 1M
    "ivfpq1m_probe": ("IVF_PQ", 1_000_000, 128,
                      {"nlist": 1000, "pq_m": 16, "ksub": 256,
                       "train_dtype": "bfloat16", "scan_mode": "probe",
                       "batch": 256}),
    # memory-lean rerank slab: bf16 halves rerank memory but its ~0.4%
    # rounding reorders near-ties — on clustered data every list member is
    # nearly equidistant, capping recall at 0.71 no matter how wide
    # nprobe/refine go (the fp32 default restores ~IVF-Flat recall)
    "ivfpq1m_bf16slab": ("IVF_PQ", 1_000_000, 128,
                         {"nlist": 1000, "pq_m": 16, "ksub": 256,
                          "train_dtype": "bfloat16",
                          "refine_storage": "bf16"}),
    # residual-SQ8 rerank slab (VERDICT r4 #2): compressed AND high-recall —
    # the per-row quantization step tracks the CLUSTER radius, so the
    # near-tie margins that bf16's relative rounding loses survive. Slab
    # 140 MB at 1Mx128 (vs fp32 516 / bf16 260); total index ~ 160 MB
    "ivfpq1m_sq8res": ("IVF_PQ", 1_000_000, 128,
                       {"nlist": 1000, "pq_m": 16, "ksub": 256,
                        "train_dtype": "bfloat16",
                        "refine_storage": "sq8res", "batch": 256}),
    "ivfpq100k_sq8res_b1024": ("IVF_PQ", 100_000, 128,
                               {"nlist": 100, "pq_m": 16, "ksub": 256,
                                "refine_storage": "sq8res", "batch": 1024}),
    "ivfpq1m_adc": ("IVF_PQ", 1_000_000, 128,
                    {"nlist": 1000, "pq_m": 8, "ksub": 256, "refine": 0,
                     "train_dtype": "bfloat16"}),
    # probe/shortlist width sweeps over the quality index (shared build via
    # opts / one rebuild). Historical note: with the old bf16 rerank slab,
    # np 3->8 and refine 64->128 both left recall at ~0.71-0.72 — the cap
    # was storage rounding, not candidate width (see ivfpq1m_bf16slab)
    "ivfpq1m_np8": ("IVF_PQ", 1_000_000, 128,
                    {"nlist": 1000, "pq_m": 16, "ksub": 256,
                     "train_dtype": "bfloat16", "opts": {"nprobe": 8}}),
    "ivfpq1m_r128": ("IVF_PQ", 1_000_000, 128,
                     {"nlist": 1000, "pq_m": 16, "ksub": 256, "refine": 128,
                      "train_dtype": "bfloat16"}),
    # PQ at 1M at a serving batch: the probe ADC kernels with batched
    # dispatch. NOT directly comparable with the hnsw1m_* rows: clustered
    # corpora track nlist, so this runs on 1000 natural clusters vs
    # HNSW's 100
    "ivfpq1m_clustered_b256": ("IVF_PQ", 1_000_000, 128,
                               {"nlist": 1000, "pq_m": 16, "ksub": 256,
                                "train_dtype": "bfloat16", "batch": 256}),
    # SQ8 at the serving batch (ref headline: 461.4 QPS after int8 kernels,
    # P10-14)
    "sq8_100k_b1024": ("FLAT_SQ8", 100_000, 128, {"batch": 1024}),
    # inner-product at the serving batch: the third first-class metric
    # (L2/COSINE rows exist; ref VectorMath.cs DotProduct :8-37). Exact
    # scan, so recall must print 1.0
    "flat100k_ip_b1024": ("FLAT_IP", 100_000, 128, {"batch": 1024}),
    # hybrid exact: bf16 fused scan top-R + fp32 rerank — recall column must
    # print 1.0 at bf16 scan cost
    "flat1m_hybrid": ("FLAT_HYBRID", 1_000_000, 128, {}),
    "flat1m_hybrid_b256": ("FLAT_HYBRID", 1_000_000, 128, {"batch": 256}),
    "flat1m_hybrid_k100": ("FLAT_HYBRID", 1_000_000, 128,
                           {"batch": 256, "topk": 100}),
    # IVF hybrid at the recall-matched serving point (vs ivf100k_np96_b1024)
    "ivf100k_np96_hybrid_b256": ("IVF_FLAT", 100_000, 128,
                                 {"nlist": 100, "nprobe": 96,
                                  "selection": "hybrid", "batch": 256}),
    # hybrid over a wide (~1000-list) cluster table
    "ivf1m_np256_hybrid_b256": ("IVF_FLAT", 1_000_000, 128,
                                {"nlist": 1000, "train_dtype": "bfloat16",
                                 "nprobe": 256, "selection": "hybrid",
                                 "batch": 256}),
    # high dimension: the regime the reference published its SIMD wins at
    # (10k x 1024d, 147.9 QPS — ref docs/benchmarks/20260118_p10_13
    # _advanced_simd.md:9-15); the matmul, not the selection, carries the
    # FLOPs here
    "flat10k_d1024_b1024": ("FLAT", 10_000, 1024, {"batch": 1024}),
    "flat100k_d1024_b1024": ("FLAT", 100_000, 1024, {"batch": 1024}),
    # embedding-realistic width at 1M (BERT-base 768d), serving batch.
    # CLUSTERED: uniform 768d is structureless (probing 0.3% of a corpus
    # with no clusters finds almost nothing);
    # real embedding corpora are heavily clustered, which is the regime
    # IVF exists for
    "ivf1m_d768_b1024": ("IVF_FLAT", 1_000_000, 768,
                         {"nlist": 1000, "train_dtype": "bfloat16",
                          "batch": 1024}),
    # HNSW 1M at a serving batch (the b64 row's per-iteration gathers are
    # small)
    "hnsw1m_clustered_b256": ("HNSW", 1_000_000, 128,
                              {"m": 16, "ef_construction": 200,
                               "ef_search": 50, "batch": 256}),
    # the 1M quality frontier: same graph, beam widened at query time via
    # SearchOptions.ef_search (ref: mutable EfSearch, HnswVectorIndex.cs:30-40)
    "hnsw1m_clustered_ef200": ("HNSW", 1_000_000, 128,
                               {"m": 16, "ef_construction": 200,
                                "ef_search": 50, "batch": 256,
                                "opts": {"ef_search": 200}}),
    # tiny-batch latency cells (VERDICT r3 #8): HNSW's candidate region is
    # small-batch point lookups where the graph walk touches ~ef*M rows vs
    # the dense scan's nprobe/nlist fraction of the corpus. b1/b8 pairs at
    # 1M clustered pin where (if anywhere) HNSW wins end-to-end — the
    # per-dispatch floor is identical for both, so device_ms_per_batch is
    # the discriminating column
    "hnsw1m_clustered_b1": ("HNSW", 1_000_000, 128,
                            {"m": 16, "ef_construction": 200,
                             "ef_search": 50, "batch": 1}),
    "hnsw1m_clustered_b8": ("HNSW", 1_000_000, 128,
                            {"m": 16, "ef_construction": 200,
                             "ef_search": 50, "batch": 8}),
    "ivf1m_clustered_b1": ("IVF_FLAT", 1_000_000, 128,
                           {"nlist": 1000, "train_dtype": "bfloat16",
                            "batch": 1}),
    "ivf1m_clustered_b8": ("IVF_FLAT", 1_000_000, 128,
                           {"nlist": 1000, "train_dtype": "bfloat16",
                            "batch": 8}),
    # Zipf-skewed natural clusters (see ZIPF set below): same index configs
    # as the balanced clustered rows so skew cost reads directly off the A/B
    "ivf100k_zipf": ("IVF_FLAT", 100_000, 128, {"nlist": 100}),
    "ivf1m_zipf_b1024": ("IVF_FLAT", 1_000_000, 128,
                         {"nlist": 1000, "train_dtype": "bfloat16",
                          "batch": 1024}),
    # probe path under skew: l_pad tracks the LARGEST probed list (~130k
    # rows at Zipf 1.0), the worst case for padded-CSR gathers
    "ivf1m_zipf_probe": ("IVF_FLAT", 1_000_000, 128,
                         {"nlist": 1000, "train_dtype": "bfloat16",
                          "scan_mode": "probe", "batch": 256}),
    "ivfpq1m_zipf_b256": ("IVF_PQ", 1_000_000, 128,
                          {"nlist": 1000, "pq_m": 16, "ksub": 256,
                           "train_dtype": "bfloat16", "batch": 256}),
    # file-backed rows (VERDICT r4 #3): these configs are meant to run with
    # --base-fvecs/--glove pointing at ON-DISK dataset files (written by
    # scripts/make_dataset_files.py, or real SIFT/GloVe when available) —
    # the full FvecsReader/GloveTxtReader -> bench -> recall path the
    # reference exercises on SIFT1M (ref: Program.cs:192-263,
    # FvecsReader.cs:14-58, GloveTxtReader.cs:14-62). n/dim below are
    # placeholders; the file's shape wins. Rows carry a `dataset` field.
    "ivf100k_fvecs_file": ("IVF_FLAT", 100_000, 128,
                           {"nlist": 100, "batch": 1024}),
    "ivf_glove_file": ("IVF_FLAT", 50_000, 100,
                       {"nlist": 100, "batch": 1024}),
}

CLUSTERED = {"ivf100k_clustered", "ivf1m_clustered", "hnsw100k_clustered",
             "hnsw1m_clustered", "ivfpq1m_clustered", "ivfpq1m_adc",
             "ivfpq1m_np8", "hnsw1m_clustered_b256", "hnsw1m_clustered_ef200",
             "ivfpq1m_r128", "ivfpq1m_bf16slab", "ivfpq1m_clustered_b256",
             "ivfpq1m_probe", "hnsw1m_clustered_b1", "hnsw1m_clustered_b8",
             "ivf1m_clustered_b1", "ivf1m_clustered_b8", "ivf1m_d768_b1024",
             "ivfpq1m_sq8res", "ivfpq100k_sq8res_b1024"}
# Zipf(1.0) cluster sizes: the largest natural cluster holds ~13% of the
# corpus (vs 0.1% balanced) — stresses padded-CSR l_pad (VERDICT r3 #7;
# stand-in for SIFT/GloVe skew, which the fvecs loaders support)
ZIPF = {"ivf1m_zipf_b1024", "ivf1m_zipf_probe", "ivfpq1m_zipf_b256",
        "ivf100k_zipf"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_index(algo: str, dim: int, kwargs: dict):
    import pyrope_tpu as pt

    if algo == "FLAT":
        return pt.FlatIndex(dim, "L2")
    if algo == "FLAT_COS":
        # cosine: normalize-at-insert + IP scan (ref: VectorMath.cs:102-125,
        # HnswVectorIndex.cs:69-85 normalize-at-insert convention)
        return pt.FlatIndex(dim, "COSINE")
    if algo == "FLAT_IP":
        # inner-product metric end-to-end (ref: VectorMath.cs DotProduct
        # :8-37; score = dot, BruteForceVectorIndex.cs:350-356)
        return pt.FlatIndex(dim, "IP")
    if algo == "FLAT_APPROX":
        # bf16 slab + lax.approx_max_k (an exact top-k on the GPU)
        return pt.FlatIndex(dim, "L2", storage="bf16", selection="approx:0.95")
    if algo == "FLAT_HYBRID":
        # bf16 fused scan keeps top-R, fp32-HIGHEST rerank restores exact
        # scores/order: recall must be 1.0 at bf16 scan cost
        return pt.FlatIndex(dim, "L2", storage="fp32", selection="hybrid")
    if algo == "FLAT_SQ8":
        return pt.FlatIndex(dim, "L2", storage="sq8")
    if algo == "IVF_FLAT":
        return pt.IvfFlatIndex(dim, "L2", **kwargs)
    if algo == "IVF_PQ":
        return pt.IvfPqIndex(dim, "L2", **kwargs)
    if algo == "HNSW":
        return pt.HnswIndex(dim, "L2", **kwargs)
    if algo == "DELTA":
        return pt.DeltaIndex(
            pt.FlatIndex(dim, "L2"),
            pt.IvfFlatIndex(dim, "L2", nlist=100),
        )
    if algo == "DELTA_HNSW_PQ":  # BASELINE.json config 5
        return pt.DeltaIndex(
            pt.HnswIndex(dim, "L2", m=16, ef_construction=200, ef_search=50),
            pt.IvfPqIndex(dim, "L2", nlist=100, pq_m=4, ksub=256),
        )
    raise ValueError(f"unknown algo {algo}")


def scan_tflops(batch, n_rows, dim, device_ms, scan_path):
    """Achieved TFLOP/s of the score matmul for rows whose kernel scans the
    whole slab (flat/dense/device paths): 2·B·N·D FLOPs ÷ pipelined device
    time. None for probe/graph/ADC paths, where a full-scan FLOPs estimate
    would overstate utilization (VERDICT r3 #5: track MFU per row)."""
    if not device_ms or not scan_path:
        return None
    if not scan_path.startswith(("dense", "device", "flat")):
        return None
    return round(2.0 * batch * n_rows * dim / (device_ms * 1e9), 3)


_ORACLE_CACHE: dict = {}


def _oracle_key(base, *params):
    # dataset fingerprint: shape + corner samples (exact array compare would
    # copy); identical seeds produce identical corners
    return (base.shape, float(base[0, 0]), float(base[-1, -1]), *params)


def oracle_recall(algo, kwargs, base, gt_q, truth, topk, idx,
                  oracle_max_n=200_000):
    """recall@k of the REFERENCE's algorithm on the same data at the same
    hyperparameters (CPU oracle, pyrope_tpu/utils/ref_oracle.py — cited
    reference semantics; VERDICT r1 #1). None = oracle not applicable
    (exact families score 1.0 by construction) or corpus too large for the
    CPU oracle."""
    import numpy as np

    from pyrope_tpu.utils import ref_oracle as ro
    from pyrope_tpu.utils.datasets import recall_at_k

    if base.shape[0] > oracle_max_n:
        # CPU Lloyd at 1M x nlist=1000 is minutes of single-core work: off
        # by default, opt in per run with --oracle-max-n (rows are merged
        # into BENCH_DETAIL, so one slow run back-fills recall_ref for good)
        return None
    if algo == "IVF_FLAT":
        # the nprobe sweep shares one partition — memoize the CPU k-means
        # (minutes of redundant single-core work per --all sweep otherwise)
        key = _oracle_key(base, "ivf", kwargs.get("nlist", 100))
        if key not in _ORACLE_CACHE:
            _ORACLE_CACHE[key] = ro.ref_ivf_build(base, kwargs.get("nlist", 100), seed=42)
        cents, lists = _ORACLE_CACHE[key]
        rows = np.stack([
            ro.ref_ivf_search(base, cents, lists, q, kwargs.get("nprobe", 3), topk)
            for q in gt_q
        ])
    elif algo == "IVF_PQ":
        key = _oracle_key(base, "ivfpq", kwargs.get("nlist", 100),
                          kwargs.get("pq_m", 4), kwargs.get("ksub", 256))
        if key not in _ORACLE_CACHE:
            _ORACLE_CACHE[key] = ro.ref_ivfpq_build(
                base, kwargs.get("nlist", 100), kwargs.get("pq_m", 4),
                kwargs.get("ksub", 256),
            )
        cents, lists, cbs, codes = _ORACLE_CACHE[key]
        rows = np.stack([
            ro.ref_ivfpq_search(cents, lists, cbs, codes, q,
                                kwargs.get("nprobe", 3), topk)
            for q in gt_q
        ])
    elif algo == "FLAT_SQ8":
        # reference SQ8 scores raw bytes (query quantized on its own
        # min/max, both affine transforms dropped — BruteForceVectorIndex
        # .cs:297-331); the rebuild's exact affine decomposition scores the
        # true quantized values, so this column shows the semantic gap
        key = _oracle_key(base, "sq8")
        if key not in _ORACLE_CACHE:
            _ORACLE_CACHE[key] = ro.ref_sq8_build(base)
        codes, code_sq = _ORACLE_CACHE[key]
        rows = np.stack([
            ro.ref_sq8_search(codes, code_sq, q, topk) for q in gt_q
        ])
    elif algo == "HNSW":
        rows = np.stack([
            ro.ref_hnsw_search(idx, q, kwargs.get("ef_search", 10), topk)
            for q in gt_q
        ])
    elif algo == "DELTA":
        # bench deltas are fully compacted before search (head empty), so
        # the reference analog is its tail: IVF-Flat nlist=100 at the same
        # nprobe the row runs (SearchOptions pass-through, ref
        # DeltaVectorIndex.cs:76-122)
        key = _oracle_key(base, "ivf", 100)
        if key not in _ORACLE_CACHE:
            _ORACLE_CACHE[key] = ro.ref_ivf_build(base, 100, seed=42)
        cents, lists = _ORACLE_CACHE[key]
        np_eff = kwargs.get("nprobe", 3)
        rows = np.stack([
            ro.ref_ivf_search(base, cents, lists, q, np_eff, topk)
            for q in gt_q
        ])
    elif algo == "DELTA_HNSW_PQ":
        # compacted tail = IVF-PQ (nlist=100, m=4, ksub=256); the reference
        # scores pure ADC (no rerank stage)
        key = _oracle_key(base, "ivfpq", 100, 4, 256)
        if key not in _ORACLE_CACHE:
            _ORACLE_CACHE[key] = ro.ref_ivfpq_build(base, 100, 4, 256)
        cents, lists, cbs, codes = _ORACLE_CACHE[key]
        np_eff = kwargs.get("nprobe", 3)  # SearchOptions pass-through rows
        rows = np.stack([
            ro.ref_ivfpq_search(cents, lists, cbs, codes, q, np_eff, topk)
            for q in gt_q
        ])
    else:
        return None
    return round(recall_at_k(rows, truth, topk), 4)


def hnsw_e2e_oracle(base, kwargs, gt_q, truth, topk, metric="L2"):
    """End-to-end reference HNSW recall: build a CLOSEST-M graph
    (neighbor_heuristic=False — the reference's SelectNeighbors,
    HnswVectorIndex.cs:327-331) and run the sequential reference search on
    it (greedy descent + best-first SearchLayer, :229-325). This measures
    what the reference itself would score on this data, unlike recall_ref
    which isolates beam-vs-sequential on the rebuild's (better) graph."""
    import pyrope_tpu as pt
    from pyrope_tpu.utils import ref_oracle as ro
    from pyrope_tpu.utils.datasets import recall_at_k

    key = _oracle_key(base, "hnsw_ref", kwargs.get("m", 16),
                      kwargs.get("ef_construction", 200))
    if key not in _ORACLE_CACHE:
        ref_idx = pt.HnswIndex(
            base.shape[1], metric,
            m=kwargs.get("m", 16),
            ef_construction=kwargs.get("ef_construction", 200),
            ef_search=kwargs.get("ef_search", 10),
            neighbor_heuristic=False,
        )
        log(f"  [e2e oracle] building closest-M graph over {base.shape[0]} rows...")
        ref_idx.add_batch([str(i) for i in range(base.shape[0])], base)
        _ORACLE_CACHE[key] = ref_idx
    ref_idx = _ORACLE_CACHE[key]
    ef = kwargs.get("ef_search", 10)
    rows = np.stack([ro.ref_hnsw_search(ref_idx, q, ef, topk) for q in gt_q])
    return round(recall_at_k(rows, truth, topk), 4)


def measure_device_search(idx, q_dev, topk, opts, duration_s, batch):
    """Timed search section shared by run_config and the device-scale
    runner: pipelined-throughput QPS + 200-sample blocking latency."""
    import jax

    from pyrope_tpu.utils.stats import LatencySummary

    n_slices = len(q_dev)

    def fetch(out):
        # device execution is in order: the LAST result's completion
        # fences every earlier dispatch
        return jax.block_until_ready(out)

    # warmup / compile
    fetch(idx.device_search(q_dev[0], topk, opts))

    # Throughput: pipelined async dispatch, one completion fence at the end.
    # This is the device analog of the reference's 4 concurrent client workers
    # (ref Program.cs :344-396) — outstanding requests keep the device busy.
    calib_iters = 32
    t0 = time.perf_counter()
    outs = [idx.device_search(q_dev[i % n_slices], topk, opts) for i in range(calib_iters)]
    fetch(outs[-1])
    per_iter = (time.perf_counter() - t0) / calib_iters
    iters = max(calib_iters, min(int(duration_s / per_iter), 20000))
    t0 = time.perf_counter()
    outs = [idx.device_search(q_dev[i % n_slices], topk, opts) for i in range(iters)]
    fetch(outs[-1])
    total_s = time.perf_counter() - t0
    qps = iters * batch / total_s
    # pipelined per-batch time: the kernel+dispatch figure
    device_ms_per_batch = round(total_s / iters * 1e3, 4)

    # Latency: per-batch blocking round trip incl. result fetch. 200
    # samples: with 30 draws p99 degenerates to max (VERDICT r2 weak #6).
    lat_ms = []
    for i in range(200):
        t0 = time.perf_counter()
        fetch(idx.device_search(q_dev[i % n_slices], topk, opts))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    return qps, device_ms_per_batch, LatencySummary.from_samples(lat_ms)


def run_device_config(
    name: str, topk: int, duration_s: float, index_cache: dict | None = None,
) -> dict:
    """Device-resident scale row (see DEVICE_CONFIGS): generate the corpus
    on the device, serve it with DeviceFlatIndex, verify against the chunked XLA
    exact ground truth. No host slab and no reference oracle exist at this
    scale — recall_at_k IS measured (vs chunked_exact_topk over the fp32
    corpus, 256 queries), recall_ref stays null."""
    import jax
    import jax.numpy as jnp

    import pyrope_tpu as pt
    from pyrope_tpu.ops.topk import chunked_exact_topk
    from pyrope_tpu.utils.datasets import (
        id_lists_to_rows,
        recall_at_k,
        synthetic_queries,
    )
    n, dim, slab_dtype, batch = DEVICE_CONFIGS[name]
    log(f"[{name}] device-resident: n={n} dim={dim} slab={slab_dtype} batch={batch}")

    cache = index_cache if index_cache is not None else {}
    gen_key = ("devgen", n, dim)
    if gen_key in cache:
        xf, sq_f, alive_f, truth_v, truth_i, load_s = cache[gen_key]
    else:
        t0 = time.perf_counter()
        xf = jax.random.uniform(jax.random.PRNGKey(42), (n, dim), jnp.float32)
        jax.block_until_ready(xf)
        load_s = time.perf_counter() - t0
        log(f"[{name}] generated {n}x{dim} fp32 on the device: {load_s:.2f}s "
            f"({4*n*dim/2**30:.2f} GiB)")
        sq_f = jnp.sum(xf * xf, axis=1)
        alive_f = jnp.ones(n, bool)
        truth_v = truth_i = None
        cache[gen_key] = (xf, sq_f, alive_f, truth_v, truth_i, load_s)

    t0 = time.perf_counter()
    slab = xf if slab_dtype == "fp32" else xf.astype(jnp.bfloat16)
    idx = pt.DeviceFlatIndex(slab, "L2", n_valid=n)
    jax.block_until_ready(idx._dev["sqnorm"])  # fence construction for build_s
    build_s = time.perf_counter() - t0
    log(f"[{name}] index built (sqnorm+mask): {build_s:.2f}s")

    queries = synthetic_queries(batch, dim)
    q_dev = [jnp.asarray(queries)]
    opts = pt.SearchOptions()
    qps, device_ms_per_batch, summary = measure_device_search(
        idx, q_dev, topk, opts, duration_s, batch
    )

    # ground truth from the fp32 corpus (shared across the bf16/fp32 rows):
    # chunked XLA fp32-HIGHEST scan
    n_truth = min(batch, 256)  # [256, 1M-chunk] fp32 transient = 1 GiB
    if truth_v is None:
        log(f"[{name}] computing chunked exact ground truth ({n_truth} queries)...")
        truth_v, truth_i = chunked_exact_topk(
            xf, sq_f, alive_f, q_dev[0][:n_truth], topk, "L2"
        )
        cache[gen_key] = (xf, sq_f, alive_f, truth_v, truth_i, load_s)
    vals, rows = idx.device_search(q_dev[0][:n_truth], topk, opts)
    id_lists = idx.resolve_rows(np.asarray(rows))
    recall = recall_at_k(id_lists_to_rows(id_lists), truth_i[:, :topk], topk)

    out = {
        "config": name,
        "algo": "FLAT_DEVICE",
        "n_base": n,
        "dim": dim,
        "batch": batch,
        "topk": topk,
        "qps": round(qps, 1),
        "device_ms_per_batch": device_ms_per_batch,
        "recall_at_k": round(recall, 4),
        "recall_ref": None,
        "n_oracle": 0,
        "n_truth": n_truth,
        "load_s": round(load_s, 3),
        "build_s": round(build_s, 3),
        "latency_batch_ms": summary.to_dict(),
        "baseline_qps": BASELINES.get(name),
        "scan_path": idx.describe_scan(batch),
        "tflops": scan_tflops(batch, n, dim, device_ms_per_batch,
                              idx.describe_scan(batch)),
        "memory_bytes": idx.memory_bytes(),
        "note": (
            "device-resident corpus (no host slab; generated on the device, "
            "seed 42); recall vs chunked XLA fp32 exact ground truth over "
            f"{n_truth} queries — 10x the reference's 1M practical wall"
        ),
    }
    log(f"[{name}] QPS={qps:,.1f} recall@{topk}={recall:.4f} "
        f"p50={summary.p50_ms:.2f}ms p99={summary.p99_ms:.2f}ms")
    return out


def run_config(
    name: str, batch: int, topk: int, n_queries: int, duration_s: float,
    base_fvecs: str | None = None, query_fvecs: str | None = None,
    base_limit: int | None = None, with_oracle: bool = True,
    oracle_max_n: int = 200_000, index_cache: dict | None = None,
    glove_src: str | None = None,
) -> dict:
    import pyrope_tpu as pt
    from pyrope_tpu.utils.datasets import (
        ground_truth,
        read_fvecs,
        recall_at_k,
        synthetic,
        synthetic_queries,
    )

    algo, n_base, dim, kwargs = CONFIGS[name]
    kwargs = dict(kwargs)
    batch = kwargs.pop("batch", batch)  # per-config device-batch override
    topk = kwargs.pop("topk", topk)     # per-config k (e.g. the wide-k row)
    # per-config SearchOptions (e.g. the recall-matched Delta tail nprobe);
    # merged into the oracle's view so both sides run the same knobs
    opt_kwargs = kwargs.pop("opts", {})
    metric = {"FLAT_COS": "COSINE", "FLAT_IP": "IP"}.get(algo, "L2")

    dataset = None
    if base_fvecs:  # real dataset (e.g. SIFT1M .fvecs) replaces synthetic
        base = read_fvecs(base_fvecs, limit=base_limit or n_base)
        n_base, dim = base.shape
        queries = (
            read_fvecs(query_fvecs, limit=max(n_queries, batch))
            if query_fvecs
            else synthetic_queries(max(n_queries, batch), dim)
        )
        if queries.shape[1] != dim:
            raise SystemExit(
                f"query dim {queries.shape[1]} != base dim {dim} in {query_fvecs}"
            )
        if len(queries) < batch:  # short query files tile up to one batch
            reps = -(-batch // len(queries))
            queries = np.tile(queries, (reps, 1))[:batch]
        log(f"[{name}] fvecs dataset: {base.shape} base, {queries.shape} queries")
        # record the loader in the row: a file-backed QPS/recall number must
        # name its dataset path (ref: Program.cs:192-232 --dataset sift)
        dataset = {
            "loader": "glove-txt" if glove_src else "fvecs",
            "base_file": os.path.basename(glove_src or base_fvecs),
            "query_file": (os.path.basename(query_fvecs)
                           if query_fvecs else None),
        }
    elif name in CLUSTERED:
        from pyrope_tpu.utils.datasets import (
            synthetic_clustered,
            synthetic_clustered_queries,
        )

        # natural-cluster count tracks nlist (100 at 100k, 1000 at 1M) so
        # the corpus structure matches what the index can resolve
        nc = kwargs.get("nlist", 100)
        base = synthetic_clustered(n_base, dim, n_clusters=nc)
        queries = synthetic_clustered_queries(max(n_queries, batch), dim,
                                              n_clusters=nc)
    elif name in ZIPF:
        from pyrope_tpu.utils.datasets import (
            synthetic_zipf,
            synthetic_zipf_queries,
        )

        nc = kwargs.get("nlist", 100)
        base = synthetic_zipf(n_base, dim, n_clusters=nc)
        queries = synthetic_zipf_queries(max(n_queries, batch), dim,
                                         n_clusters=nc)
    else:
        base = synthetic(n_base, dim)
        queries = synthetic_queries(max(n_queries, batch), dim)
    log(f"[{name}] algo={algo} n={n_base} dim={dim} batch={batch} topk={topk}")
    # configs that differ only in serving knobs (batch, SearchOptions)
    # share one built index within a --configs run: a 1M HNSW bootstrap
    # build costs ~10 min, and rebuilding it per serving shape measures
    # nothing new. load_s/build_s are copied from the original build and
    # the row is marked build_cached so readers know.
    cache_key = (algo, n_base, dim,
                 tuple(sorted((k, repr(v)) for k, v in kwargs.items())),
                 name in CLUSTERED, base_fvecs, base_limit)
    cached = index_cache.get(cache_key) if index_cache is not None else None
    build_cached = cached is not None
    if build_cached:
        idx, load_s, build_s = cached
        log(f"[{name}] reusing built index (load {load_s:.2f}s / "
            f"build {build_s:.2f}s from the first run)")
    else:
        idx = build_index(algo, dim, kwargs)

        t0 = time.perf_counter()
        idx.add_batch([str(i) for i in range(n_base)], base)
        load_s = time.perf_counter() - t0
        log(f"[{name}] load: {load_s:.2f}s ({n_base/load_s:,.0f} vec/s)")

        t0 = time.perf_counter()
        idx.build()
        build_s = time.perf_counter() - t0
        log(f"[{name}] build: {build_s:.2f}s")
        if index_cache is not None:
            index_cache[cache_key] = (idx, load_s, build_s)

    import jax.numpy as jnp

    opts = pt.SearchOptions(**opt_kwargs)
    n_slices = max(len(queries) // batch, 1)
    # Pre-slice the device-resident query batches ONCE: a per-iteration
    # q_dev[i % n_slices] would dispatch a separate slice op ahead of every
    # search, and that harness overhead would read as index time.
    q_dev = [
        jnp.asarray(queries[i * batch : (i + 1) * batch]) for i in range(n_slices)
    ]

    qps, device_ms_per_batch, summary = measure_device_search(
        idx, q_dev, topk, opts, duration_s, batch
    )

    # recall/oracle evaluation over >= 256 queries even when the serving
    # batch is smaller: an n=64 recall estimate carries a ±0.04-0.06
    # sampling band at k=10, wider than some engine-vs-oracle margins the
    # rows are quoted for (VERDICT r3 #9). The extra device_search below is
    # untimed, so the widened eval batch never touches the QPS columns.
    n_eval = max(batch, min(len(queries), 256))
    gt_q = queries[:n_eval]
    truth = ground_truth(base, gt_q, topk, metric)
    q_eval = q_dev[0] if n_eval == batch else jnp.asarray(gt_q)
    vals, rows = idx.device_search(q_eval, topk, opts)
    id_lists = idx.resolve_rows(np.asarray(rows))
    from pyrope_tpu.utils.datasets import id_lists_to_rows

    recall = recall_at_k(id_lists_to_rows(id_lists), truth, topk)

    # the reference-semantics oracle is a per-query Python loop on the ONE
    # host core — cap its query count so large-batch configs don't spend
    # minutes of CPU re-proving the same partition (recall_at_k above still
    # uses the full eval batch; n_oracle is recorded in the row so readers
    # can judge the sampling band when comparing columns — ADVICE r2)
    n_oracle = min(len(gt_q), 256)
    oracle_kwargs = {**kwargs, **opt_kwargs}
    recall_ref = (
        oracle_recall(algo, oracle_kwargs, base, gt_q[:n_oracle],
                      truth[:n_oracle], topk, idx, oracle_max_n=oracle_max_n)
        if with_oracle else None
    )
    # end-to-end reference oracle for HNSW (VERDICT r2 #4): the sequential
    # reference search on a closest-M graph — "what the reference would
    # score", complementing recall_ref's beam-vs-sequential-on-same-graph
    recall_ref_e2e = (
        hnsw_e2e_oracle(base, oracle_kwargs, gt_q[:n_oracle],
                        truth[:n_oracle], topk, metric)
        if with_oracle and algo == "HNSW" and n_base <= oracle_max_n
        else None
    )

    out = {
        "config": name,
        "algo": algo,
        "n_base": n_base,
        "dim": dim,
        "batch": batch,
        "topk": topk,
        "qps": round(qps, 1),
        "device_ms_per_batch": device_ms_per_batch,
        "recall_at_k": round(recall, 4),
        "recall_ref": recall_ref,
        "n_oracle": n_oracle if with_oracle else 0,
        "n_eval": n_eval,
        "load_s": round(load_s, 3),
        "build_s": round(build_s, 3),
        "latency_batch_ms": summary.to_dict(),
        "baseline_qps": BASELINES.get(name),
    }
    if recall_ref_e2e is not None:
        out["recall_ref_e2e"] = recall_ref_e2e
    if dataset is not None:
        out["dataset"] = dataset
    if build_cached:
        out["build_cached"] = True
    if hasattr(idx, "describe_scan"):
        # the code path this row measured (e.g. IVF-PQ dense rows with
        # refine>0 exact-scan the rerank slab and never touch ADC)
        out["scan_path"] = idx.describe_scan(batch, opt_kwargs.get("nprobe"))
        out["tflops"] = scan_tflops(batch, n_base, dim, device_ms_per_batch,
                                    out["scan_path"])
    if hasattr(idx, "memory_bytes"):
        out["memory_bytes"] = idx.memory_bytes()
    log(f"[{name}] QPS={qps:,.1f} recall@{topk}={recall:.4f} "
        f"recall_ref={recall_ref} "
        f"p50={summary.p50_ms:.2f}ms p99={summary.p99_ms:.2f}ms")
    return out


def _merge_detail(results: list[dict]) -> None:
    """Merge rows into BENCH_DETAIL.json keyed by (config, batch) so
    single-config runs don't clobber the full sweep."""
    detail = []
    try:
        with open("BENCH_DETAIL.json") as f:
            detail = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    for r in detail:
        # pre-r4 rows stored recall under 'recall_at_10' even for k=100
        # rows (ADVICE r3): migrate to the k-keyed name on every merge
        if "recall_at_10" in r:
            r["recall_at_k"] = r.pop("recall_at_10")
    merged = {(r["config"], r["batch"]): r for r in detail}
    for r in results:
        # recall_ref is deterministic per config (seeded data + reference
        # semantics), so a re-run that skipped the oracle (e.g. a 1M row
        # under the default --oracle-max-n) keeps the backfilled value
        # from scripts/oracle_backfill.py instead of clobbering it to null
        old = merged.get((r["config"], r["batch"]))
        if old is not None and r.get("recall_ref") is None:
            for k in ("recall_ref", "n_oracle", "recall_ref_e2e"):
                if old.get(k) not in (None, 0):
                    r[k] = old[k]
        merged[(r["config"], r["batch"])] = r
    with open("BENCH_DETAIL.json", "w") as f:
        json.dump(sorted(merged.values(),
                         key=lambda r: (r["config"], r["batch"])), f, indent=2)


def main() -> None:
    ap = argparse.ArgumentParser()
    # Default: the recall-matched IVF row at batch 4096 (each dispatch
    # carries 4x the queries of b1024, so per-dispatch overhead amortizes)
    ap.add_argument("--config", default="ivf100k_np96_b4096",
                    choices=sorted(list(CONFIGS) + list(DEVICE_CONFIGS)))
    ap.add_argument("--configs", default=None,
                    help="comma-separated config list run in ONE process "
                         "(shares compiles and built indexes across rows)")
    ap.add_argument("--all", action="store_true", help="run every config")
    ap.add_argument("--quick", action="store_true", help="small fast sanity run")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--duration", type=float, default=5.0)
    # real datasets (ref harness: --dataset sift/glove, Program.cs:192-263)
    ap.add_argument("--base-fvecs", default=None, help="SIFT-style .fvecs base file")
    ap.add_argument("--query-fvecs", default=None, help=".fvecs query file")
    ap.add_argument("--glove", default=None,
                    help="GloVe .txt base file (ref Program.cs:192-232)")
    ap.add_argument("--base-limit", type=int, default=None)
    ap.add_argument("--oracle-max-n", type=int, default=200_000,
                    help="largest corpus the CPU reference oracle runs on")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the reference-semantics recall oracle")
    args = ap.parse_args()
    enable_compilation_cache()

    if args.glove:
        # convert once to fvecs-equivalent flow: read tokens+vectors and
        # feed through the same path as --base-fvecs
        if args.base_fvecs:
            raise SystemExit("--glove and --base-fvecs are mutually exclusive")
        import atexit
        import tempfile

        from pyrope_tpu.utils.datasets import read_glove_txt, write_fvecs

        _, vecs = read_glove_txt(args.glove, limit=args.base_limit)
        tmp = tempfile.NamedTemporaryFile(suffix=".fvecs", delete=False)
        atexit.register(lambda p=tmp.name: os.unlink(p) if os.path.exists(p) else None)
        write_fvecs(tmp.name, vecs)
        args.base_fvecs = tmp.name
        args.glove_src = args.glove  # rows record the ORIGINAL txt loader

    if args.quick:
        names = ["flat10k"]
        args.duration = min(args.duration, 2.0)
    elif args.all:
        names = list(CONFIGS)
    elif args.configs:
        names = [n.strip() for n in args.configs.split(",") if n.strip()]
        unknown = [n for n in names if n not in CONFIGS and n not in DEVICE_CONFIGS]
        if unknown:
            raise SystemExit(f"unknown configs: {unknown}")
    else:
        names = [args.config]

    index_cache: dict = {}
    results = []
    for n in names:
        r = (run_device_config(n, args.topk, args.duration,
                               index_cache=index_cache)
             if n in DEVICE_CONFIGS
             else run_config(
                 n, args.batch, args.topk, args.queries, args.duration,
                 base_fvecs=args.base_fvecs, query_fvecs=args.query_fvecs,
                 base_limit=args.base_limit, with_oracle=not args.no_oracle,
                 oracle_max_n=args.oracle_max_n, index_cache=index_cache,
                 glove_src=getattr(args, "glove_src", None),
             ))
        results.append(r)
        # merge after EVERY row, not at process end: a killed run must not
        # lose the rows already measured
        _merge_detail([r])

    head = next((r for r in results if r["config"] == "ivf100k"), results[0])
    baseline = head["baseline_qps"]
    line = {
        "metric": f"search_qps_{head['config']}_batch{head['batch']}",
        "value": head["qps"],
        "unit": "qps",
        "vs_baseline": round(head["qps"] / baseline, 2) if baseline else None,
    }
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
