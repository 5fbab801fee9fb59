"""Device compute ops: distance/score kernels, top-k, k-means, PQ, quantization.

This package is the accelerator analog of the reference's SIMD kernel library
(ref: src/Pyrope.GarnetServer/Vector/VectorMath.cs) — per-row SIMD loops become
batched matmuls with fused masking and top-k selection.
"""

from pyrope_tpu.ops.distance import normalize_rows, score_convention, score_matrix
from pyrope_tpu.ops.topk import masked_topk, merge_topk, parse_selection

__all__ = [
    "score_matrix",
    "score_convention",
    "normalize_rows",
    "masked_topk",
    "merge_topk",
    "parse_selection",
]


def __getattr__(name):
    # heavier op modules load lazily (kmeans/pq pull in the blocked trainers;
    # pallas_scan pulls in pallas)
    lazy = {
        "kmeans_train": "pyrope_tpu.ops.kmeans",
        "kmeans_assign": "pyrope_tpu.ops.kmeans",
        "ProductQuantizer": "pyrope_tpu.ops.pq",
        "adc_l2_table": "pyrope_tpu.ops.pq",
        "adc_ip_table": "pyrope_tpu.ops.pq",
        "adc_accumulate": "pyrope_tpu.ops.pq",
        "pallas_flat_topk": "pyrope_tpu.ops.pallas_scan",
        "device_i32": "pyrope_tpu.ops.scalars",
    }
    if name in lazy:
        import importlib

        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
