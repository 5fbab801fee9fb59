"""pyrope_tpu — an accelerator-native vector index & query engine.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the native C# vector
engine inside takurot/Pyrope (reference: /root/reference
src/Pyrope.GarnetServer/Vector/*). Index families:

- ``FlatIndex``      — exact brute-force scan (ref: BruteForceVectorIndex.cs)
- ``DeviceFlatIndex``— frozen exact scan over a device-resident slab
  (zero-copy bulk ingest; serves corpora past the host-slab wall)
- ``IvfFlatIndex``   — coarse k-means + inverted-list exact scan (ref: IvfFlatVectorIndex.cs)
- ``IvfPqIndex``     — IVF + product quantization with ADC (ref: IvfPqVectorIndex.cs)
- ``HnswIndex``      — graph ANN with batched beam search (ref: HnswVectorIndex.cs)
- ``DeltaIndex``     — LSM Head+Tail composite (ref: DeltaVectorIndex.cs)

Scores follow the reference's convention (higher is better): L2 -> -distance²,
inner-product -> dot, cosine -> normalized dot
(ref: BruteForceVectorIndex.cs:350-356).
"""

from pyrope_tpu.types import (
    Metric,
    SearchOptions,
    SearchResult,
    IndexStats,
    IndexConfig,
    IndexParams,
)

__version__ = "0.1.0"

__all__ = [
    "Metric",
    "SearchOptions",
    "SearchResult",
    "IndexStats",
    "IndexConfig",
    "IndexParams",
    "VectorIndex",
    "CentroidsProvider",
    "FlatIndex",
    "DeviceFlatIndex",
]


def __getattr__(name):
    # ALL index classes import lazily: importing the bare package must not
    # pull in jax (sidecar/CLI processes would otherwise initialize the
    # accelerator backend and contend for the card with the serving process).
    lazy = {
        "FlatIndex": "pyrope_tpu.index.flat",
        "DeviceFlatIndex": "pyrope_tpu.index.device_flat",
        "VectorIndex": "pyrope_tpu.index.base",
        "CentroidsProvider": "pyrope_tpu.index.base",
        "IvfFlatIndex": "pyrope_tpu.index.ivf_flat",
        "IvfPqIndex": "pyrope_tpu.index.ivf_pq",
        "HnswIndex": "pyrope_tpu.index.hnsw",
        "DeltaIndex": "pyrope_tpu.index.delta",
        "VectorIndexRegistry": "pyrope_tpu.registry",
        "create_index": "pyrope_tpu.registry",
    }
    if name in lazy:
        import importlib

        mod = importlib.import_module(lazy[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
