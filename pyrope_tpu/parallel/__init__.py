"""Multi-chip execution: mesh helpers, sharded scans, sharded k-means.

The reference is a single-node server with no distribution layer (SURVEY
§2.1 note, §5.8) — this package is the new surface the device build adds:
corpus rows sharded over a 1-D device mesh, a 2-D batch × data mesh, or a
multi-slice slice × data mesh (rows over both axes, top-k merged within a
slice first, then once per slice — mesh.make_mesh_multislice), per-shard top-k,
all-gather merge ("sequence parallelism over the database axis", SURVEY
§5.7/§5.8). Family coverage: Flat (fp32/bf16/sq8),
IVF-Flat, IVF-PQ (with per-shard exact rerank), HNSW (replicated graph
query-sharded, AND corpus-sharded: per-shard k-means cell sub-graphs so
graph memory scales with the mesh); Delta composes sharded halves
(index/delta.py takes any two VectorIndex instances).
"""

from pyrope_tpu.parallel.mesh import (
    default_mesh,
    make_mesh,
    make_mesh_2d,
    make_mesh_multislice,
)
from pyrope_tpu.parallel.sharded_flat import ShardedFlatIndex, sharded_kmeans_step
from pyrope_tpu.parallel.sharded_hnsw import (
    ShardedHnswCorpusIndex,
    ShardedHnswIndex,
)
from pyrope_tpu.parallel.sharded_ivf import ShardedIvfFlatIndex
from pyrope_tpu.parallel.sharded_ivf_pq import ShardedIvfPqIndex

__all__ = [
    "default_mesh",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_multislice",
    "ShardedFlatIndex",
    "ShardedHnswCorpusIndex",
    "ShardedHnswIndex",
    "ShardedIvfFlatIndex",
    "ShardedIvfPqIndex",
    "sharded_kmeans_step",
]
