"""Native (C++) host-side components, loaded via ctypes.

The device owns every query kernel; these cover the inherently-sequential
host work the reference keeps in its compiled engine — currently the HNSW
graph builder (ref: HnswVectorIndex.cs insert path; see
native/hnsw_builder.cc). The shared library is compiled from the committed
C++ source on first use (g++ is in the image; binaries are not committed)
and cached beside the source; every caller falls back to the pure-Python
path when the toolchain is unavailable.
"""

from pyrope_tpu.native.build import load_native, native_available
from pyrope_tpu.native.hnsw import hnsw_build_native

__all__ = ["load_native", "native_available", "hnsw_build_native"]
