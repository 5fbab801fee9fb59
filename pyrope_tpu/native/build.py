"""Lazy ctypes build/load of the native library.

The library is built from the committed sources on first use, for the
host it runs on: no ``-march=native``, and the file name carries a hash
of the sources, the compiler flags and the machine type, so a build left
in the directory by another host or another source version is never
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_SOURCES = ["hnsw_builder.cc"]
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: "Optional[ctypes.CDLL]" = None
_tried = False


def _build_dir() -> Path:
    d = os.environ.get("PYROPE_NATIVE_BUILD_DIR")
    if d:
        return Path(d)
    return _SRC_DIR / "build"


def lib_name(srcs: "list[Path]") -> str:
    """File name keyed by the sources' bytes, the flags and the machine."""
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(platform.machine().encode())
    return f"libpyrope_native-{h.hexdigest()[:16]}.so"


def _compile() -> Optional[Path]:
    srcs = [_SRC_DIR / s for s in _SOURCES]
    if not all(s.exists() for s in srcs):
        return None
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / lib_name(srcs)
    if lib_path.exists():
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp)] + [str(s) for s in srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        tmp.replace(lib_path)  # atomic: concurrent builders never half-load
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    return lib_path


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PYROPE_DISABLE_NATIVE"):
            return None
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.hnsw_build.restype = ctypes.c_int
        lib.hnsw_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # vecs
            ctypes.POINTER(ctypes.c_float),   # sqnorm
            ctypes.c_int, ctypes.c_int,       # n, dim
            ctypes.c_int, ctypes.c_int,       # m, ef_construction
            ctypes.c_int,                     # metric
            ctypes.c_int,                     # heuristic (0 = ref closest-M)
            ctypes.POINTER(ctypes.c_int32),   # levels
            ctypes.c_int,                     # max_level
            ctypes.POINTER(ctypes.c_int32),   # adj0
            ctypes.POINTER(ctypes.c_int32),   # adj_up
            ctypes.POINTER(ctypes.c_int32),   # top_level_out
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None
