#!/usr/bin/env python
"""Pipelined RESP VEC.UPSERT writer, run as its own process.

scripts/serving_bench.py starts one of these per writer for its
``--writer-procs`` upsert cell. It imports no JAX, so the benchmark's own
process stays the only one on the device. The writer pre-encodes its
command stream, then runs a windowed send/receive loop with minimal
per-op Python work. Separate processes let the OS scheduler arbitrate
between writers instead of the server's GIL, which is also the honest
model of a remote load generator (the reference's SE.Redis clients did
not run inside Garnet's GIL).

    python scripts/resp_writer.py --port 6379 --index ingest \\
        --vecs slice.npy --lo 0 --pipeline 8

Prints one JSON line: {"n", "wall_s", "lat_ms" (sampled), "error"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pyrope_tpu.server.resp_client import RespClient  # noqa: E402
from pyrope_tpu.utils.parsing import encode_vector  # noqa: E402


def upsert(port: int, index: str, lo: int, vecs: np.ndarray,
           pipeline: int) -> dict:
    """Write ids v{lo}.. with ``pipeline`` commands in flight."""
    c = RespClient("127.0.0.1", port, timeout=120)
    enc = c._encode
    cmds = [
        enc("VEC.UPSERT", "lt", index, f"v{lo + i}", "VECTOR",
            encode_vector(v))
        for i, v in enumerate(vecs)
    ]
    n = len(cmds)
    lat: list[float] = []
    sock = c._sock
    t_start = time.perf_counter()
    i_send = i_read = 0
    while i_read < n:
        j = min(i_send + pipeline - (i_send - i_read), n)
        if j > i_send:
            t0 = time.perf_counter()
            sock.sendall(b"".join(cmds[i_send:j]))
            i_send = j
        r = c._read_reply()
        if r != "VEC_OK":
            raise RuntimeError(f"upsert reply: {r!r}")
        lat.append((time.perf_counter() - t0) * 1000)
        i_read += 1
    wall = time.perf_counter() - t_start
    c.close()
    return {"n": n, "wall_s": wall, "lat_ms": lat[:: max(1, n // 1000)],
            "error": None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--index", required=True)
    ap.add_argument("--vecs", required=True, help=".npy file of rows")
    ap.add_argument("--lo", type=int, default=0, help="id of the first row")
    ap.add_argument("--pipeline", type=int, default=1)
    args = ap.parse_args()
    try:
        out = upsert(args.port, args.index, args.lo, np.load(args.vecs),
                     max(args.pipeline, 1))
    except Exception as e:  # noqa: BLE001 — a dead writer must fail the cell
        out = {"n": 0, "wall_s": 0.0, "lat_ms": [], "error": repr(e)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
