"""The fused scan+top-k kernel against XLA's plain version, on the GPU.

For every kernel-phase shape this compiles the Triton kernel
(ops/pallas_scan) on the bf16 slab the hybrid selection scans, and the
plain XLA version (bf16 score_matrix, mask, lax.top_k) on the same
operands, checks that they agree, and with ``--time`` times both in
turns (kernel, xla, kernel, xla, ...).

    python scripts/kernel_bench.py --check         # compile, compare, memory
    python scripts/kernel_bench.py --time          # ... and time in turns
    python scripts/kernel_bench.py --time --only flat1m_bf16_r64

Prints one JSON line per shape; refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyrope_tpu.index.ivf_flat import dense_probe_mask  # noqa: E402
from pyrope_tpu.ops import pallas_scan  # noqa: E402
from pyrope_tpu.ops.distance import score_matrix  # noqa: E402
from pyrope_tpu.ops.topk import masked_topk  # noqa: E402
from pyrope_tpu.types import Metric  # noqa: E402

# name: (rows, dim, batch, shortlist width R, nlist, nprobe)
SHAPES = {
    "flat1m_bf16_r64": (1_000_000, 128, 1024, 64, 0, 0),
    "flat1m_bf16_r256": (1_000_000, 128, 1024, 256, 0, 0),
    "ivf100k_bf16_r64": (100_000, 128, 4096, 64, 100, 96),
    "ivf1m_bf16_r64": (1_000_000, 128, 1024, 64, 1000, 32),
}


def make_case(name: str, seed: int = 0) -> dict:
    """Device-generated data for one shape: slab, norms, queries, and for
    IVF shapes a cluster-major list layout with random probe sets."""
    n, d, b, k, nlist, nprobe = SHAPES[name]
    kx, kq, kc, kp = jax.random.split(jax.random.PRNGKey(seed), 4)
    x32 = jax.random.normal(kx, (n, d), jnp.float32)
    sq = jnp.sum(x32 * x32, axis=1)
    c = {"name": name, "k": k, "x": x32.astype(jnp.bfloat16), "sq": sq,
         "alive": jnp.ones(n, bool),
         "q": jax.random.normal(kq, (b, d), jnp.float32), "ivf": bool(nlist)}
    if nlist:
        crow = jnp.sort(jax.random.randint(kc, (n,), 0, nlist))
        lens = jnp.bincount(crow, length=nlist)
        offs = jnp.cumsum(lens) - lens
        pos = jnp.arange(n, dtype=jnp.int32) - offs[crow]
        _, probe = jax.lax.top_k(jax.random.uniform(kp, (b, nlist)), nprobe)
        eff = lens[probe].astype(jnp.int32)
        allowed = jnp.zeros((b, nlist), jnp.int32).at[
            jnp.arange(b)[:, None], probe].set(eff)
        c.update(crow=crow.astype(jnp.int32), pos=pos, probe=probe, eff=eff,
                 allowed=allowed)
    return c


def kernel_fn(c: dict):
    k, ivf = c["k"], c["ivf"]

    @jax.jit
    def fn(q, x, sq, alive, tables):
        if ivf:
            crow, pos, allowed = tables
            return pallas_scan._fused_topk(q, x, sq, alive, k, Metric.L2, 0,
                                           (crow, pos, allowed))
        return pallas_scan._fused_topk(q, x, sq, alive, k, Metric.L2,
                                       x.shape[0], None)

    tables = (c["crow"], c["pos"], c["allowed"]) if ivf else None
    return fn, (c["q"], c["x"], c["sq"], c["alive"], tables)


def xla_fn(c: dict):
    """The plain version: bf16 score_matrix + mask + lax.top_k, as
    index/flat and index/ivf_flat would run the shortlist scan on XLA."""
    k, ivf = c["k"], c["ivf"]

    @jax.jit
    def fn(q, x, sq, alive, tables):
        scores = score_matrix(q, x, Metric.L2, x_sqnorm=sq,
                              compute_dtype=x.dtype)
        if ivf:
            crow, pos, probe, eff = tables
            mask = dense_probe_mask(probe, eff, crow, pos, alive,
                                    int(SHAPES[c["name"]][4]))
        else:
            mask = alive[None, :]
        return masked_topk(scores, mask, k)

    tables = (c["crow"], c["pos"], c["probe"], c["eff"]) if ivf else None
    return fn, (c["q"], c["x"], c["sq"], c["alive"], tables)


def compare(kv, ki, xv, xi) -> dict:
    kv, ki, xv, xi = map(np.asarray, (kv, ki, xv, xi))
    same = ki == xi
    finite = np.isfinite(kv) & np.isfinite(xv)
    err = float(np.max(np.abs(kv - xv)[finite])) if finite.any() else 0.0
    # a differing slot is a near-tie when both sides' scores agree there
    ties = (~same) & (np.abs(kv - xv) <= 1e-3 * np.maximum(1.0, np.abs(xv)))
    return {"id_match": float(same.mean()), "mismatch": int((~same).sum()),
            "mismatch_near_tie": int(ties.sum()), "max_score_err": err}


def timed(fn, args, iters: int = 0) -> float:
    """Mean ms per call; ``iters`` 0 picks enough calls for ~0.3 s."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    if not iters:
        iters = int(min(20, max(3, 0.3 / (time.perf_counter() - t0))))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def run(name: str, do_time: bool, turns: int) -> dict:
    c = make_case(name)
    xfn, xargs = xla_fn(c)
    t0 = time.perf_counter()
    xv, xi = xfn(*xargs)
    jax.block_until_ready(xi)
    row = {"shape": name, "dims": SHAPES[name],
           "xla_first_call_s": round(time.perf_counter() - t0, 3)}
    kfn, kargs = kernel_fn(c)
    t0 = time.perf_counter()
    compiled = kfn.lower(*kargs).compile()
    row["compile_s"] = round(time.perf_counter() - t0, 3)
    mem = compiled.memory_analysis()
    row["temp_bytes"] = getattr(mem, "temp_size_in_bytes", None)
    kv, ki = compiled(*kargs)
    row["vs_xla"] = compare(kv, ki, xv, xi)
    if do_time:
        kms, xms = [], []
        for _ in range(turns):
            kms.append(timed(compiled, kargs))
            xms.append(timed(xfn, xargs))
        row["kernel_ms"] = kms
        row["kernel_ms_median"] = float(np.median(kms))
        row["xla_ms"] = xms
        row["xla_ms_median"] = float(np.median(xms))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print("no GPU: refusing to measure on", jax.default_backend(),
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", smi.stdout.strip(), flush=True)
    names = args.only or list(SHAPES)
    for name in names:
        row = run(name, args.time, args.turns)
        row["device_kind"] = jax.devices()[0].device_kind
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
