"""chip_smoke.py's phases at tiny sizes on the CPU (the script itself
refuses to run without a GPU)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_served_phase_tiny(smoke):
    """RESP server up, bulk load through the engine, build, 64 concurrent
    VEC.SEARCH requests, probed-exact NumPy reference (a 640-slot sample
    may hold an fp32 near-tie swap, so the bar here is 98%)."""
    out = smoke.served_phase(n=3000, dim=16, nlist=20, nprobe=5,
                             n_requests=64, clients=4, min_match=0.98)
    assert out["match"] >= 0.98
    assert 0.0 <= out["recall"] <= 1.0


def test_kernel_phase_tiny(smoke):
    shapes = {
        "flat": (2000, 24, 40, 5, 0, 0),
        "ivf": (3000, 16, 33, 10, 12, 4),
    }
    rows = smoke.kernel_phase(shapes)
    assert len(rows) == 6
    assert all(r["mismatch_beyond_tol"] == 0 for r in rows)
    assert {r["precision"] for r in rows} == {
        "fp32 HIGHEST (IEEE)", "bf16 operands, fp32 accumulate",
        "bf16 scan, fp32 HIGHEST rerank"}


def test_hnsw_phase_tiny(smoke):
    recall = smoke.hnsw_phase(n=1500, dim=16, n_queries=16,
                              require_native=False)
    assert recall >= 0.9


def test_compare_flags_mismatch_beyond_tolerance(smoke):
    v = np.array([[-1.0, -2.0]], np.float32)
    i = np.array([[3, 4]])
    smoke._compare("t", "r", "p", (v, i), (v, i), 1e-6)
    with pytest.raises(AssertionError):
        smoke._compare("t", "r", "p", (v, i), (v - 1.0, i[:, ::-1]), 1e-6)


def test_brute_force_ids_matches_argsort(smoke):
    rng = np.random.default_rng(0)
    base = rng.random((500, 8), np.float32)
    q = rng.random((5, 8), np.float32)
    got = smoke.brute_force_ids(base, q, 7, chunk=128)
    d2 = ((q[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, np.argsort(d2, 1, kind="stable")[:, :7])


def test_refuses_without_gpu():
    """On the CPU the script exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_refuses_outside_the_repo(tmp_path):
    """Alone in a directory (no package beside it) the script fails too."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert not any(line.startswith("{") and json.loads(line).get("ok")
                   for line in r.stdout.splitlines())


def test_four_card_phases_on_virtual_devices(smoke):
    """The --four phases on four of the virtual CPU devices, tiny sizes."""
    smoke.sharded_flat_phase(n=5000, dim=16, b=16, n_dev=4)
    smoke.sharded_ivf_phase(n=8000, dim=16, nlist=20, nprobe=5, b=16,
                            n_dev=4)
