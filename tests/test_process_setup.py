"""Process setup: compile cache location, the RESP-only server without
aiohttp, device-memory-sized dense transients, the native build's file
name, and JAX-free load-generator processes."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from pyrope_tpu.server import app

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert app.enable_compilation_cache() == str(tmp_path)
    # the env var is JAX's own: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_ignored_path_in_checkout(monkeypatch):
    import jax

    from pyrope_tpu.server import app

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    min_s = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        path = app.enable_compilation_cache()
        assert path == str(app.DEFAULT_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_s)
    assert os.path.dirname(path) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()


def test_resp_server_runs_without_aiohttp():
    """With aiohttp unimportable, `--http-port 0` semantics: the RESP plane
    starts and answers; the HTTP plane is never imported."""
    script = textwrap.dedent("""
        import asyncio, sys
        sys.modules["aiohttp"] = None  # any import of it now fails
        from pyrope_tpu.security import AuthSettings
        from pyrope_tpu.server.app import PyropeApp
        from pyrope_tpu.server.engine import EngineConfig
        from pyrope_tpu.server.resp_client import RespClient

        async def main():
            app = PyropeApp(EngineConfig(auth=AuthSettings(enabled=False)),
                            resp_port=0, http_port=0)
            await app.start()
            def talk():
                with RespClient("127.0.0.1", app.resp.port) as c:
                    c.execute("VEC.ADD", "t", "i", "a", "VECTOR", "[1,2]")
                    return c.vec_search("t", "i", b"[1,2]", 1)
            hits = await asyncio.to_thread(talk)
            await app.stop()
            assert app.http_api is None
            print(hits[0][0])

        asyncio.run(main())
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "a"


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,expect", [
    ({"bytes_limit": 60 * 2**30}, 60 * 2**30 // 36),
    ({"bytes_limit": 0}, None),
    (None, None),
])
def test_dense_max_elems_follows_device_memory(monkeypatch, stats, expect):
    import jax

    from pyrope_tpu.index import ivf_flat

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(stats)])
    ivf_flat.dense_max_elems.cache_clear()
    try:
        got = ivf_flat.dense_max_elems()
        assert got == (ivf_flat.DENSE_MAX_ELEMS if expect is None else expect)
        # the guard demotes an XLA dense batch past the cap, never a fused one
        npad = 2_000_000
        b = got // npad + 8
        assert ivf_flat.pick_scan_mode("auto", npad, 3, 4096, batch=b) == "probe"
        assert ivf_flat.pick_scan_mode("auto", npad, 96, 4096, batch=b,
                                       fused=True) == "dense"
    finally:
        ivf_flat.dense_max_elems.cache_clear()


def test_native_lib_name_keys_source_flags_and_machine(monkeypatch, tmp_path):
    from pyrope_tpu.native import build

    src = tmp_path / "a.cc"
    src.write_text("int f() { return 1; }\n")
    n1 = build.lib_name([src])
    assert n1 == build.lib_name([src])
    monkeypatch.setattr(build.platform, "machine", lambda: "other-arch")
    assert build.lib_name([src]) != n1
    monkeypatch.undo()
    src.write_text("int f() { return 2; }\n")
    assert build.lib_name([src]) != n1
    assert "-march=native" not in build._FLAGS


def test_resp_writer_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'scripts'); import resp_writer; "
            "print('jax' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"


def test_resp_writer_process_loads_rows(tmp_path):
    """A writer process (no JAX) pipelines VEC.UPSERTs into a live server."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    app, loop = smoke.start_server()
    try:
        vecs = np.random.default_rng(0).random((50, 8), np.float32)
        path = tmp_path / "w.npy"
        np.save(path, vecs)
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "resp_writer.py"),
             "--port", str(app.resp.port), "--index", "ing",
             "--vecs", str(path), "--lo", "100", "--pipeline", "8"],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=ROOT))
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["error"] is None and out["n"] == 50
        st = app.engine.stats("lt", "ing")
        assert st["count"] == 50
    finally:
        smoke.stop_server(app, loop)
