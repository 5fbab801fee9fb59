"""Process wiring: one process serving RESP + HTTP + background loops.

Rebuild of the reference's host composition (ref: Program.cs:17-168 — DI
singleton graph, Garnet hosted service, HTTP app, background services):

    PyropeApp = engine (PyropeEngine) + RespServer + HttpApi
              + SidecarMetricsReporter loop  (ref: SidecarMetricsReporter.cs, 10 s)
              + prefetcher flush / SLO monitor / prefetch queue ticks
                (ref: PredictivePrefetcher.cs 1 s, SloGuardrailsMonitor.cs 5 s)

Run it: ``python -m pyrope_tpu.server [--resp-port N] [--http-port N]
[--sidecar host:port]``; ``--http-port 0`` serves RESP alone (the HTTP
plane, and with it aiohttp, is only imported when it starts). Config env
vars mirror the reference's (README.md:33-39): PYROPE_ADMIN_API_KEY,
PYROPE_AUTH_ENABLED, PYROPE_SIDECAR_ENDPOINT, SLO_TARGET_P99_MS.
"""

from __future__ import annotations

import argparse
import asyncio
import os
from pathlib import Path
from typing import Optional

from pyrope_tpu.cache import WarmPathPolicy
from pyrope_tpu.security import AuthSettings
from pyrope_tpu.server.engine import EngineConfig, PyropeEngine
from pyrope_tpu.server.resp import RespServer
from pyrope_tpu.service import SloGuardrailsOptions
from pyrope_tpu.service.sidecar_metrics import (
    SidecarMetricsCalculator,
    SystemUsageProvider,
)


class SidecarMetricsReporter:
    """Engine-side warm-path loop (ref: Services/SidecarMetricsReporter.cs:
    67-191): every interval compute QPS/miss/P99/CPU deltas, call
    ``ReportSystemMetrics`` per tenant with the 50 ms warm-path deadline;
    on deadline record an AI-fallback and keep the cached policy; apply the
    returned WarmPathPolicy and the server-adjusted report interval."""

    def __init__(self, engine: PyropeEngine, client, interval_s: float = 10.0):
        self.engine = engine
        self.client = client
        self.interval_s = interval_s
        self._calc = SidecarMetricsCalculator()
        self._usage = SystemUsageProvider()

    def tick(self) -> Optional[dict]:
        metrics = self._calc.calculate(
            self.engine.metrics.get_snapshot(), self._usage.get_snapshot()
        )
        if metrics is None:
            return None
        tenants = self.engine.tenants.list_tenants() or ["-"]
        last = None
        from pyrope_tpu.sidecar.client import SidecarUnavailable

        for tenant in tenants:
            try:
                out = self.client.report_system_metrics(
                    tenant, metrics.qps, metrics.cache_miss_rate,
                    metrics.p99_latency_ms, metrics.cpu_utilization,
                )
            except SidecarUnavailable:
                self.engine.metrics.record_ai_fallback()
                continue
            policy = out.get("policy")
            if not policy:
                continue  # malformed response: keep the cached policy
            self.engine.policy.update_policy(WarmPathPolicy.from_dict(policy))
            nxt = out.get("next_report_interval_ms")
            if nxt:
                self.interval_s = max(1.0, nxt / 1000.0)
            last = out
        return last


class PyropeApp:
    def __init__(
        self,
        config: Optional[EngineConfig] = None,
        resp_port: int = 6379,
        http_port: int = 8080,
        host: str = "127.0.0.1",
        sidecar_endpoint: Optional[str] = None,
    ):
        self.engine = PyropeEngine(config or EngineConfig())
        self.sidecar_client = None
        self.reporter: Optional[SidecarMetricsReporter] = None
        if sidecar_endpoint:
            from pyrope_tpu.sidecar.client import PolicyServiceClient

            self.sidecar_client = PolicyServiceClient(sidecar_endpoint)
            self.engine.prefetcher._client = self.sidecar_client
            self.reporter = SidecarMetricsReporter(self.engine, self.sidecar_client)
        self.resp = RespServer(self.engine, host, resp_port)
        self.http_api = None
        if http_port:
            from pyrope_tpu.server.http_api import HttpApi

            self.http_api = HttpApi(self.engine,
                                    sidecar_client=self.sidecar_client)
        self.host = host
        self.http_port = http_port
        self._http_runner = None
        self._bg_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        from pyrope_tpu.security.pem import server_context_from_env

        # asyncio.to_thread rides the loop's DEFAULT executor, whose size is
        # min(32, cpu+4). Those threads spend their time blocked on a device
        # round trip (the GIL is released in the fetch), so the cap silently
        # limits concurrent engine calls and
        # with them the micro-batcher's group size (max_batch_seen pins at
        # the pool size, not at client concurrency). Size the pool to the
        # serving concurrency we coalesce for, not to the CPU count.
        import concurrent.futures

        asyncio.get_running_loop().set_default_executor(
            concurrent.futures.ThreadPoolExecutor(
                max_workers=int(os.environ.get("PYROPE_SERVE_THREADS", "128")),
                thread_name_prefix="pyrope-serve",
            )
        )

        ssl_ctx = server_context_from_env()  # PYROPE_TLS_{CERT,KEY,CA}
        await self.resp.start()
        if self.http_api is not None:
            from aiohttp import web

            self._http_runner = web.AppRunner(self.http_api.build_app())
            await self._http_runner.setup()
            site = web.TCPSite(
                self._http_runner, self.host, self.http_port,
                ssl_context=ssl_ctx,
            )
            await site.start()
        self.engine.prefetch_queue.start()
        self._bg_task = asyncio.create_task(self._background_loop())

    async def stop(self) -> None:
        if self._bg_task is not None:
            self._bg_task.cancel()
            try:
                await self._bg_task
            except asyncio.CancelledError:
                pass
        self.engine.prefetch_queue.stop()
        await self.resp.stop()
        if self._http_runner is not None:
            await self._http_runner.cleanup()
        if self.sidecar_client is not None:
            self.sidecar_client.close()

    async def _background_loop(self) -> None:
        """1 s cadence for prefetch/alias/SLO ticks; reporter on its own
        (server-adjustable) interval."""
        import sys
        import time as _time

        next_report = 0.0
        last_err_log = 0.0
        while True:
            await asyncio.sleep(1.0)
            # each background duty fails independently (a broken prefetcher
            # must not starve the sidecar reporter), and failures are logged
            # (rate-limited) instead of vanishing
            try:
                await asyncio.to_thread(self.engine.tick_background)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if _time.monotonic() - last_err_log > 30:
                    last_err_log = _time.monotonic()
                    print(f"[pyrope] tick_background failed: {e!r}", file=sys.stderr)
            if self.reporter is not None:
                next_report -= 1.0
                if next_report <= 0:
                    next_report = self.reporter.interval_s  # even on failure
                    try:
                        await asyncio.to_thread(self.reporter.tick)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        if _time.monotonic() - last_err_log > 30:
                            last_err_log = _time.monotonic()
                            print(f"[pyrope] sidecar report failed: {e!r}",
                                  file=sys.stderr)


def config_from_env() -> EngineConfig:
    return EngineConfig(
        auth=AuthSettings.from_env(),
        slo=SloGuardrailsOptions(
            target_p99_ms=float(os.environ.get("SLO_TARGET_P99_MS", "50")),
        ),
        billing_log_path=os.environ.get("PYROPE_BILLING_LOG"),
        audit_log_path=os.environ.get("PYROPE_AUDIT_LOG"),
        snapshot_dir=os.environ.get("PYROPE_SNAPSHOT_DIR", "snapshots"),
    )


CACHE_DIR_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed, git-ignored default inside the checkout: the cache key includes
# the path, so a directory that moves never hits
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache: index search/build jits survive
    process restarts. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
    it itself and nothing is set here; otherwise the cache lives at
    DEFAULT_CACHE_DIR. Returns the directory in use. Called at server
    startup and by bench.py's main()."""
    env = os.environ.get(CACHE_DIR_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(DEFAULT_CACHE_DIR)


async def _amain(args) -> None:
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    enable_compilation_cache()
    app = PyropeApp(
        config=config_from_env(),
        resp_port=args.resp_port,
        http_port=args.http_port,
        host=args.host,
        sidecar_endpoint=args.sidecar or os.environ.get("PYROPE_SIDECAR_ENDPOINT"),
    )
    await app.start()
    http = f" and HTTP on {app.host}:{app.http_port}" if app.http_port else ""
    print(f"pyrope_tpu serving RESP on {app.host}:{app.resp.port}{http}",
          flush=True)
    await asyncio.Event().wait()  # run until killed


def main() -> None:
    p = argparse.ArgumentParser(description="pyrope_tpu server")
    p.add_argument("--resp-port", type=int, default=6379)
    p.add_argument("--http-port", type=int, default=8080,
                   help="HTTP control plane port; 0 serves RESP only")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--sidecar", default=None, help="sidecar gRPC endpoint host:port")
    p.add_argument("--platform", default=os.environ.get("PYROPE_JAX_PLATFORM"),
                   help="pin the jax platform (e.g. cpu)")
    args = p.parse_args()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
