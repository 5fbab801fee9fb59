"""RESP (Redis Serialization Protocol) codec + asyncio data-plane server.

Rebuild of the reference's Garnet-hosted command surface
(ref: Services/GarnetService.cs:92-104 registers VEC.ADD/VEC.UPSERT/
VEC.DEL/VEC.SEARCH/VEC.STATS; Extensions/VectorCommandSet.cs dispatches
them; Security/PyropeGarnetAuthenticator.cs:16-98 maps Redis ``AUTH
tenant:key`` onto the session). The reference embeds Microsoft Garnet; the
rebuild implements RESP2 directly on asyncio — any Redis client
(redis-cli, redis-py, StackExchange.Redis) can speak to it.

Blocking device work (index search) runs in a thread pool via
``asyncio.to_thread`` so the event loop keeps servicing connections while
the device computes.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from pyrope_tpu.security import SessionAuthContext
from pyrope_tpu.server import errors as ec
from pyrope_tpu.server.engine import PyropeEngine
from pyrope_tpu.server.parser import (
    ParseError,
    parse_delete,
    parse_search,
    parse_stats,
    parse_write,
)

CRLF = b"\r\n"


# ---------------------------------------------------------------------------
# RESP2 encoding
# ---------------------------------------------------------------------------

def _line_safe(s: str) -> bytes:
    """Simple strings/errors are line-terminated; strip CR/LF from embedded
    (possibly client-supplied) text so replies can't be smuggled."""
    return s.replace("\r", " ").replace("\n", " ").encode()


def encode_simple(s: str) -> bytes:
    return b"+" + _line_safe(s) + CRLF


def encode_error(msg: str) -> bytes:
    return b"-" + _line_safe(msg) + CRLF


def encode_integer(n: int) -> bytes:
    return b":" + str(n).encode() + CRLF


def encode_bulk(data: "bytes | str | None") -> bytes:
    if data is None:
        return b"$-1" + CRLF
    if isinstance(data, str):
        data = data.encode()
    return b"$" + str(len(data)).encode() + CRLF + data + CRLF


def encode_array(items: "list | None") -> bytes:
    if items is None:
        return b"*-1" + CRLF
    out = b"*" + str(len(items)).encode() + CRLF
    for it in items:
        if isinstance(it, list):
            out += encode_array(it)
        elif isinstance(it, int):
            out += encode_integer(it)
        elif isinstance(it, float):
            out += encode_bulk(f"{it:.6g}")
        else:
            out += encode_bulk(it)
    return out


# ---------------------------------------------------------------------------
# RESP2 request parsing
# ---------------------------------------------------------------------------

class RespProtocolError(Exception):
    pass


async def read_command(reader: asyncio.StreamReader) -> Optional[list[bytes]]:
    """Read one client command: RESP array of bulk strings, or an inline
    command line. Returns None on clean EOF. (Compatibility shim over
    CommandReader — the server loop uses CommandReader directly.)"""
    cr = CommandReader(reader)
    while True:
        cmd = cr.try_next()
        if cmd is not None:
            return cmd
        if not await cr.fill():
            return None


class CommandReader:
    """Buffered RESP command parser: commands parse SYNCHRONOUSLY from a
    local buffer; the only await is one ``reader.read()`` per socket chunk.

    The StreamReader-per-field flow cost 13 awaited calls per command
    (array header + per-arg header/body readlines/readexactly) — 210k
    readline + 180k readexactly calls for a 30k-command ingest run, a
    measurable slice of single-core serving time. It also gave the
    pipelined dispatch loop no safe burst boundary: "bytes remain in the
    buffer" does not mean "a full command is buffered", so flushing only
    on empty risked awaiting a partial command while replies sat queued.
    ``try_next() is None`` is the precise boundary."""

    __slots__ = ("_reader", "_buf", "_pos")

    def __init__(self, reader: asyncio.StreamReader):
        self._reader = reader
        self._buf = bytearray()
        self._pos = 0

    async def fill(self) -> bool:
        """Read one chunk into the buffer; False on EOF/reset."""
        if self._pos and self._pos == len(self._buf):
            del self._buf[:]
            self._pos = 0
        elif self._pos > 1 << 16:
            del self._buf[: self._pos]
            self._pos = 0
        try:
            chunk = await self._reader.read(1 << 16)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            return False
        if not chunk:
            return False
        self._buf += chunk
        return True

    def try_next(self) -> Optional[list[bytes]]:
        """Parse one complete command from the buffer, or None if more
        bytes are needed. Raises RespProtocolError on malformed input."""
        buf, pos = self._buf, self._pos
        nl = buf.find(b"\r\n", pos)
        if nl < 0:
            if len(buf) - pos > 1 << 20:
                raise RespProtocolError("header line too long")
            return None
        line = bytes(buf[pos:nl])
        if not line:
            self._pos = nl + 2
            return []
        if line[0:1] != b"*":
            self._pos = nl + 2  # inline command (redis-cli convenience)
            return line.split()
        try:
            n = int(line[1:])
        except ValueError:
            raise RespProtocolError("bad array header")
        if n < 0 or n > 1024:
            raise RespProtocolError("bad array length")
        args: list[bytes] = []
        cur = nl + 2
        for _ in range(n):
            hl = buf.find(b"\r\n", cur)
            if hl < 0:
                return None
            if buf[cur : cur + 1] != b"$":
                raise RespProtocolError("expected bulk string")
            try:
                ln = int(buf[cur + 1 : hl])
            except ValueError:
                raise RespProtocolError("bad bulk length")
            if ln < 0 or ln > 64 * 1024 * 1024:
                raise RespProtocolError("bulk too large")
            end = hl + 2 + ln + 2
            if len(buf) < end:
                return None
            args.append(bytes(buf[hl + 2 : end - 2]))
            cur = end
        self._pos = cur
        return args


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class RespServer:
    def __init__(self, engine: PyropeEngine, host: str = "127.0.0.1", port: int = 6379):
        from pyrope_tpu.server.batcher import AsyncWriteCoalescer

        self.engine = engine
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        # concurrent per-row writes for one (tenant, index) share one
        # engine.write_batch pass (one quota/auth/epoch/write-heat per
        # group); solo writes pass straight through at single-op cost
        self.write_coalescer = AsyncWriteCoalescer(engine)

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    # ---- connection handler ----------------------------------------------

    # flush a pipelined write burst at this many outstanding commands even
    # if the socket still has more buffered
    PIPELINE_FLUSH = 256
    _WRITE_CMDS = (b"VEC.ADD", b"VEC.UPSERT", b"vec.add", b"vec.upsert")
    _UPSERT_CMDS = (b"VEC.UPSERT", b"vec.upsert")

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        SessionAuthContext.clear()  # fresh per connection task

        # Pipelined WRITE dispatch: consecutive VEC.ADD/VEC.UPSERTs already
        # buffered on the socket parse inline into a burst list and submit
        # as ONE coalescer span (engine.write_batch) with ONE future and
        # ONE reply write — a 64-deep pipelined writer pays ~1/64th of the
        # per-op engine/future/syscall overhead (per-reply socket.send was
        # 60% of upsert-cell serving time: each tiny send's GIL handoff
        # queued behind the client threads). Replies stay FIFO; same-
        # command runs keep per-connection apply order (span rows apply in
        # submission order, groups execute in gate order). Any OTHER
        # command flushes the burst first, preserving RESP's in-order
        # semantics for mixed sequences (e.g. UPSERT then SEARCH sees the
        # upsert).
        burst: list = []  # ("w", req, upsert) | ("raw", reply_bytes)

        async def flush() -> None:
            if not burst:
                return
            replies: list = [None] * len(burst)
            groups: dict[tuple, tuple[list, list, list]] = {}
            for i, item in enumerate(burst):
                if item[0] == "raw":
                    replies[i] = item[1]
                else:
                    _, req, ups = item
                    g = groups.setdefault(
                        (req.tenant, req.index, req.api_key), ([], [], [])
                    )
                    g[0].append(i)
                    g[1].append(req)
                    g[2].append(ups)
            burst.clear()
            for idxs, reqs, ups in groups.values():
                try:
                    results = await self.write_coalescer.submit_many(reqs, ups)
                except Exception as e:  # batch died: every row errors
                    err = encode_error(f"ERR internal: {type(e).__name__}: {e}")
                    for i in idxs:
                        replies[i] = err
                    continue
                for i, r in zip(idxs, results):
                    replies[i] = (encode_simple(ec.VEC_OK) if r.ok else
                                  encode_error(f"{r.error_code} {r.error_message}"))
            writer.write(b"".join(replies))
            if writer.transport.get_write_buffer_size() > 65536:
                await writer.drain()

        cr = CommandReader(reader)
        try:
            while True:
                try:
                    args = cr.try_next()
                except RespProtocolError as e:
                    await flush()
                    writer.write(encode_error(f"ERR protocol: {e}"))
                    await writer.drain()
                    break
                if args is None:
                    # burst boundary: no complete command buffered — flush
                    # outstanding write replies BEFORE blocking on the
                    # socket, else the client (waiting on these replies)
                    # and the server (waiting on its next command) deadlock
                    await flush()
                    if not await cr.fill():
                        break
                    continue
                if not args:
                    continue
                if args[0] in self._WRITE_CMDS:
                    upsert = args[0] in self._UPSERT_CMDS
                    try:
                        req = parse_write(args[1:])
                        state = self.engine.registry.try_get(
                            req.tenant, req.index
                        )
                    except ParseError as e:
                        burst.append(
                            ("raw", encode_error(f"{ec.VEC_ERR_DIM} {e}")))
                    except Exception as e:
                        burst.append(("raw", encode_error(
                            f"ERR internal: {type(e).__name__}: {e}")))
                    else:
                        if state is not None and state.index.host_write_cheap:
                            burst.append(("w", req, upsert))
                        else:
                            # slow path (index auto-create, graph families):
                            # flush first to keep replies FIFO, then the
                            # per-op thread pool
                            await flush()
                            writer.write(await self._write_slow(req, upsert))
                    if len(burst) >= self.PIPELINE_FLUSH:
                        await flush()
                    continue
                await flush()
                resp = await self._dispatch(args)
                if resp is None:  # QUIT
                    writer.write(encode_simple("OK"))
                    await writer.drain()
                    break
                writer.write(resp)
                # drain() is flow control, not a flush — it only needs to
                # run when the transport buffer is actually backed up, and
                # awaiting it per response costs a scheduler hop on the hot
                # path (asyncio writes go to the socket from write() itself)
                if writer.transport.get_write_buffer_size() > 65536:
                    await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError, BrokenPipeError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _dispatch(self, args: list[bytes]) -> Optional[bytes]:
        cmd = args[0].decode("utf-8", "replace").upper()
        try:
            if cmd == "PING":
                return encode_simple("PONG")
            if cmd == "QUIT":
                return None
            if cmd == "ECHO" and len(args) == 2:
                return encode_bulk(args[1])
            if cmd == "AUTH":
                return self._auth(args[1:])
            if cmd == "COMMAND":
                return encode_array([])
            if cmd == "VEC.ADD":
                return await self._write(args[1:], upsert=False)
            if cmd == "VEC.UPSERT":
                return await self._write(args[1:], upsert=True)
            if cmd == "VEC.DEL":
                return await self._delete(args[1:])
            if cmd == "VEC.SEARCH":
                return await self._search(args[1:])
            if cmd == "VEC.STATS":
                return self._stats(args[1:])
            return encode_error(f"ERR unknown command '{cmd}'")
        except ParseError as e:
            return encode_error(f"{ec.VEC_ERR_DIM} {e}")
        except Exception as e:  # never kill the connection on a bug
            return encode_error(f"ERR internal: {type(e).__name__}: {e}")

    # ---- AUTH (ref: PyropeGarnetAuthenticator.cs:16-98) --------------------

    def _auth(self, args: list[bytes]) -> bytes:
        if len(args) == 1:
            token = args[0].decode()
            if ":" in token:
                tenant, key = token.split(":", 1)
            else:
                return encode_error(f"{ec.VEC_ERR_AUTH} use AUTH tenant:key")
        elif len(args) == 2:  # ACL-style AUTH user pass == AUTH tenant key
            tenant, key = args[0].decode(), args[1].decode()
        else:
            return encode_error("ERR wrong number of arguments for AUTH")
        if self.engine.authenticator.authenticate(tenant, key):
            SessionAuthContext.set_tenant(tenant)
            return encode_simple("OK")
        SessionAuthContext.clear()
        return encode_error(f"{ec.VEC_ERR_AUTH} invalid credentials")

    # ---- VEC.* -------------------------------------------------------------

    async def _write(self, args: list[bytes], upsert: bool) -> bytes:
        req = parse_write(args)
        # buffer/slab-backed families write in microseconds of host work
        # (host_write_cheap) — those ride the write coalescer: concurrent
        # connections' writes to one index share a single engine pass
        # (engine.write_batch), a solo write passes straight through. Graph
        # families (HNSW per-row insert) and index auto-creation keep the
        # per-op thread pool. (The pipelined handler burst path performs
        # this same routing inline — this method serves non-burst callers.)
        state = self.engine.registry.try_get(req.tenant, req.index)

        if state is not None and state.index.host_write_cheap:
            r = await self.write_coalescer.submit(req, upsert)
            if r.ok:
                return encode_simple(ec.VEC_OK)
            return encode_error(f"{r.error_code} {r.error_message}")
        return await self._write_slow(req, upsert)

    async def _write_slow(self, req, upsert: bool) -> bytes:
        r = await asyncio.to_thread(
            lambda: self.engine.add(
                req.tenant, req.index, req.id, req.vector,
                api_key=req.api_key, meta=req.meta, tags=req.tags,
                numeric_fields=req.numeric_fields, upsert=upsert,
            )
        )
        if r.ok:
            return encode_simple(ec.VEC_OK)
        return encode_error(f"{r.error_code} {r.error_message}")

    async def _delete(self, args: list[bytes]) -> bytes:
        req = parse_delete(args)
        # deletes are tombstones in every family — host dict work, inline
        r = self.engine.delete(
            req.tenant, req.index, req.id, api_key=req.api_key
        )
        if r.ok:
            return encode_simple(ec.VEC_OK)
        return encode_error(f"{r.error_code} {r.error_message}")

    async def _search(self, args: list[bytes]) -> bytes:
        req = parse_search(args, default_tenant=SessionAuthContext.get_tenant())
        # host-only leg INLINE on the event loop: a cache hit is ~70 us of
        # dict/numpy work, while the executor hop alone costs more — only a
        # miss (device work: L2 probe + engine dispatch) pays the thread
        r, cont = self.engine.search_begin(
            req.tenant, req.index, req.vector, req.top_k,
            api_key=req.api_key, filter_tags=req.filter_tags,
            with_meta=req.with_meta, trace=req.trace,
            request_id=req.request_id, cache_hint_force=req.cache_hint_force,
            options=req.options,
        )
        if r is None:
            try:
                r = await asyncio.get_running_loop().run_in_executor(
                    None, self.engine.search_resume, cont
                )
            except asyncio.CancelledError:
                # a cancel before the executor starts the fn means
                # search_resume (whose finally owns the release) never
                # runs — free the tenant lease here; release() is
                # idempotent, so a post-start cancel double-release is safe
                if cont.lease is not None:
                    cont.lease.release()
                raise
        if not r.ok:
            return encode_error(f"{r.error_code} {r.error_message}")
        hits = []
        for h in r.hits:
            row: list = [h.id, f"{h.score:.6g}"]
            if req.with_meta:
                row.append(json.dumps(h.meta) if h.meta is not None else None)
            hits.append(row)
        if req.trace and r.trace is not None:
            # hits array + trace JSON as 2nd element (ref :849-882)
            return encode_array([hits, json.dumps(r.trace.to_dict())])
        return encode_array(hits)

    def _stats(self, args: list[bytes]) -> bytes:
        req = parse_stats(args, default_tenant=SessionAuthContext.get_tenant())
        # same auth contract as every other VEC.* command (session or API_KEY)
        if not self.engine._authenticate(req.tenant, req.api_key):
            return encode_error(f"{ec.VEC_ERR_AUTH} authentication failed")
        s = self.engine.stats(req.tenant, req.index)
        if s is None:
            return encode_error(f"{ec.VEC_ERR_NOT_FOUND} index not found")
        flat: list = []
        for k, v in s.items():
            flat.append(k)
            flat.append(v if isinstance(v, int) else str(v))
        return encode_array(flat)
