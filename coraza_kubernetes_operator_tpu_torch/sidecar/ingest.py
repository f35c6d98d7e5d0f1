"""Asyncio-native zero-copy ingest frontend (docs/SERVING.md).

The legacy ``ThreadingHTTPServer`` frontend spends the serving budget on
per-connection threads and per-request Python object churn long before a
request reaches the pipelined batcher and the C++ tensorizer — DPI data
planes are ingest-bound before the matcher saturates. This module
replaces it with a single-acceptor asyncio loop (uvloop when importable,
stdlib event loop otherwise):

- **HTTP/1.1 keep-alive + pipelining**: one reader coroutine parses
  requests incrementally off each connection; one writer coroutine
  streams responses back in arrival order (pipelined requests answer
  in order, as HTTP requires).
- **Zero-copy window assembly**: filter-mode request bytes are sliced
  straight off the wire into the length-prefixed batch-blob format
  ``native.serialize_requests`` defines. A full ingest window reaches
  ``cko_tensorize`` as one contiguous blob via
  ``MicroBatcher.submit_window`` — zero per-request ``HttpRequest``
  materialization on the hot path.
- **Python path preserved** for everything the blob path cannot carry:
  per-request deadlines (X-CKO-Deadline-Ms), tenant routing
  (trust_tenant_header), the control endpoints, and bulk mode. Those
  run ``TpuEngineSidecar``'s shared reply functions on worker pools, so
  verdict mapping cannot drift from the threaded frontend.
- **Liveness is never queued**: /waf/v1/healthz and readyz answer
  inline on the event loop; stats/metrics/rollback run on a dedicated
  small control pool separate from the evaluation pool, so a saturated
  prepare queue cannot starve probes.
- **Ingress governance** (docs/SERVING.md "Overload & limits"): every
  byte-handling path is bounded by the shared :class:`IngressGovernor`
  — a global connection cap (503), header/body read deadlines (408,
  slowloris defense), a streaming body ceiling that answers 413
  *before/while* reading instead of after buffering, an in-flight byte
  ledger that sheds with 429 while control endpoints stay exempt, and
  write-side backpressure that disconnects readers too slow to drain
  their pipelined responses. One poisoned connection can never kill the
  acceptor loop: reader, writer, and window dispatch are individually
  exception-contained and counted.

Degraded-mode contracts are preserved window-at-a-time: breaker-open
and engine-unavailable windows answer per failurePolicy, queue-budget
shedding answers 429 with Retry-After (cko_shed_total stays
per-request), and device failures re-answer from the host fallback
exactly like the threaded path.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import struct
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from http.client import responses as _REASONS

from ..engine.request import HttpRequest
from ..utils import get_logger
from .batcher import LANE_BULK, LANE_INTERACTIVE, LANES, EngineUnavailable
from .degraded import BreakerOpen, Overloaded

log = get_logger("sidecar.ingest")

API_PREFIX = "/waf/v1/"
# Maximum bytes of request head (request line + headers). The threaded
# reference caps individual lines at 64 KiB; the async parser caps the
# whole head — past it the request answers 400 and the connection closes.
MAX_HEAD_BYTES = 65536
# Per-connection cap on pipelined responses not yet written back; the
# reader blocks on a semaphore (felt as TCP backpressure) once a client
# is this far ahead of the writer.
MAX_PIPELINED = 256
# Writer-side drain threshold: with a pipelining client the writer only
# awaits drain() when the transport buffer is already this deep (or the
# queue is empty), so slow readers are detected without serializing the
# fast path on every response.
_WRITE_HIGH_WATER = 1 << 20

_METHODS_WITH_BODY = {b"POST", b"PUT", b"PATCH", b"DELETE"}
_KNOWN_METHODS = {b"GET"} | _METHODS_WITH_BODY
# Headers the router needs by name; everything else is carried as raw
# bytes into the blob untouched.
_SPECIAL = {
    b"content-length",
    b"transfer-encoding",
    b"connection",
    b"x-cko-deadline-ms",
    b"x-waf-tenant",
    b"authorization",
    b"traceparent",
}
# Probe/operator targets that must stay answerable under memory
# pressure: the byte-ledger shed never applies to them.
_CONTROL_TARGETS = {
    b"/waf/v1/healthz",
    b"/waf/v1/readyz",
    b"/waf/v1/stats",
    b"/waf/v1/metrics",
    b"/waf/v1/rollback",
    b"/waf/v1/quarantine/flush",
    b"/waf/v1/cache/flush",
    b"/waf/v1/trace",
    b"/waf/v1/profile",
}
_pack = struct.pack


class _ReadTimeout(Exception):
    """A per-connection read deadline expired mid-request (→ 408)."""


class _Truncated(Exception):
    """The peer closed (or reset) before the framed bytes arrived."""

    def __init__(self, partial: bytes = b""):
        super().__init__("truncated read")
        self.partial = partial


class _BodyTooLarge(Exception):
    """Streaming body grew past the governor ceiling (→ 413)."""


class _ConnReader:
    """Buffered, deadline-aware reader over an ``asyncio.StreamReader``.

    ``readuntil``/``readexactly`` cannot distinguish an idle keep-alive
    connection from a slowloris trickling header bytes, and offer no way
    to recover partial bytes on timeout. This wrapper owns the buffer,
    so every read primitive can carry a deadline and report exactly what
    arrived.
    """

    __slots__ = ("_r", "_loop", "buf", "eof")
    CHUNK = 65536

    def __init__(self, reader: asyncio.StreamReader, loop) -> None:
        self._r = reader
        self._loop = loop
        self.buf = bytearray()
        self.eof = False

    async def _fill(self, timeout: float | None) -> bool:
        """Pull one chunk into the buffer; False on EOF; raises
        ``asyncio.TimeoutError`` when the deadline has passed."""
        if self.eof:
            return False
        if timeout is not None and timeout <= 0:
            raise asyncio.TimeoutError
        if timeout is not None:
            data = await asyncio.wait_for(self._r.read(self.CHUNK), timeout)
        else:
            data = await self._r.read(self.CHUNK)
        if not data:
            self.eof = True
            return False
        self.buf += data
        return True

    async def read_head(self, idle_timeout: float, header_timeout: float, max_bytes: int):
        """Read one request head (through ``\\r\\n\\r\\n``).

        Returns ``(head, None)`` or ``(None, err)`` with err in
        ``{"idle", "timeout", "overrun", "closed", "partial"}``. The
        idle timeout applies while nothing has arrived (a quiet
        keep-alive connection — closed silently); the header timeout is
        a *total* deadline from the first head byte, which is what
        defeats a slowloris trickling one byte per poll.
        """
        started: float | None = None
        while True:
            i = self.buf.find(b"\r\n\r\n")
            if i >= 0:
                if i + 4 > max_bytes:
                    return None, "overrun"
                head = bytes(self.buf[: i + 4])
                del self.buf[: i + 4]
                return head, None
            if len(self.buf) > max_bytes:
                return None, "overrun"
            empty = not bytes(self.buf).strip()
            if not empty and started is None:
                started = self._loop.time()
            if empty:
                timeout = idle_timeout if idle_timeout > 0 else None
            elif header_timeout > 0:
                timeout = header_timeout - (self._loop.time() - started)
            else:
                timeout = None
            try:
                more = await self._fill(timeout)
            except asyncio.TimeoutError:
                return None, ("idle" if empty else "timeout")
            except (ConnectionError, OSError):
                more = False
            if not more:
                return None, ("partial" if bytes(self.buf).strip() else "closed")

    async def read_exactly(self, n: int, deadline: float | None) -> bytes:
        """Read exactly ``n`` bytes by an absolute loop-time deadline.
        Raises ``_ReadTimeout`` or ``_Truncated`` (carrying the partial
        bytes, so callers can evaluate what arrived)."""
        while len(self.buf) < n:
            timeout = None if deadline is None else deadline - self._loop.time()
            try:
                more = await self._fill(timeout)
            except asyncio.TimeoutError:
                raise _ReadTimeout from None
            except (ConnectionError, OSError):
                more = False
            if not more:
                partial = bytes(self.buf)
                self.buf = bytearray()
                raise _Truncated(partial)
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    async def read_line(self, deadline: float | None, limit: int = 65536) -> bytes:
        while True:
            i = self.buf.find(b"\n")
            if i >= 0:
                line = bytes(self.buf[: i + 1])
                del self.buf[: i + 1]
                return line
            if len(self.buf) > limit:
                raise _Truncated(bytes(self.buf))
            timeout = None if deadline is None else deadline - self._loop.time()
            try:
                more = await self._fill(timeout)
            except asyncio.TimeoutError:
                raise _ReadTimeout from None
            except (ConnectionError, OSError):
                more = False
            if not more:
                raise _Truncated(b"")


def _parse_head(head: bytes):
    """Parse request line + headers from a ``\\r\\n\\r\\n``-terminated head.

    Returns ``(method, target, version, header_pairs, special)`` with every
    field as raw bytes (the blob hot path must not round-trip through str),
    or None when malformed. ``special`` maps lowercased names from
    ``_SPECIAL`` to their FIRST occurrence (http.client semantics).
    """
    head = head[:-4]
    # RFC 7230 §3.5 robustness: ignore blank line(s) before the request line.
    while head.startswith(b"\r\n"):
        head = head[2:]
    lines = head.split(b"\r\n")
    parts = lines[0].split()
    if len(parts) != 3 or not parts[2].startswith(b"HTTP/"):
        return None
    pairs: list[tuple[bytes, bytes]] = []
    for ln in lines[1:]:
        if not ln:
            continue
        if ln[0:1] in (b" ", b"\t") and pairs:  # obs-fold continuation
            k, v = pairs[-1]
            pairs[-1] = (k, v + b" " + ln.strip())
            continue
        i = ln.find(b":")
        if i <= 0:
            return None
        pairs.append((ln[:i].strip(), ln[i + 1 :].strip()))
    special: dict[bytes, bytes] = {}
    for k, v in pairs:
        lk = k.lower()
        if lk in _SPECIAL and lk not in special:
            special[lk] = v
    return parts[0], parts[1], parts[2], pairs, special


def _deadline_from(special: dict) -> float | None:
    """Absolute monotonic deadline from X-CKO-Deadline-Ms (threaded
    ``_Handler._deadline_s`` semantics: unparsable or <=0 means none)."""
    raw = special.get(b"x-cko-deadline-ms")
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        return None
    if ms <= 0:
        return None
    return _time.monotonic() + ms / 1e3


def _materialize(
    method: bytes, target_s: str, version: bytes, pairs, body: bytes, remote_b: bytes
) -> HttpRequest:
    return HttpRequest(
        method=method.decode("latin-1", "replace"),
        uri=target_s,
        version=version.decode("latin-1", "replace"),
        headers=[
            (k.decode("latin-1", "replace"), v.decode("latin-1", "replace"))
            for k, v in pairs
        ],
        body=body,
        remote_addr=remote_b.decode("latin-1", "replace"),
    )


class AsyncIngestFrontend:
    """Single-acceptor asyncio HTTP/1.1 frontend for TpuEngineSidecar."""

    def __init__(self, sidecar):
        self.sidecar = sidecar
        cfg = sidecar.config
        # Bind eagerly so ``sidecar.port`` is known before start() (the
        # threaded frontend binds in its constructor too).
        self._sock = socket.create_server((cfg.host, cfg.port), backlog=1024)
        self._sock.setblocking(False)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._stopping = False
        workers = int(os.environ.get("CKO_INGEST_WORKERS", "32") or 32)
        # Evaluation pool (bulk mode, Python-path filter requests,
        # fallback windows) is separate from the tiny control pool
        # (stats/metrics/rollback) so operator probes never queue behind
        # saturated evaluation threads.
        self._eval_pool = ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix="cko-ingest-eval"
        )
        self._ctl_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="cko-ingest-ctl"
        )
        # Windows under assembly, one per priority lane:
        # headers-only requests accumulate in the interactive window,
        # bodied ones in the bulk window, so a bodied flood never rides
        # (or delays) a headers-only window. Loop-thread only — no locks
        # anywhere on the hot path.
        self._win_buf = {lane: bytearray() for lane in LANES}
        self._win_futs: dict[str, list[asyncio.Future]] = {
            lane: [] for lane in LANES
        }
        # Flight-recorder contexts aligned with _win_futs. Lazily
        # materialized: None until some request in the window is traced,
        # so the sampling-off hot path never touches it.
        self._win_traces: dict[str, list | None] = {lane: None for lane in LANES}
        self._tracer = sidecar.tracer
        self._win_timer: dict[str, asyncio.TimerHandle | None] = {
            lane: None for lane in LANES
        }
        self._inflight_windows = 0
        # Counters (written on the loop thread; racy cross-thread reads
        # are fine for metrics).
        self.loop_impl = "asyncio"
        self.connections = 0
        self.connections_total = 0
        self.requests_total = 0
        self.bytes_total = 0
        self.parse_s = 0.0
        self.windows_total = 0
        self.window_requests_total = 0
        self.lane_windows_total = {lane: 0 for lane in LANES}
        self.python_path_requests_total = 0
        self._render_cache: dict = {}

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="sidecar-ingest", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=30) or self._loop is None:
            raise RuntimeError("async ingest frontend failed to start")

    def _run(self) -> None:
        try:
            import uvloop  # type: ignore[import-not-found]

            loop = uvloop.new_event_loop()
            self.loop_impl = "uvloop"
        except Exception:  # uvloop not baked into every image
            loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            self._server = loop.run_until_complete(
                asyncio.start_server(
                    self._handle_conn, sock=self._sock, limit=MAX_HEAD_BYTES
                )
            )
            self._started.set()
            loop.run_forever()
            loop.run_until_complete(self._drain())
        except Exception as err:
            log.error("ingest loop failed", err)
            self._started.set()
        finally:
            try:
                loop.close()
            except Exception:
                pass

    def stop(self) -> None:
        if self._loop is None or self._stopping:
            return
        self._stopping = True

        def halt():
            if self._server is not None:
                self._server.close()
            self._flush_window()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(halt)
        except RuntimeError:
            pass
        if self._thread is not None:
            drain_s = self._drain_budget_s()
            self._thread.join(timeout=max(10.0, drain_s + 5.0))
        self._eval_pool.shutdown(wait=False)
        self._ctl_pool.shutdown(wait=False)

    def _drain_budget_s(self) -> float:
        """Shutdown drain budget: drain_timeout_s, widened during a
        GRACEFUL termination (sidecar.begin_drain) to the process drain
        budget (docs/RECOVERY.md) — a SIGTERM drains in-flight windows to
        real verdicts instead of force-closing them at the 2s default."""
        drain_s = getattr(self.sidecar.config, "drain_timeout_s", 2.0)
        if getattr(self.sidecar, "draining", False):
            drain_s = max(drain_s, getattr(self.sidecar, "drain_budget_s", 0.0))
        return max(0.0, drain_s)

    async def _drain(self) -> None:
        """Bounded shutdown drain: dispatched windows get a moment to
        resolve so queued clients see answers instead of resets. The
        budget is ``SidecarConfig.drain_timeout_s`` (widened to the
        graceful-termination budget while draining); connections still
        open when it expires are force-closed and counted in
        ``cko_ingest_aborted_total``."""
        deadline = self._loop.time() + self._drain_budget_s()
        while self._inflight_windows > 0 and self._loop.time() < deadline:
            await asyncio.sleep(0.02)
        if self.connections > 0:
            self.sidecar.governor.count("aborted_total", self.connections)
        current = asyncio.current_task(self._loop)
        tasks = [t for t in asyncio.all_tasks(self._loop) if t is not current]
        for task in tasks:
            task.cancel()
        if tasks:
            # Let the cancellations unwind (connection handlers close
            # their writers) before the loop closes underneath them.
            try:
                await asyncio.wait_for(
                    asyncio.gather(*tasks, return_exceptions=True), timeout=2.0
                )
            except (asyncio.TimeoutError, Exception):
                pass

    # -- connection handling -------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        gov = self.sidecar.governor
        if not gov.try_admit_conn():
            # Over the global cap: answer 503 and close without ever
            # entering the read loop, so a connection storm cannot grow
            # per-connection state.
            try:
                writer.write(
                    self._render(
                        503,
                        b"too many connections\n",
                        {"Content-Type": "text/plain"},
                        False,
                    )
                )
                await writer.drain()
            except Exception:
                pass
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass
            return
        self.connections += 1
        self.connections_total += 1
        queue: asyncio.Queue = asyncio.Queue()
        # Bounded-queue semantics (asyncio.Queue(MAX_PIPELINED)) without
        # a blocking put: the reader acquires one slot per request and
        # the writer releases it once the response is on the wire, so
        # the EOF sentinel below can still use put_nowait unconditionally.
        sem = asyncio.Semaphore(MAX_PIPELINED)
        rtask = asyncio.ensure_future(self._read_guarded(reader, writer, queue, sem))
        # Reliable writer wakeup on EOF/parse-exit: the sentinel put can
        # never be lost because it bypasses the slot semaphore.
        rtask.add_done_callback(lambda _t: queue.put_nowait(None))
        try:
            await self._write_responses(queue, writer, sem)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            gov.count("conn_errors_total")
            log.error("ingest writer failed", err)
        finally:
            rtask.cancel()
            try:
                await rtask
            except (asyncio.CancelledError, Exception):
                pass
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass
            # Responses the writer never consumed still hold ledger
            # bytes — return them before the connection disappears.
            while not queue.empty():
                item = queue.get_nowait()
                if item is not None:
                    gov.discharge(item[2])
            self.connections -= 1
            gov.release_conn()

    async def _read_guarded(self, reader, writer, queue, sem) -> None:
        """Per-connection exception containment: a poisoned connection
        (parser bug, codec edge case) is counted and closed — it can
        never propagate into the acceptor loop."""
        try:
            await self._read_requests(reader, writer, queue, sem)
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError):
            pass
        except Exception as err:
            self.sidecar.governor.count("conn_errors_total")
            log.error("ingest reader failed", err)

    async def _read_requests(self, reader, writer, queue, sem) -> None:
        gov = self.sidecar.governor
        peer = writer.get_extra_info("peername")
        remote_b = (peer[0] if isinstance(peer, tuple) and peer else "").encode(
            "latin-1", "replace"
        )
        cr = _ConnReader(reader, self._loop)
        while True:
            # One reply-queue slot per request — blocking here is the
            # pipelining backpressure (client feels TCP backpressure).
            await sem.acquire()
            head, herr = await cr.read_head(
                gov.idle_timeout_s, gov.header_timeout_s, MAX_HEAD_BYTES
            )
            if herr is not None:
                if herr == "overrun":
                    self._put_static(queue, 400, b"request head too large\n")
                elif herr == "partial":
                    self._put_static(queue, 400, b"bad request\n")
                elif herr == "timeout":
                    # Slowloris: a partial head older than the header
                    # deadline. Answer 408 and close.
                    gov.count("deadline_closed_total")
                    self._put_static(queue, 408, b"request header timeout\n")
                # "idle" (quiet keep-alive) and "closed" end silently.
                return
            t0 = _time.perf_counter()
            parsed = _parse_head(head)
            self.parse_s += _time.perf_counter() - t0
            if parsed is None:
                self._put_static(queue, 400, b"bad request\n")
                return
            method, target, version, pairs, special = parsed
            if not version.startswith(b"HTTP/1."):
                # BaseHTTPRequestHandler taxonomy: an unparsable version
                # token is a 400 ("Bad request version"); a well-formed
                # version that simply isn't 1.x gets the 505. (HTTP/0.9
                # is not served here — the threaded escape hatch keeps
                # the stdlib's bare-body 0.9 reply for that museum piece.)
                vparts = version[5:].split(b".") if version.startswith(b"HTTP/") else []
                if len(vparts) != 2 or not all(
                    p.isdigit() and 0 < len(p) <= 10 for p in vparts
                ):
                    self._put_static(queue, 400, b"bad request version\n")
                else:
                    self._put_static(queue, 505, b"http version not supported\n")
                return
            if method not in _KNOWN_METHODS:
                self._put_static(queue, 501, b"unsupported method\n")
                return
            is_ctl = target.split(b"?", 1)[0] in _CONTROL_TARGETS
            # -- body ---------------------------------------------------------
            body = b""
            close_after = False
            body_deadline = (
                self._loop.time() + gov.body_timeout_s if gov.body_timeout_s > 0 else None
            )
            if b"chunked" in special.get(b"transfer-encoding", b"").lower():
                if not is_ctl and not gov.can_admit(len(head)):
                    gov.count("shed_total")
                    self._put_shed(queue)
                    return
                try:
                    body, malformed = await self._read_chunked(
                        cr, body_deadline, gov.max_body_bytes
                    )
                except _BodyTooLarge:
                    gov.count("body_limit_total")
                    self._put_static(queue, 413, b"request body too large\n")
                    return
                except _ReadTimeout:
                    gov.count("deadline_closed_total")
                    self._put_static(queue, 408, b"request body timeout\n")
                    return
                # Lenient decode mirrors the threaded parser; after a
                # malformed chunk the connection framing is unknowable,
                # so answer what was decoded, then close.
                close_after = malformed
            else:
                cl = special.get(b"content-length")
                if cl:
                    try:
                        length = int(cl)
                        if length < 0:
                            raise ValueError
                    except ValueError:
                        self._put_static(queue, 400, b"bad content-length\n")
                        return
                    if 0 <= gov.max_body_bytes < length:
                        # Streaming enforcement: the declared size alone
                        # rejects — the body is never buffered.
                        gov.count("body_limit_total")
                        self._put_static(queue, 413, b"request body too large\n")
                        return
                    if not is_ctl and not gov.can_admit(len(head) + length):
                        gov.count("shed_total")
                        self._put_shed(queue)
                        return
                    if length > 0:
                        try:
                            body = await cr.read_exactly(length, body_deadline)
                        except _ReadTimeout:
                            gov.count("deadline_closed_total")
                            self._put_static(queue, 408, b"request body timeout\n")
                            return
                        except _Truncated as terr:
                            # Threaded parity: rfile.read() returns the
                            # partial body at EOF and evaluates it; the
                            # connection is gone either way.
                            body = terr.partial
                            close_after = True
            nbytes = len(head) + len(body)
            # Per-tenant weighted-fair admission: the byte
            # ledger is sliced per tenant, and under memory pressure the
            # tenant over its weighted share sheds BEFORE the global
            # budget trips for everyone else.
            tenant = None
            if not is_ctl and self.sidecar.config.trust_tenant_header:
                t = special.get(b"x-waf-tenant")
                tenant = t.decode("latin-1", "replace") if t else None
            if tenant is not None and gov.tenant_over_share(tenant, nbytes):
                gov.count("shed_total")
                gov.count_tenant_shed(tenant)
                self._put_shed(queue, tenant=tenant)
                return
            gov.charge(nbytes, tenant=tenant)
            self.bytes_total += nbytes
            self.requests_total += 1
            conn_tok = special.get(b"connection", b"").lower()
            if version == b"HTTP/1.1":
                keep_alive = b"close" not in conn_tok
            else:
                keep_alive = b"keep-alive" in conn_tok
            if close_after:
                keep_alive = False
            fut = self._route(method, target, version, pairs, special, body, remote_b)
            queue.put_nowait((fut, keep_alive, nbytes, tenant))
            if not keep_alive:
                return

    async def _read_chunked(self, cr: _ConnReader, deadline, max_body: int):
        """Lenient chunked decode (threaded ``_read_chunked`` semantics:
        an unparsable size line stops decoding and evaluates what
        arrived). Returns (body, malformed); raises ``_BodyTooLarge``
        the moment declared chunk sizes pass the ceiling (streaming
        enforcement) and ``_ReadTimeout`` past the body deadline."""
        chunks: list[bytes] = []
        total = 0
        while True:
            try:
                size_line = await cr.read_line(deadline)
            except _Truncated:
                return b"".join(chunks), True
            try:
                size = int(size_line.strip().split(b";", 1)[0], 16)
            except ValueError:
                return b"".join(chunks), True
            if size < 0:
                return b"".join(chunks), True
            if size == 0:
                try:
                    while (await cr.read_line(deadline)).strip():  # trailers
                        pass
                except _Truncated:
                    pass
                return b"".join(chunks), False
            total += size
            if 0 <= max_body < total:
                raise _BodyTooLarge
            try:
                chunks.append(await cr.read_exactly(size, deadline))
                await cr.read_line(deadline)  # CRLF after chunk data
            except _Truncated as err:
                if err.partial:
                    chunks.append(err.partial)
                return b"".join(chunks), True

    async def _write_responses(self, queue, writer, sem) -> None:
        gov = self.sidecar.governor
        write_timeout = gov.write_timeout_s
        try:
            while True:
                item = await queue.get()
                if item is None:
                    return
                fut, keep_alive, charge, tenant = item
                try:
                    try:
                        status, payload, headers = await fut
                    except asyncio.CancelledError:
                        raise
                    except Exception as err:
                        log.error("ingest response future failed", err)
                        status, payload, headers = (
                            500,
                            b"internal error\n",
                            {"Content-Type": "text/plain"},
                        )
                    writer.write(self._render(status, payload, headers, keep_alive))
                    transport = writer.transport
                    if queue.empty() or (
                        transport is not None
                        and transport.get_write_buffer_size() > _WRITE_HIGH_WATER
                    ):
                        try:
                            if write_timeout > 0:
                                await asyncio.wait_for(writer.drain(), write_timeout)
                            else:
                                await writer.drain()
                        except asyncio.TimeoutError:
                            # Slow reader: responses are piling up in the
                            # transport faster than the peer drains them.
                            gov.count("slow_disconnects_total")
                            try:
                                writer.transport.abort()
                            except Exception:
                                pass
                            return
                finally:
                    gov.discharge(charge, tenant=tenant)
                    sem.release()
                if not keep_alive:
                    return
        except (ConnectionError, OSError):
            pass

    def _render(self, status, payload, headers, keep_alive) -> bytes:
        # Traced responses carry a per-request traceparent header — they
        # would fill the small-response cache with single-use entries.
        cacheable = len(payload) <= 256 and "traceparent" not in headers
        if cacheable:
            key = (status, payload, tuple(headers.items()), keep_alive)
            cached = self._render_cache.get(key)
            if cached is not None:
                return cached
        reason = _REASONS.get(status, "")
        parts = [f"HTTP/1.1 {status} {reason}\r\nServer: cko-tpu-engine\r\n"]
        for k, v in headers.items():
            parts.append(f"{k}: {v}\r\n")
        parts.append(f"Content-Length: {len(payload)}\r\n")
        if not keep_alive:
            parts.append("Connection: close\r\n")
        parts.append("\r\n")
        out = "".join(parts).encode("latin-1", "replace") + payload
        if cacheable and len(self._render_cache) < 256:
            self._render_cache[key] = out
        return out

    def _put_static(self, queue, status: int, payload: bytes) -> None:
        fut = self._loop.create_future()
        fut.set_result((status, payload, {"Content-Type": "text/plain"}))
        queue.put_nowait((fut, False, 0, None))

    def _put_shed(self, queue, tenant: str | None = None) -> None:
        """Memory-budget shed: same 429 + Retry-After + x-waf-action
        surface the queue-budget shed uses, so clients back off the same
        way regardless of which budget tripped. Retry-After scales with
        the live backlog (sidecar.shed_retry_after)."""
        sc = self.sidecar
        msg = (
            f"tenant {tenant!r} over weighted fair share"
            if tenant is not None
            else "ingress memory budget exceeded"
        )
        err = Overloaded(msg, retry_after_s=sc.shed_retry_after())
        fut = self._loop.create_future()
        fut.set_result(sc.overloaded_reply(err, as_json=False))
        queue.put_nowait((fut, False, 0, None))

    # -- routing -------------------------------------------------------------

    def _route(self, method, target, version, pairs, special, body, remote_b):
        sc = self.sidecar
        target_s = target.decode("latin-1", "replace")
        path, _, query = target_s.partition("?")
        if path.startswith(API_PREFIX):
            return self._route_api(method, path, special, body, query)
        # -- filter mode ------------------------------------------------------
        # Flight recorder: one dict probe + one attribute read when off
        # and no header — the zero-hot-path-cost contract. The span (when
        # any) rides the window into the batcher and is committed when
        # the reply resolves.
        ctx = None
        tp = special.get(b"traceparent")
        if tp is not None or self._tracer.sample_rate > 0.0:
            t_accept = _time.monotonic()
            ctx = self._tracer.start(tp, t_accept=t_accept)
            if ctx is not None:
                # The head was parsed just before routing; accept and
                # parse collapse onto the route entry point (same
                # convention as the threaded frontend).
                ctx.event("accept", t_accept, t_accept, track="frontend")
                ctx.event("parse", t_accept, t_accept, track="frontend")
        # Threaded parity: GET bodies are consumed for framing but not
        # evaluated (do_GET calls _handle_filter(b"")).
        eval_body = body if method != b"GET" else b""
        deadline_s = _deadline_from(special)
        if deadline_s is not None or sc.config.trust_tenant_header:
            # Python path: per-request deadlines and tenant routing need
            # the object pipeline (per-tenant engines, deadline-aware
            # fallback rescue).
            self.python_path_requests_total += 1
            tenant = None
            if sc.config.trust_tenant_header:
                t = special.get(b"x-waf-tenant")
                tenant = t.decode("latin-1", "replace") if t else None
            req = _materialize(method, target_s, version, pairs, eval_body, remote_b)
            return self._spawn(
                self._eval_pool, self._python_filter, req, tenant, deadline_s, ctx
            )
        # -- hot path: slice the wire bytes straight into the native
        # batch-blob record (native.serialize_requests wire format; zero
        # HttpRequest materialization). Lane split at the same point:
        # headers-only requests build the interactive window, bodied
        # ones the bulk window.
        t0 = _time.perf_counter()
        lane = LANE_BULK if eval_body else LANE_INTERACTIVE
        buf = self._win_buf[lane]
        buf += _pack("<I", len(method))
        buf += method
        buf += _pack("<I", len(target))
        buf += target
        buf += _pack("<I", len(version))
        buf += version
        buf += _pack("<I", len(pairs))
        for k, v in pairs:
            buf += _pack("<I", len(k))
            buf += k
            buf += _pack("<I", len(v))
            buf += v
        buf += _pack("<I", len(eval_body))
        buf += eval_body
        buf += _pack("<I", len(remote_b))
        buf += remote_b
        fut = self._loop.create_future()
        futs = self._win_futs[lane]
        futs.append(fut)
        if ctx is not None:
            if self._win_traces[lane] is None:
                self._win_traces[lane] = [None] * (len(futs) - 1)
            self._win_traces[lane].append(ctx)
        elif self._win_traces[lane] is not None:
            self._win_traces[lane].append(None)
        self.parse_s += _time.perf_counter() - t0
        if len(futs) >= sc.config.max_batch_size:
            self._flush_window(lane)
        elif self._win_timer[lane] is None:
            # Live per-lane delay (scheduler-tuned): the interactive
            # window closes on its own (typically shorter) timer.
            delay = max(sc.batcher.lane_delay_s[lane], 0.0)
            self._win_timer[lane] = self._loop.call_later(
                delay, self._flush_window, lane
            )
        return fut

    def _route_api(self, method, path, special, body, query=""):
        sc = self.sidecar
        if method == b"GET":
            if path == API_PREFIX + "healthz":
                return self._done(sc.healthz_reply())
            if path == API_PREFIX + "readyz":
                return self._done(sc.readyz_reply())
            if path == API_PREFIX + "stats":
                return self._spawn(self._ctl_pool, self._stats_reply)
            if path == API_PREFIX + "metrics":
                auth = special.get(b"authorization")
                return self._spawn(
                    self._ctl_pool,
                    sc.metrics_reply,
                    auth.decode("latin-1", "replace") if auth else None,
                )
            if path == API_PREFIX + "trace":
                return self._spawn(self._ctl_pool, sc.trace_reply, query)
        else:
            if path == API_PREFIX + "evaluate":
                t = special.get(b"x-waf-tenant")
                return self._spawn(
                    self._eval_pool,
                    sc.bulk_reply,
                    body,
                    t.decode("latin-1", "replace") if t else None,
                    _deadline_from(special),
                )
            if path == API_PREFIX + "rollback":
                return self._spawn(self._ctl_pool, sc.rollback_reply, body)
            if path == API_PREFIX + "quarantine/flush":
                return self._spawn(
                    self._ctl_pool, sc.quarantine_flush_reply, body
                )
            if path == API_PREFIX + "cache/flush":
                return self._spawn(self._ctl_pool, sc.cache_flush_reply, body)
            if path == API_PREFIX + "profile":
                auth = special.get(b"authorization")
                return self._spawn(
                    self._ctl_pool,
                    sc.profile_reply,
                    auth.decode("latin-1", "replace") if auth else None,
                    body,
                )
        return self._done(
            (
                404,
                json.dumps({"error": "not found"}).encode(),
                {"Content-Type": "application/json"},
            )
        )

    # -- flight-recorder plumbing --------------------------------------------

    def _python_filter(self, req, tenant, deadline_s, ctx):
        """Python-path filter evaluation (evaluation pool thread) with
        the trace sealed onto the reply — mirrors the threaded
        ``_handle_filter`` exactly."""
        reply = self.sidecar.filter_reply(
            req, tenant=tenant, deadline_s=deadline_s, span=ctx
        )
        return self._finish_trace(reply, ctx)

    def _finish_trace(self, reply, ctx):
        """Echo the response traceparent, stamp the reply span, and
        commit the flight record. Identity for untraced requests."""
        if ctx is None:
            return reply
        status, payload, headers = reply
        headers = {**(headers or {}), "traceparent": ctx.response_traceparent()}
        t_reply = _time.monotonic()
        ctx.event("reply", t_reply, t_reply, track="frontend")
        self.sidecar.tracer.commit(ctx)
        return status, payload, headers

    def _answer_all_traced(
        self, futs, spans, make_reply, path=None, name=None
    ) -> None:
        """``_answer_all`` for windows that may carry flight-recorder
        contexts: each traced reply gets its degraded-branch tag, the
        response traceparent, and a committed record."""
        if not spans:
            self._answer_all(futs, make_reply)
            return
        sc = self.sidecar
        for i, f in enumerate(futs):
            if f.done():
                continue
            ctx = spans[i] if i < len(spans) else None
            if ctx is not None and path is not None:
                sc._span_degraded(ctx, path, name)
            f.set_result(self._finish_trace(make_reply(), ctx))

    def _stats_reply(self):
        return (
            200,
            json.dumps(self.sidecar.stats()).encode(),
            {"Content-Type": "application/json"},
        )

    def _done(self, reply) -> asyncio.Future:
        fut = self._loop.create_future()
        fut.set_result(reply)
        return fut

    def _spawn(self, pool, fn, *args) -> asyncio.Future:
        """Run a blocking reply function on a worker pool; resolve the
        response future back on the loop thread."""
        fut = self._loop.create_future()

        def run():
            try:
                reply = fn(*args)
            except Exception as err:
                log.error("ingest handler failed", err)
                reply = (
                    500,
                    json.dumps(
                        {"error": f"internal error: {type(err).__name__}"}
                    ).encode(),
                    {"Content-Type": "application/json"},
                )
            self._call_soon(self._resolve, fut, reply)

        try:
            pool.submit(run)
        except RuntimeError:  # pool shut down mid-stop
            fut.set_result((503, b"shutting down\n", {"Content-Type": "text/plain"}))
        return fut

    def _call_soon(self, fn, *args) -> None:
        try:
            self._loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:  # loop closed during shutdown
            pass

    @staticmethod
    def _resolve(fut: asyncio.Future, reply) -> None:
        if not fut.done():
            fut.set_result(reply)

    # -- window assembly + dispatch -------------------------------------------

    def _flush_window(self, lane: str | None = None) -> None:
        if lane is None:  # stop()/halt: close out every lane
            for each in LANES:
                self._flush_window(each)
            return
        timer = self._win_timer[lane]
        if timer is not None:
            timer.cancel()
            self._win_timer[lane] = None
        futs = self._win_futs[lane]
        if not futs:
            return
        # Ownership handoff, not a copy: the assembled bytearray itself
        # rides to the batcher (a fresh one replaces it for the next
        # window) and reaches C++ through the buffer protocol — the old
        # bytes() here re-paid every window's bytes once per flush.
        blob = self._win_buf[lane]
        spans = self._win_traces[lane]
        self._win_futs[lane] = []
        self._win_buf[lane] = bytearray()
        self._win_traces[lane] = None
        self.windows_total += 1
        self.window_requests_total += len(futs)
        self.lane_windows_total[lane] += 1
        try:
            self._dispatch_window(blob, futs, spans, lane)
        except Exception as err:
            # Dispatch containment: a routing bug answers this window
            # 500 instead of leaving futures (and connections) hanging.
            log.error("ingest window dispatch failed", err)
            reply = (500, b"internal error\n", {"Content-Type": "text/plain"})
            for f in futs:
                if not f.done():
                    f.set_result(reply)

    def _dispatch_window(
        self, blob: bytes | bytearray, futs: list, spans=None,
        lane: str = LANE_BULK
    ) -> None:
        """Route one assembled window. Runs on the loop thread — every
        step here is a cheap probe; blocking work goes to the batcher or
        the evaluation pool."""
        sc = self.sidecar
        engine = sc.tenants.engine_for(None)
        if engine is None:
            self._answer_all_traced(
                futs, spans, sc.unavailable_reply, "unavailable", "unavailable"
            )
            return
        try:
            route = sc.degraded.route(engine)
        except BreakerOpen:
            self._answer_all_traced(
                futs, spans, sc.breaker_filter_reply, "breaker", "breaker_open"
            )
            return
        if route == "fallback":
            self._inflight_windows += 1
            self._submit_eval(self._fallback_window, engine, blob, futs, spans)
            return
        try:
            sc._admit_device(len(futs), lane=lane)
        except Overloaded as err:
            reply = sc.overloaded_reply(err, as_json=False)
            self._answer_all_traced(futs, spans, lambda: reply, "shed", "shed")
            return
        self._inflight_windows += 1
        wfut = sc.batcher.submit_window(blob, len(futs), spans=spans, lane=lane)
        # Same budget ladder as the threaded bulk path: cold engines get
        # the compile budget; warmed ones the strict timeout plus a
        # bounded recompile grace (fresh-shape tier buckets mid-stream).
        timeout = sc._timeout_for([engine])
        if timeout <= sc.config.request_timeout_s:
            timeout += max(0.0, sc.config.recompile_grace_s)
        handle = self._loop.call_later(
            timeout, self._window_timeout, wfut, futs, spans
        )
        wfut.add_done_callback(
            lambda f: self._call_soon(
                self._window_done, f, futs, blob, engine, handle, spans
            )
        )

    def _window_timeout(self, wfut, futs, spans=None) -> None:
        # Threaded-path legacy-timeout contract: the failurePolicy
        # answers. Cancel so the batcher skips the window if still queued.
        wfut.cancel()
        self._answer_all_traced(
            futs, spans, self.sidecar.unavailable_reply, "error", "window_timeout"
        )

    def _window_done(self, wfut, futs, blob, engine, handle, spans=None) -> None:
        self._inflight_windows -= 1
        handle.cancel()
        sc = self.sidecar
        try:
            self._window_done_inner(wfut, futs, blob, engine, spans)
        except Exception as err:
            log.error("ingest window completion failed", err)
            reply = (500, b"internal error\n", {"Content-Type": "text/plain"})
            for f in futs:
                if not f.done():
                    f.set_result(reply)
            sc.governor.count("conn_errors_total")

    def _window_done_inner(self, wfut, futs, blob, engine, spans=None) -> None:
        sc = self.sidecar
        if wfut.cancelled():
            self._answer_all(futs, sc.unavailable_reply)
            return
        err = wfut.exception()
        if err is None:
            verdicts = wfut.result()
            # Verdict counters BEFORE the replies resolve: a client that
            # reads its answer then scrapes metrics must see it counted.
            # The audit half (blob materialization + file IO) stays off
            # the loop thread.
            sc.count_window(verdicts)
            if spans:
                for i, (f, v) in enumerate(zip(futs, verdicts)):
                    if not f.done():
                        ctx = spans[i] if i < len(spans) else None
                        f.set_result(
                            self._finish_trace(sc.verdict_filter_reply(v), ctx)
                        )
            else:
                for f, v in zip(futs, verdicts):
                    if not f.done():
                        f.set_result(sc.verdict_filter_reply(v))
            self._submit_eval(sc.record_window, engine, blob, verdicts, True)
            return
        if isinstance(err, EngineUnavailable):
            self._answer_all_traced(
                futs, spans, sc.unavailable_reply, "unavailable", "unavailable"
            )
            return
        if isinstance(err, BreakerOpen):
            self._answer_all_traced(
                futs, spans, sc.breaker_filter_reply, "breaker", "breaker_open"
            )
            return
        if isinstance(err, Overloaded):
            reply = sc.overloaded_reply(err, as_json=False)
            self._answer_all_traced(futs, spans, lambda: reply, "shed", "shed")
            return
        # Device failure: same rescue as the threaded path — re-answer
        # from the host fallback when enabled, else the failurePolicy.
        log.error("ingest window device path failed", err)
        if sc.degraded.fallback_enabled:
            self._inflight_windows += 1
            self._submit_eval(self._fallback_window, engine, blob, futs, spans)
            return
        self._answer_all_traced(
            futs, spans, sc.unavailable_reply, "error", "window_error"
        )

    def _fallback_window(self, engine, blob: bytes, futs: list, spans=None) -> None:
        """Host-fallback evaluation of a whole window (evaluation pool
        thread): materialize the blob, evaluate on the scalar path, and
        answer with the identical per-request accounting the threaded
        frontend performs."""
        sc = self.sidecar
        try:
            from ..native import blob_requests

            reqs = blob_requests(blob, len(futs))
            t0 = _time.monotonic()
            verdicts = sc._fallback_eval(engine, reqs)
            t1 = _time.monotonic()
            for ctx in spans or ():
                if ctx is not None:
                    ctx.annotate_path("fallback")
                    ctx.event("fallback_eval", t0, t1, track="degraded")
            replies = []
            for r, v in zip(reqs, verdicts):
                sc.record_verdict(r, v)
                replies.append(sc.verdict_filter_reply(v))
        except Overloaded as oerr:
            for ctx in spans or ():
                sc._span_degraded(ctx, "shed", "shed")
            replies = [sc.overloaded_reply(oerr, as_json=False)] * len(futs)
        except Exception as err:
            log.error("ingest window fallback failed", err)
            for ctx in spans or ():
                sc._span_degraded(ctx, "error", "fallback_error")
            replies = [sc.unavailable_reply() for _ in futs]

        def finish():
            self._inflight_windows -= 1
            if spans:
                for i, (f, r) in enumerate(zip(futs, replies)):
                    if not f.done():
                        ctx = spans[i] if i < len(spans) else None
                        f.set_result(self._finish_trace(r, ctx))
            else:
                for f, r in zip(futs, replies):
                    if not f.done():
                        f.set_result(r)

        self._call_soon(finish)

    def _answer_all(self, futs, make_reply) -> None:
        # make_reply is invoked once per unanswered request: unavailable/
        # breaker replies count fail-opens per request, same as the
        # threaded per-request handlers.
        for f in futs:
            if not f.done():
                f.set_result(make_reply())

    def _submit_eval(self, fn, *args) -> None:
        try:
            self._eval_pool.submit(fn, *args)
        except RuntimeError:  # pool shut down mid-stop
            pass

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "mode": "async",
            "loop": self.loop_impl,
            "connections": self.connections,
            "connections_total": self.connections_total,
            "requests_total": self.requests_total,
            "bytes_total": self.bytes_total,
            "parse_s": round(self.parse_s, 6),
            "windows": self.windows_total,
            "window_requests": self.window_requests_total,
            "lane_windows": dict(self.lane_windows_total),
            "python_path_requests": self.python_path_requests_total,
            "inflight_windows": self._inflight_windows,
        }
