"""PyTorch port parity: the ext_proc frontend, over real sockets, against
the JAX package's.

One JAX sidecar and one port sidecar (``device="cpu"``) serve the same
ruleset (``torch_rules.SMALL_RULES`` with ``test_torch_sidecar.py``'s
three-tier rules), each with its HTTP frontend and an ext_proc listener on
an ephemeral port, for each transport (``native`` and, where grpcio is
installed, ``grpcio``). Every request goes over ext_proc to both and over
HTTP to the port's: the two ext_proc answers must be equal in full, and
(status, ``x-waf-action``, ``x-waf-rule-id``) equal to the HTTP answer,
the body too where the request is refused (an allowed request proceeds
upstream over ext_proc, so it carries no body of the WAF's). Then the
governor's refusal taxonomy on both packages, byte-equal: 503 past the
connection cap, the 408 of the header/body deadline, the 413 body ceiling
and the 429 memory shed; the stats and metric names; the listener off by
default and a stray RPC answered UNIMPLEMENTED; and ``gpu-engine``'s
flags (``--extproc-port``) start a sidecar whose listener answers. Last,
the port's parked streams: a stream waiting for its verdict holds no
thread (one worker serves many streams, one window), the writer's
coalesced replies stay well formed, and a verdict timeout, a reset, a
closed connection and a missed client deadline each end a parked stream
as the blocking path would.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
from coraza_kubernetes_operator_tpu.sidecar import SidecarConfig as JConfig
from coraza_kubernetes_operator_tpu.sidecar import TpuEngineSidecar as JSidecar
from coraza_kubernetes_operator_tpu.sidecar import extproc as jx
from coraza_kubernetes_operator_tpu_torch import native
from coraza_kubernetes_operator_tpu_torch.cache import RuleSetCache as TCache
from coraza_kubernetes_operator_tpu_torch.cache import RuleSetCacheServer as TCacheServer
from coraza_kubernetes_operator_tpu_torch.cmd import gpu_engine
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine
from coraza_kubernetes_operator_tpu_torch.observability.tracing import WINDOWS
from coraza_kubernetes_operator_tpu_torch.ops import kernels
from coraza_kubernetes_operator_tpu_torch.sidecar import SidecarConfig as TConfig
from coraza_kubernetes_operator_tpu_torch.sidecar import TpuEngineSidecar as TSidecar
from coraza_kubernetes_operator_tpu_torch.sidecar import extproc as tx
from coraza_kubernetes_operator_tpu_torch.sidecar.batcher import LANES
from test_torch_sidecar import FIELDS, FILTER_REQUESTS, RULES, _send
from torch_hold import lanes_held

HOST = [("Host", "t")]


def _wait(predicate, timeout_s=60.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return False


@pytest.fixture(scope="module")
def engines():
    return JEngine(RULES), TEngine(RULES, device="cpu")


class Sidecars:
    """A JAX and a port sidecar on the module's engines, each with an
    ext_proc listener; started and ready on construction."""

    def __init__(self, engines, impl="native", **kw):
        common = dict(host="127.0.0.1", port=0, max_batch_size=64, max_batch_delay_ms=1.0,
                      frontend="threaded", extproc_port=0, extproc_impl=impl, **kw)
        self.j = JSidecar(JConfig(**common), engine=engines[0])
        self.t = TSidecar(TConfig(device="cpu", **common), engine=engines[1])
        self.j.start()
        self.t.start()
        assert _wait(lambda: self.j.ready() and self.t.ready())

    def ext(self, xp, sc, method, path, headers=(), body=b""):
        client = xp.ExtProcClient("127.0.0.1", sc.config.extproc_port)
        try:
            return client.filter(method, path, list(headers), body)
        finally:
            client.close()

    def both(self, method, path, headers=(), body=b""):
        """The request over ext_proc to both, each through its own
        package's client; asserts equal answers and returns the port's."""
        got_j = self.ext(jx, self.j, method, path, headers, body)
        got_t = self.ext(tx, self.t, method, path, headers, body)
        assert got_t == got_j, (method, path, got_t, got_j)
        return got_t

    def stop(self):
        self.t.stop()
        self.j.stop()


@pytest.fixture(scope="module", params=["native", "grpcio"])
def sidecars(request, engines):
    if request.param == "grpcio":
        pytest.importorskip("grpc")
    sc = Sidecars(engines, impl=request.param)
    assert (sc.j.config.extproc_impl, sc.t.config.extproc_impl) == (request.param,) * 2
    yield sc
    sc.stop()


def test_verdicts_equal_jax_and_http(sidecars):
    blocked = 0
    for method, path, headers, body in FILTER_REQUESTS:
        headers = HOST + list(headers)
        ext = sidecars.both(method, path, headers, body)
        http = _send(sidecars.t.port, method, path, headers, body)
        got = (ext["status"],) + tuple(ext["headers"].get(h) for h in FIELDS)
        assert got == http[:3], (method, path, ext, http)
        assert ext["allowed"] is (http[0] == 200)
        if not ext["allowed"]:
            blocked += 1
            assert ext["body"] == http[3]
    assert 0 < blocked < len(FILTER_REQUESTS)


def test_traceparent_echo_equal(sidecars):
    traceparent = "00-000102030405060708090a0b0c0d0e0f-0102030405060708-01"
    headers = HOST + [("traceparent", traceparent)]
    ext = sidecars.both("GET", "/?q=fgfgeh", headers)
    http = dict(zip(("status", "traceparent"), _traceparent(sidecars.t.port, headers)))
    assert (ext["status"], ext["headers"]["traceparent"]) == (http["status"], http["traceparent"])
    assert ext["headers"]["traceparent"].split("-")[1] == "000102030405060708090a0b0c0d0e0f"


def _traceparent(port, headers):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/?q=fgfgeh", headers=dict(headers))
        resp = conn.getresponse()
        resp.read()
        return resp.status, resp.getheader("traceparent")
    finally:
        conn.close()


def test_stats_and_metrics_equal(sidecars):
    import urllib.request

    stats = sidecars.t.stats()["extproc"]
    assert stats["impl"] == sidecars.t.config.extproc_impl
    assert stats["port"] == sidecars.t.config.extproc_port
    assert stats["streams_total"] >= 1 and stats["immediate_total"] >= 1
    assert stats["continue_total"] >= 1
    # The port adds the parked-stream counter and its peak (grpcio blocks
    # a handler per stream, so both read 0 there).
    assert set(stats) == set(sidecars.j.stats()["extproc"]) | {"awaiting", "awaiting_peak"}
    assert 0 == stats["awaiting"] <= stats["awaiting_peak"]

    def names(sc):
        body = urllib.request.urlopen(f"http://127.0.0.1:{sc.port}/waf/v1/metrics", timeout=30).read()
        return {ln.split()[2] for ln in body.decode().splitlines()
                if ln.startswith("# TYPE cko_extproc_")}

    assert names(sidecars.t) == names(sidecars.j) | {"cko_extproc_streams_awaiting"}
    assert len(names(sidecars.t)) == 7


@pytest.mark.parametrize(
    "kw,request_args,want",
    [
        (dict(max_connections=0), ("GET", "/clean", HOST, b""), (503, b"too many connections\n")),
        (dict(max_body_bytes=16), ("POST", "/x", HOST, b"a" * 64), (413, b"request body too large\n")),
        (dict(ingress_memory_budget_bytes=8, shed_retry_after_s=2.0), ("GET", "/clean", HOST, b""),
         (429, b"WAF overloaded, retry later\n")),
    ],
    ids=["conn-cap-503", "body-ceiling-413", "memory-shed-429"],
)
def test_refusals_equal(engines, kw, request_args, want):
    sc = Sidecars(engines, **kw)
    try:
        out = sc.both(*request_args)
        assert (out["allowed"], out["status"], out["body"]) == (False,) + want
        counter = {503: "conns_rejected_total", 413: "body_limit_total", 429: "shed_total"}[want[0]]
        assert getattr(sc.t.governor, counter) == getattr(sc.j.governor, counter) >= 1
    finally:
        sc.stop()


def test_body_deadline_408_equal(engines):
    """A stream whose headers say a body follows, then stalls: both answer
    the header phase with a bare CONTINUE, then the reaper's 408."""
    sc = Sidecars(engines, header_timeout_s=0.3, body_timeout_s=0.3)

    def stall(xp, side):
        client = xp.ExtProcClient("127.0.0.1", side.config.extproc_port)
        try:
            client._send_headers(1)
            client._send_message(1, xp.encode_request_headers(
                [(":method", "POST"), (":path", "/x"), ("host", "t")], False))
            answers = []
            deadline = time.monotonic() + 10
            while len(answers) < 2:
                assert time.monotonic() < deadline
                kind, payload = client._read_event(1)
                if kind == "message":
                    answers.append(payload)
            return answers
        finally:
            client.close()

    try:
        got_t, got_j = stall(tx, sc.t), stall(jx, sc.j)
        assert got_t == got_j
        first, second = (tx.decode_processing_response(m) for m in got_t)
        assert first["kind"] == "continue"
        assert (second["kind"], second["status"], second["body"]) == (
            "immediate", 408, b"request body timeout\n")
        assert sc.t.governor.deadline_closed_total == sc.j.governor.deadline_closed_total >= 1
    finally:
        sc.stop()


def test_unknown_method_unimplemented(sidecars):
    """A stray RPC on the listener gets grpc-status 12 trailers."""
    def stray(xp, side):
        sock = socket.create_connection(("127.0.0.1", side.config.extproc_port), timeout=10)
        try:
            enc, dec = xp.HpackEncoder(), xp.HpackDecoder()
            sock.sendall(xp.H2_PREFACE + xp.h2_frame(xp._F_SETTINGS, 0, 0))
            block = enc.encode([(b":method", b"POST"), (b":scheme", b"http"),
                                (b":path", b"/some.other.Service/Method"), (b":authority", b"t"),
                                (b"content-type", b"application/grpc"), (b"te", b"trailers")])
            sock.sendall(xp.h2_frame(xp._F_HEADERS, xp._FLAG_END_HEADERS | xp._FLAG_END_STREAM, 1, block))
            while True:
                ftype, flags, sid, payload = xp.read_h2_frame(sock)
                if ftype == xp._F_SETTINGS and not flags & xp._FLAG_ACK:
                    sock.sendall(xp.h2_frame(xp._F_SETTINGS, xp._FLAG_ACK, 0))
                elif ftype == xp._F_HEADERS:
                    headers = {k.decode(): v.decode() for k, v in
                               dec.decode(xp._strip_padding(payload, flags, priority_ok=True))}
                    if sid == 1 and "grpc-status" in headers:
                        return headers["grpc-status"]
        finally:
            sock.close()

    assert stray(tx, sidecars.t) == stray(jx, sidecars.j) == "12"


def test_extproc_off_by_default(engines):
    sc = TSidecar(TConfig(host="127.0.0.1", port=0, frontend="threaded", device="cpu"), engine=engines[1])
    assert sc.stats()["extproc"] == {"enabled": False}
    assert sc.config.extproc_port is None


def test_env_port_opens_the_listener(engines, monkeypatch):
    """``CKO_EXTPROC_PORT`` opens it as the flag does, and the resolved
    port and transport are written back onto the config."""
    monkeypatch.setenv("CKO_EXTPROC_PORT", "0")
    monkeypatch.setenv("CKO_EXTPROC_IMPL", "native")
    sc = TSidecar(TConfig(host="127.0.0.1", port=0, frontend="threaded", device="cpu"), engine=engines[1])
    try:
        assert sc.config.extproc_port > 0 and sc.config.extproc_impl == "native"
        assert sc.stats()["extproc"]["port"] == sc.config.extproc_port
    finally:
        sc._extproc.stop()


def test_gpu_engine_flags_start_the_listener(monkeypatch):
    """``gpu-engine --extproc-port 0``'s config, on the CPU: the sidecar
    fetches the rules from a cache server, compiles them, and answers over
    ext_proc as over HTTP."""
    monkeypatch.delenv("CKO_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    cache = TCache()
    srv = TCacheServer(cache, host="127.0.0.1", port=0)
    srv.start()
    cache.put("default/waf", RULES)
    cfg = gpu_engine.build_config([
        "--cache-server-instance", "default/waf", "--cache-server-cluster", f"127.0.0.1:{srv.port}",
        "--bind-address", "127.0.0.1", "--port", "0", "--extproc-port", "0", "--extproc-impl", "native",
        "--rule-reload-interval-seconds", "0.05"])
    sc = TSidecar(dataclasses.replace(cfg, device="cpu"))
    try:
        sc.start()
        assert _wait(lambda: sc.serving_mode() == "promoted", 120), sc.serving_mode()
        assert sc.config.extproc_impl == "native" and sc.config.extproc_port > 0
        statuses = []
        for path in ("/?q=fgfgeh", "/index.html?q=hello"):
            client = tx.ExtProcClient("127.0.0.1", sc.config.extproc_port)
            try:
                ext = client.filter("GET", path, HOST, b"")
            finally:
                client.close()
            http = _send(sc.port, "GET", path, HOST)
            assert (ext["status"],) + tuple(ext["headers"].get(h) for h in FIELDS) == http[:3]
            statuses.append(ext["status"])
        assert statuses == [403, 200]
    finally:
        sc.stop()
        srv.stop()


def _port_sidecar(engine, **kw):
    """A started port sidecar with a native ext_proc listener, serving on
    the device path (promoted)."""
    cfg = dict(device="cpu", host="127.0.0.1", port=0, max_batch_size=64, max_batch_delay_ms=1.0,
               frontend="threaded", extproc_port=0, extproc_impl="native")
    cfg.update(kw)
    sc = TSidecar(TConfig(**cfg), engine=engine)
    sc.start()
    assert _wait(lambda: sc.serving_mode() == "promoted"), sc.serving_mode()
    return sc


def _record_submits(sc, monkeypatch):
    """The futures the batcher hands out, in submit order."""
    futs = []
    submit = sc.batcher.submit

    def recording(*args, **kw):
        fut = submit(*args, **kw)
        futs.append(fut)
        return fut

    monkeypatch.setattr(sc.batcher, "submit", recording)
    return futs


def _open_streams(client, requests):
    """Open one stream per request on ``client``'s connection at once, as
    Envoy multiplexes them, sending each request-headers message; returns
    ``{stream id: state}`` for ``_read_streams``."""
    streams = {}
    for method, path, headers, body in requests:
        sid = client._next_stream
        client._next_stream += 2
        authority = next((v for k, v in headers if k.lower() == "host"), client.authority)
        ext_headers = [(":method", method), (":scheme", "http"), (":authority", authority),
                       (":path", path)] + [(k.lower(), v) for k, v in headers if k.lower() != "host"]
        client._send_headers(sid)
        client._send_message(sid, tx.encode_request_headers(ext_headers, not body))
        streams[sid] = {"body": body, "frames": [], "buf": bytearray(), "mutation": {},
                        "verdict": None}
    return streams


def _read_streams(client, streams, timeout_s=60.0):
    """Read until every stream has ended: send each bodied stream's body
    after its header-phase CONTINUE, and record per stream the frames it
    got in order ("headers", "data", "trailers", "reset") and its verdict
    shaped as ``ExtProcClient.filter`` returns it."""
    open_ids = set(streams)
    deadline = time.monotonic() + timeout_s
    while open_ids:
        assert time.monotonic() < deadline, sorted(open_ids)
        ftype, flags, sid, payload = tx.read_h2_frame(client.sock)
        if ftype == tx._F_SETTINGS and not flags & tx._FLAG_ACK:
            client.sock.sendall(tx.h2_frame(tx._F_SETTINGS, tx._FLAG_ACK, 0))
        st = streams.get(sid)
        if st is None:
            continue
        if ftype == tx._F_HEADERS:
            headers = dict(client.decoder.decode(tx._strip_padding(payload, flags, priority_ok=True)))
            if flags & tx._FLAG_END_STREAM:
                st["frames"].append("trailers")
                st["grpc_status"] = headers.get(b"grpc-status")
                open_ids.discard(sid)
            else:
                st["frames"].append("headers")
        elif ftype == tx._F_RST_STREAM:
            st["frames"].append("reset")
            open_ids.discard(sid)
        elif ftype == tx._F_DATA:
            st["frames"].append("data")
            st["buf"] += tx._strip_padding(payload, flags)
            while len(st["buf"]) >= 5 and len(st["buf"]) >= 5 + int.from_bytes(st["buf"][1:5], "big"):
                mlen = int.from_bytes(st["buf"][1:5], "big")
                resp = tx.decode_processing_response(bytes(st["buf"][5:5 + mlen]))
                del st["buf"][:5 + mlen]
                if resp["kind"] == "immediate":
                    st["verdict"] = {"status": resp["status"], "headers": resp["headers"],
                                     "body": resp["body"], "allowed": False}
                elif resp["phase"] == "request_headers" and st["body"]:
                    client._send_message(sid, tx.encode_request_body(st["body"], True), end_stream=True)
                else:
                    st["mutation"].update(resp["headers"])
                    st["verdict"] = {"status": 200, "headers": st["mutation"], "body": b"",
                                     "allowed": True}
    return streams


def test_one_worker_does_not_hold_waiting_streams(engines, monkeypatch):
    """One ext_proc worker, two streams at once: neither holds the worker
    while it waits for its verdict, so both reach the batcher while its
    lane is held busy (within its 150 ms delay), share one window, and the
    window log records no wait for a worker."""
    monkeypatch.setenv("CKO_EXTPROC_WORKERS", "1")
    sc = _port_sidecar(engines[1], max_batch_delay_ms=150.0)
    futs = _record_submits(sc, monkeypatch)
    try:
        got = []

        def stream(path):
            client = tx.ExtProcClient("127.0.0.1", sc.config.extproc_port)
            try:
                got.append(client.filter("GET", path, HOST, b"")["status"])
            finally:
                client.close()

        with lanes_held(sc.batcher, sc.tenants.engine_for(None), until=lambda: len(futs) == 2):
            t0 = time.monotonic()
            threads = [threading.Thread(target=stream, args=(p,)) for p in ("/?a=1", "/?a=2")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        assert got == [200, 200]
        assert _wait(lambda: len(WINDOWS.records(t0)) >= 1, 10)
        (window,) = WINDOWS.records(t0)
        assert window.n_requests == 2
        assert window.extproc_wait_s < 0.1
    finally:
        sc.stop()


def test_many_streams_on_one_connection_park_without_threads(engines, monkeypatch):
    """48 concurrent streams on one connection, one ext_proc worker: every
    stream is parked on its verdict at once (more than the 32 workers the
    default pool has; both lanes are held busy until all 48 have reached
    the batcher), and each verdict equals the HTTP frontend's."""
    monkeypatch.setenv("CKO_EXTPROC_WORKERS", "1")
    sc = _port_sidecar(engines[1], max_batch_delay_ms=300.0)
    futs = _record_submits(sc, monkeypatch)
    try:
        requests = [(m, p, HOST + list(h), b) for m, p, h, b in FILTER_REQUESTS]
        requests = [requests[i % len(requests)] for i in range(48)]
        client = tx.ExtProcClient("127.0.0.1", sc.config.extproc_port)
        try:
            with lanes_held(sc.batcher, sc.tenants.engine_for(None), lanes=LANES,
                            until=lambda: len(futs) == len(requests)):
                streams = _read_streams(client, _open_streams(client, requests))
        finally:
            client.close()
        with ThreadPoolExecutor(len(FILTER_REQUESTS)) as pool:
            http = list(pool.map(lambda r: _send(sc.port, *r), requests[:len(FILTER_REQUESTS)]))
        for i, sid in enumerate(sorted(streams)):
            ext, want = streams[sid]["verdict"], http[i % len(http)]
            assert (ext["status"],) + tuple(ext["headers"].get(h) for h in FIELDS) == want[:3], requests[i]
            if not ext["allowed"]:
                assert ext["body"] == want[3]
        stats = sc.stats()["extproc"]
        assert stats["awaiting_peak"] >= 32
        assert stats["awaiting"] == 0
    finally:
        sc.stop()


def test_coalesced_replies_keep_frames_well_formed(engines, monkeypatch):
    """Streams that one window completes (they reach the batcher while its
    lane is held busy) are answered together by the connection's writer:
    each gets its response headers, one DATA, then its trailers, and the
    HPACK state stays in sync for the next request."""
    sc = _port_sidecar(engines[1], max_batch_delay_ms=300.0)
    futs = _record_submits(sc, monkeypatch)
    try:
        paths = ["/?q=fgfgeh", "/index.html?q=hello", "/?pet=evilpanda", "/?q=aaaaaaaad",
                 "/?q=Hello%20World", "/?a=ababc"]
        client = tx.ExtProcClient("127.0.0.1", sc.config.extproc_port)
        try:
            with lanes_held(sc.batcher, sc.tenants.engine_for(None),
                            until=lambda: len(futs) == len(paths)):
                t0 = time.monotonic()
                streams = _read_streams(client, _open_streams(client, [("GET", p, HOST, b"") for p in paths]))
            for st in streams.values():
                assert st["frames"] == ["headers", "data", "trailers"], st["frames"]
                assert st["grpc_status"] == b"0"
            assert [streams[s]["verdict"]["status"] for s in sorted(streams)] == [403, 200, 403, 403, 200, 403]
            assert _wait(lambda: len(WINDOWS.records(t0)) >= 1, 10)
            assert [w.n_requests for w in WINDOWS.records(t0)] == [len(paths)]
            again = client.filter("GET", "/?pet=evilpanda", HOST + [("traceparent",
                                  "00-000102030405060708090a0b0c0d0e0f-0102030405060708-01")], b"")
            assert (again["status"], again["headers"]["x-waf-rule-id"]) == (403, "2003")
            assert again["headers"]["traceparent"].split("-")[1] == "000102030405060708090a0b0c0d0e0f"
        finally:
            client.close()
    finally:
        sc.stop()


def test_verdict_timeout_answered_by_the_reaper(engines):
    """A parked stream whose verdict misses the request timeout (the
    batcher's lane is held busy, so its window stays open, for up to its
    5 s delay) gets the failure-policy reply when the timeout passes, as
    the HTTP frontend answers it."""
    sc = _port_sidecar(engines[1], max_batch_delay_ms=5000.0, request_timeout_s=0.3,
                       compile_timeout_s=0.3)
    try:
        with lanes_held(sc.batcher, sc.tenants.engine_for(None)):
            client = tx.ExtProcClient("127.0.0.1", sc.config.extproc_port)
            try:
                t0 = time.monotonic()
                got = client.filter("GET", "/?q=fgfgeh", HOST, b"")
                waited = time.monotonic() - t0
            finally:
                client.close()
            http = _send(sc.port, "GET", "/?q=fgfgeh", HOST)
        assert (got["status"], got["headers"].get("x-waf-action"), got["body"]) == (
            http[0], http[1], http[3]) == (503, "fail-closed", b"WAF unavailable (fail-closed)\n")
        assert 0.25 < waited < 3.0
        assert sc.stats()["extproc"]["awaiting"] == 0
    finally:
        sc.stop()


def test_reset_cancels_a_parked_stream(engines, monkeypatch):
    """RST_STREAM on a parked stream (its lane held busy, so its window
    stays open) cancels its batcher future, gives back its in-flight bytes
    and connection slot, and nothing more is written on the stream, not
    even after its window has closed."""
    sc = _port_sidecar(engines[1], max_batch_delay_ms=1000.0)
    futs = _record_submits(sc, monkeypatch)
    gov = sc.governor
    try:
        client = tx.ExtProcClient("127.0.0.1", sc.config.extproc_port)
        try:
            with lanes_held(sc.batcher, sc.tenants.engine_for(None)):
                _open_streams(client, [("GET", "/?q=fgfgeh", HOST, b"")])
                assert _wait(lambda: sc.stats()["extproc"]["awaiting"] == 1, 10)
                assert gov.inflight_bytes > 0 and gov.connections == 1
                client.sock.sendall(tx.h2_frame(tx._F_RST_STREAM, 0, 1, (8).to_bytes(4, "big")))
                assert _wait(lambda: sc.stats()["extproc"]["awaiting"] == 0, 10)
                assert _wait(lambda: gov.inflight_bytes == 0 and gov.connections == 0, 10)
                assert len(futs) == 1 and futs[0].cancelled()
            # The lane is free: the stream's window closes now.
            client.sock.settimeout(0.3)
            end = time.monotonic() + 1.5
            while time.monotonic() < end:
                try:
                    ftype, _, sid, _ = tx.read_h2_frame(client.sock)
                except socket.timeout:
                    continue
                # The flow-control update for its DATA came before the reset.
                assert not (sid == 1 and ftype in (tx._F_HEADERS, tx._F_DATA)), ftype
        finally:
            client.close()
    finally:
        sc.stop()


def test_connection_close_releases_parked_streams(engines, monkeypatch):
    """Closing a connection with parked streams (their lane held busy, so
    their window stays open) cancels their futures and gives back every
    stream's connection slot and bytes."""
    sc = _port_sidecar(engines[1], max_batch_delay_ms=5000.0)
    futs = _record_submits(sc, monkeypatch)
    gov = sc.governor
    try:
        with lanes_held(sc.batcher, sc.tenants.engine_for(None)):
            client = tx.ExtProcClient("127.0.0.1", sc.config.extproc_port)
            _open_streams(client, [("GET", f"/?n={i}", HOST, b"") for i in range(5)])
            assert _wait(lambda: sc.stats()["extproc"]["awaiting"] == 5, 10)
            assert gov.connections == 5
            client.sock.close()
            assert _wait(lambda: gov.connections == 0 and gov.inflight_bytes == 0, 10)
            assert sc.stats()["extproc"]["awaiting"] == 0
            assert len(futs) == 5 and all(f.cancelled() for f in futs)
    finally:
        sc.stop()


def test_missed_client_deadline_answered_by_the_host_fallback(engines):
    """A parked stream whose ``X-CKO-Deadline-Ms`` passes before the device
    answers (the batcher's lane is held busy, so its window stays open,
    for up to its 3 s delay) is answered by the host fallback, with the
    device's verdict."""
    sc = _port_sidecar(engines[1], max_batch_delay_ms=3000.0)
    try:
        before = sc.degraded.fallback_requests
        with lanes_held(sc.batcher, sc.tenants.engine_for(None)):
            client = tx.ExtProcClient("127.0.0.1", sc.config.extproc_port)
            try:
                t0 = time.monotonic()
                got = client.filter("GET", "/?pet=evilpanda", HOST + [("X-CKO-Deadline-Ms", "150")], b"")
                waited = time.monotonic() - t0
            finally:
                client.close()
        assert (got["status"], got["headers"]["x-waf-action"], got["headers"]["x-waf-rule-id"]) == (
            403, "deny", "2003")
        assert got["body"] == b"blocked by WAF\n"
        assert sc.degraded.fallback_requests == before + 1
        assert waited < 2.5
    finally:
        sc.stop()
