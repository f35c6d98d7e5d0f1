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
flags (``--extproc-port``) start a sidecar whose listener answers.
"""

from __future__ import annotations

import dataclasses
import socket
import time

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
from coraza_kubernetes_operator_tpu_torch.ops import kernels
from coraza_kubernetes_operator_tpu_torch.sidecar import SidecarConfig as TConfig
from coraza_kubernetes_operator_tpu_torch.sidecar import TpuEngineSidecar as TSidecar
from coraza_kubernetes_operator_tpu_torch.sidecar import extproc as tx
from test_torch_sidecar import FIELDS, FILTER_REQUESTS, RULES, _send

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
    assert set(stats) == set(sidecars.j.stats()["extproc"])

    def names(sc):
        body = urllib.request.urlopen(f"http://127.0.0.1:{sc.port}/waf/v1/metrics", timeout=30).read()
        return {ln.split()[2] for ln in body.decode().splitlines()
                if ln.startswith("# TYPE cko_extproc_")}

    assert names(sidecars.t) == names(sidecars.j)
    assert len(names(sidecars.t)) == 6


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
