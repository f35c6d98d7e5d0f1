"""PyTorch port parity: the serving sidecar, over real sockets, against the
JAX package's sidecar.

Each pair is one JAX sidecar and one port sidecar (``device="cpu"``), each
polling its own package's rule-cache server with the same ruleset text.
The same request bytes go to both, and every answer must be byte-equal in
(status, ``x-waf-action``, ``x-waf-rule-id``, body):

- filter mode and the bulk ``/waf/v1/evaluate``, on the threaded and the
  async frontend;
- hot reload (a new ruleset in both caches flips a verdict on both);
- the verdict cache (a repeat hits; an engine swap empties it);
- the quarantine poison marker (real verdict, then isolated);
- an injected device loss (host fallback answers, then ``promoted``);
- readyz/healthz, and the metric family names (``cko_build_info``'s
  labels differ by design); the port's ``cko_compile_cache_*`` gauges and
  its stats' ``trace_s`` read its stage graphs (``EXEC_CACHE``);
- state carried across: a ``StateStore`` snapshot the JAX sidecar wrote
  restores the port's sidecar with the same uuid, ring and latches, and
  equal verdicts, before any cache poll.
"""

from __future__ import annotations

import http.client
import json
import time

import pytest

from coraza_kubernetes_operator_tpu.cache import RuleSetCache as JCache
from coraza_kubernetes_operator_tpu.cache import RuleSetCacheServer as JCacheServer
from coraza_kubernetes_operator_tpu.engine import HttpRequest as JRequest
from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
from coraza_kubernetes_operator_tpu.sidecar import SidecarConfig as JConfig
from coraza_kubernetes_operator_tpu.sidecar import TpuEngineSidecar as JSidecar
from coraza_kubernetes_operator_tpu_torch.cache import RuleSetCache as TCache
from coraza_kubernetes_operator_tpu_torch.cache import RuleSetCacheServer as TCacheServer
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest as TRequest
from coraza_kubernetes_operator_tpu_torch.sidecar import SidecarConfig as TConfig
from coraza_kubernetes_operator_tpu_torch.sidecar import TpuEngineSidecar as TSidecar
from coraza_kubernetes_operator_tpu_torch.sidecar.degraded import is_device_loss
from torch_rules import REQUESTS, SMALL_RULES

KEY = "default/waf"
# SMALL_RULES plus one rule per automata tier: dfa-hot, prefiltered (the
# approximate automaton's positives are confirmed on the host) and segment.
THREE_TIER = r'''
SecRule ARGS "@rx (e|fg)+h" "id:2001,phase:2,deny,status:403,t:none"
SecRule ARGS "@rx (a|bc)*a(a|bc){7}d" "id:2002,phase:2,deny,status:403,t:none"
SecRule ARGS "@contains evilpanda" "id:2003,phase:2,deny,status:403,t:none"
'''
RULES = SMALL_RULES + THREE_TIER
EXTRA_RULE = 'SecRule ARGS "@contains eviltiger" "id:2004,phase:2,deny,status:403,t:none"\n'
FILTER_REQUESTS = REQUESTS + [
    ("GET", "/?q=fgfgeh", [], b""),  # dfa-hot hit
    ("GET", "/?q=aaaaaaaad", [], b""),  # prefilter hit, confirmed
    ("GET", "/?q=bcbcbcbcd", [], b""),  # approximate-only bait: cleared
    ("GET", "/?pet=evilpanda", [], b""),  # segment hit
]
FIELDS = ("x-waf-action", "x-waf-rule-id")


def _wait(predicate, timeout_s=60.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return False


def _send(port, method, path, headers=(), body=b""):
    """One request on its own connection; (status, action, rule id, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body or None, headers=dict(headers))
        resp = conn.getresponse()
        data = resp.read()
        return (resp.status,) + tuple(resp.getheader(h) for h in FIELDS) + (data,)
    finally:
        conn.close()


class Pair:
    """A JAX sidecar and a port sidecar, each on its own cache server."""

    def __init__(self, rules=RULES, frontend="async", start=True, **kw):
        self.jcache, self.tcache = JCache(), TCache()
        self.jsrv = JCacheServer(self.jcache, host="127.0.0.1", port=0)
        self.tsrv = TCacheServer(self.tcache, host="127.0.0.1", port=0)
        self.jsrv.start()
        self.tsrv.start()
        if rules is not None:
            self.put(rules)
        common = dict(instance_key=KEY, poll_interval_s=0.05, host="127.0.0.1", port=0,
                      frontend=frontend, max_batch_size=64, max_batch_delay_ms=1.0, **kw)
        self.j = JSidecar(JConfig(cache_base_url=f"http://127.0.0.1:{self.jsrv.port}", **common))
        self.t = TSidecar(TConfig(cache_base_url=f"http://127.0.0.1:{self.tsrv.port}",
                                  device="cpu", **common))
        self.started = False
        if start:
            self.start()

    def put(self, rules):
        self.jcache.put(KEY, rules)
        self.tcache.put(KEY, rules)

    def start(self):
        self.j.start()
        self.t.start()
        self.started = True
        assert _wait(lambda: self.both("promoted"), 120), self.modes()

    def modes(self):
        return self.j.serving_mode(), self.t.serving_mode()

    def both(self, mode):
        return self.modes() == (mode, mode)

    def send(self, method, path, headers=(), body=b""):
        """The same bytes to both; asserts equal answers and returns one."""
        got_j = _send(self.j.port, method, path, headers, body)
        got_t = _send(self.t.port, method, path, headers, body)
        assert got_t == got_j, (method, path, got_t, got_j)
        return got_t

    def stop(self):
        if self.started:
            self.t.stop()
            self.j.stop()
        self.tsrv.stop()
        self.jsrv.stop()


@pytest.fixture(scope="module", params=["async", "threaded"])
def pair(request):
    p = Pair(frontend=request.param)
    yield p
    p.stop()


def test_filter_mode_equal(pair):
    answers = [pair.send(*r) for r in FILTER_REQUESTS]
    blocked = {a[2] for a in answers if a[0] != 200}
    assert {"1003", "1006", "2001", "2002", "2003"} <= blocked, answers
    assert answers[-2][0] == 200  # the prefilter bait was cleared on the host


def test_bulk_evaluate_equal(pair):
    reqs = [{"method": m, "uri": u, "headers": h, "body": b.decode()}
            for m, u, h, b in FILTER_REQUESTS]
    body = json.dumps({"requests": reqs}).encode()
    status, _a, _r, data = pair.send("POST", "/waf/v1/evaluate",
                                     [("Content-Type", "application/json")], body)
    assert status == 200
    verdicts = json.loads(data)["verdicts"]
    assert len(verdicts) == len(reqs) and any(v["interrupted"] for v in verdicts)


def test_health_and_readiness_equal(pair):
    for path in ("/waf/v1/healthz", "/waf/v1/readyz"):
        assert pair.send("GET", path)[0] == 200


def test_metric_family_names_equal(pair):
    def families(port):
        data = _send(port, "GET", "/waf/v1/metrics")[3].decode()
        return {ln.split()[2] for ln in data.splitlines() if ln.startswith("# TYPE ")}, data

    (jf, _jd), (tf, td) = families(pair.j.port), families(pair.t.port)
    assert tf == jf
    info = [ln for ln in td.splitlines() if ln.startswith("cko_build_info{")]
    assert len(info) == 1 and 'platform="cpu"' in info[0] and "torch=" in info[0]
    assert "cuda=" in info[0]


def test_compile_cache_gauges_report_the_stage_graphs(pair):
    """``cko_compile_cache_*`` and ``/waf/v1/stats`` read ``EXEC_CACHE``:
    hits (replays), misses, resident graphs and bypasses on the metrics
    page, the capture passes' seconds (trace_s) in the stats, as the
    reference reports them."""
    import gc

    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    gc.collect()  # earlier tests' dead engines would drop their graphs mid-read
    for i in range(4):  # distinct values: each rides a device window
        pair.send("GET", f"/?q=gauge-probe-{i}")
    data = _send(pair.t.port, "GET", "/waf/v1/metrics")[3].decode()
    got = {ln.split()[0]: float(ln.split()[1]) for ln in data.splitlines()
           if ln.startswith("cko_compile") and "{" not in ln}
    stats = EXEC_CACHE.stats()
    assert stats["misses"] > 0
    assert got["cko_compile_cache_hits_total"] == stats["hits"]
    assert got["cko_compile_cache_misses_total"] == stats["misses"]
    assert got["cko_compile_cache_bypass_total"] == stats["bypasses"]
    assert got["cko_compile_cache_entries"] == stats["entries"] == len(EXEC_CACHE)
    assert got["cko_compile_inflight"] == stats["inflight"] == 0
    block = json.loads(_send(pair.t.port, "GET", "/waf/v1/stats")[3])["compile_cache"]
    assert {k: block[k] for k in ("trace_s", "bypasses", "captures")} == {
        k: stats[k] for k in ("trace_s", "bypasses", "captures")}


def test_verdict_cache_hits_on_repeat_and_empties_on_swap(pair):
    path = "/?q=verdict-cache-probe"
    before = (pair.j.verdict_cache.hits_total, pair.t.verdict_cache.hits_total)
    pair.send("GET", path)
    pair.send("GET", path)
    assert pair.t.verdict_cache.hits_total > before[1]
    assert pair.j.verdict_cache.hits_total > before[0]
    assert len(pair.t.verdict_cache) > 0
    pair.t._on_engine_swap(pair.t.tenants.engine_for(None))
    pair.j._on_engine_swap(pair.j.tenants.engine_for(None))
    assert len(pair.t.verdict_cache) == len(pair.j.verdict_cache) == 0
    pair.send("GET", path)


def test_hot_reload_flips_verdict():
    p = Pair(shadow_promote_windows=1, shadow_idle_check_s=0.05)
    try:
        path = "/?pet=eviltiger"
        assert p.send("GET", path)[0] == 200
        uuids = (p.j.tenants._reloaders[KEY].current_uuid, p.t.tenants._reloaders[KEY].current_uuid)
        p.put(RULES + EXTRA_RULE)

        def swapped():
            p.send("GET", "/?q=shadow-window")  # traffic the shadow verifies
            return (p.j.tenants._reloaders[KEY].current_uuid != uuids[0]
                    and p.t.tenants._reloaders[KEY].current_uuid != uuids[1])

        assert _wait(swapped, 120, 0.1)
        assert _wait(lambda: p.both("promoted"), 120)
        assert p.send("GET", path)[:3] == (403, "deny", "2004")
        assert p.send("GET", "/?a=ababc")[0] == 403  # the old rules still serve
    finally:
        p.stop()


def test_poison_marker_isolated_with_real_verdict(monkeypatch):
    p = Pair()
    try:
        monkeypatch.setenv("CKO_FAULT_POISON_MARKER", "POISON-X")
        form = [("Content-Type", "application/x-www-form-urlencoded")]
        got = p.send("POST", "/?a=ababc", form, b"x=POISON-X")
        assert got[:3] == (403, "deny", "1003")
        for sc in (p.j, p.t):
            assert _wait(lambda sc=sc: sc.stats()["quarantine"]["isolated_total"] >= 1, 60)
        assert p.send("POST", "/?a=ababc", form, b"x=POISON-X")[:3] == (403, "deny", "1003")
        assert p.t.stats()["quarantine"]["hits_total"] >= 1
        monkeypatch.delenv("CKO_FAULT_POISON_MARKER")
        assert p.send("GET", "/?q=hello")[0] == 200
        assert p.both("promoted")
    finally:
        monkeypatch.delenv("CKO_FAULT_POISON_MARKER", raising=False)
        p.stop()


def test_device_loss_falls_back_then_promotes(monkeypatch):
    p = Pair()
    try:
        monkeypatch.setenv("CKO_FAULT_DEVICE_LOST_N", "1")
        got = p.send("GET", "/?a=ababc")
        assert got[:3] == (403, "deny", "1003")
        for sc in (p.j, p.t):
            assert _wait(lambda sc=sc: sc.degraded.device_loss.stats()["losses_total"] >= 1, 60)
            assert _wait(lambda sc=sc: sc.degraded.device_loss.stats()["recoveries"] >= 1, 60)
        assert _wait(lambda: p.both("promoted"), 120), p.modes()
        for r in FILTER_REQUESTS[:4]:
            p.send(*r)
    finally:
        monkeypatch.delenv("CKO_FAULT_DEVICE_LOST_N", raising=False)
        p.stop()


@pytest.mark.parametrize("text", [
    "RuntimeError: CUDA error: an illegal memory access was encountered",
    "cko_scan_flat: CUDA error 719 (unspecified launch failure)",
    "torch.AcceleratorError: CUDA error: device-side assert triggered",
    "RuntimeError: CUDA error: CUDA-capable device(s) is/are busy or unavailable",
])
def test_cuda_loss_class_errors_are_device_loss(text):
    assert is_device_loss(RuntimeError(text))
    assert not is_device_loss(RuntimeError("CUDA error: out of memory"))


def test_jax_state_snapshot_restores_port_sidecar(tmp_path):
    state_dir = str(tmp_path / "state")
    p = Pair(rules=None, start=False, state_dir=state_dir)
    try:
        jr = p.j.tenants._reloaders[KEY]
        jr.seed(JEngine(RULES), uuid="uuid-1", rules=RULES)
        jr._remember_text("uuid-2", RULES + EXTRA_RULE)
        jr._swap("uuid-2", JEngine(RULES + EXTRA_RULE), None)  # persists the snapshot
        jr._rollout_latched["uuid-latched"] = time.monotonic()
        jr._rejected_uuid = "uuid-rejected"
        p.j._persist_state()
        assert p.j.state_store.stats()["saves"] >= 2

        p.t._restore_state()
        tr = p.t.tenants._reloaders[KEY]
        assert tr.restored and p.t.tenants.total_restored == 1
        assert tr.current_uuid == jr.current_uuid == "uuid-2"
        assert tr.ring.uuids() == jr.ring.uuids() == ["uuid-1"]
        assert p.t.tenants.snapshot() == p.j.tenants.snapshot()
        assert tr.snapshot()["latched"] == ["uuid-latched"]
        assert tr.snapshot()["rejected_uuid"] == "uuid-rejected"

        def keys(vs):
            return [(v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores) for v in vs]

        want = keys(jr.engine.evaluate([JRequest(method=m, uri=u, headers=h, body=b)
                                        for m, u, h, b in FILTER_REQUESTS]))
        got = keys(tr.engine.evaluate([TRequest(method=m, uri=u, headers=h, body=b)
                                       for m, u, h, b in FILTER_REQUESTS]))
        assert got == want
        assert any(v[2] == 2003 for v in got)
    finally:
        p.stop()


def test_profile_endpoint_writes_a_chrome_trace(tmp_path):
    """The port's profile endpoint drives ``torch.profiler``: start, traffic,
    stop writes a Chrome trace into the chosen directory, holding the ops
    the batcher's thread ran (CPU activity here; on the card CUDA activity
    too). Without the token it refuses."""
    cache = TCache()
    srv = TCacheServer(cache, host="127.0.0.1", port=0)
    srv.start()
    cache.put(KEY, RULES)
    sc = TSidecar(TConfig(cache_base_url=f"http://127.0.0.1:{srv.port}", instance_key=KEY,
                          host="127.0.0.1", port=0, device="cpu", metrics_auth_token="tok"))
    sc.start()
    try:
        assert _wait(lambda: sc.serving_mode() == "promoted", 120)
        auth = [("Authorization", "Bearer tok"), ("Content-Type", "application/json")]
        start = json.dumps({"action": "start", "dir": str(tmp_path)}).encode()
        assert _send(sc.port, "POST", "/waf/v1/profile", [], start)[0] == 401
        assert _send(sc.port, "POST", "/waf/v1/profile", auth, start)[0] == 200
        assert _send(sc.port, "POST", "/waf/v1/profile", auth, start)[0] == 409
        assert _send(sc.port, "GET", "/?a=ababc")[0] == 403
        status, *_h, body = _send(sc.port, "POST", "/waf/v1/profile", auth,
                                  json.dumps({"action": "stop"}).encode())
        assert status == 200
        reply = json.loads(body)
        assert reply["profiling"] is False and reply["dir"] == str(tmp_path)
        events = json.loads(open(reply["trace"]).read())["traceEvents"]
        assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    finally:
        sc.stop()
        srv.stop()
