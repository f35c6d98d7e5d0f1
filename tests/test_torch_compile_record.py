"""The port's compile log and the window log's segment column counter, on
the CPU.

- a ``WafEngine``'s compile record: its stages present, in order, tiling
  the compile's wall time, and committed to ``COMPILES``;
- its counters against a hand count on a small ruleset whose path gates
  form a narrow segment block;
- a window's matcher rows and segment column work (``_seg_work``) against
  a hand count, carried by the batcher to the window log;
- the two readers of ``portbench/metrics/`` that read them, on synthetic
  logs;
- ``GET /waf/v1/stats`` and the metrics page of a sidecar serving the
  ruleset show both.
"""

from __future__ import annotations

import dataclasses
import http.client
import importlib
import json
import time
from types import SimpleNamespace

import pytest
import torch

from coraza_kubernetes_operator_tpu_torch.cache import RuleSetCache, RuleSetCacheServer
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest, WafEngine
from coraza_kubernetes_operator_tpu_torch.observability import tracing
from coraza_kubernetes_operator_tpu_torch.observability.tracing import (
    COMPILE_STAGES,
    CompileLog,
    WindowLog,
)
from coraza_kubernetes_operator_tpu_torch.sidecar import SidecarConfig, TpuEngineSidecar
from coraza_kubernetes_operator_tpu_torch.sidecar.batcher import MicroBatcher

# Eight path gates (one column each) and two literals read by four other
# kinds: split off, the gates leave 4 rows a request (one per other kind)
# 8 columns lighter, 32 in all, against the 10 columns a row of the
# partition kept apart scans: t:none's groups split into a block of 2
# columns and a narrow block of 8.
ARGS_KINDS = "ARGS|ARGS_POST|REQUEST_COOKIES|REQUEST_COOKIES_NAMES"
RULES = "SecRuleEngine On\n" + "".join(
    f'SecRule REQUEST_FILENAME "@streq /p{i}.php" "id:{100 + i},phase:2,deny,status:403,t:none"\n'
    for i in range(8)) + (
    f'SecRule {ARGS_KINDS} "@contains evilpanda" "id:200,phase:2,deny,status:403,t:none"\n'
    f'SecRule {ARGS_KINDS} "@contains eviltiger" "id:201,phase:2,deny,status:403,t:none"\n')
WINDOW = [HttpRequest(uri="/p3.php?q=evilpanda"), HttpRequest(uri="/other?q=hello"),
          HttpRequest(uri="/p3.php?q=hello")]


@pytest.fixture(scope="module")
def engine():
    return WafEngine(RULES, device="cpu")


def test_compile_record_stages_present_ordered_and_tile_the_compile(engine):
    rec = engine.compile_record
    assert rec in tracing.COMPILES.records()
    assert tuple(name for name, _s in rec.spans) == COMPILE_STAGES
    assert all(s >= 0 for _n, s in rec.spans)
    wall = rec.t1 - rec.t0
    assert 0.9 * wall <= rec.total_s <= wall + 1e-9
    assert dict(rec.spans)["upload"] < 0.05  # nothing to carry on the CPU
    # A precompiled ruleset records no parse, lowering or automata.
    again = WafEngine(engine.compiled, device="cpu").compile_record
    assert [s for _n, s in again.spans[:3]] == [0.0, 0.0, 0.0]
    assert again.id > rec.id


def _tensor_bytes(obj) -> int:
    total = 0
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        for x in v if isinstance(v, (list, tuple)) else [v]:
            if isinstance(x, torch.Tensor) and f.init:
                total += x.numel() * x.element_size()
            elif dataclasses.is_dataclass(x) and f.init:
                total += _tensor_bytes(x)
    return total


def test_compile_counters_equal_a_hand_count(engine):
    c = engine.compile_record.counters
    assert c["groups"] == 10
    assert c["groups_per_tier"] == {"segment": 10, "dfa": 0, "dfa-hot": 0, "prefiltered": 0}
    assert c["segment_blocks"] == [
        {"pipeline": 0, "columns": 2, "groups": 2, "narrow": False},
        {"pipeline": 0, "columns": 8, "groups": 8, "narrow": True},
    ]
    assert c["device_table_bytes"] == _tensor_bytes(engine.model) > 0
    assert engine.model.narrow_blocks == (1,)
    assert engine.evaluate(WINDOW)[0].rule_id in (103, 200)
    assert [v.interrupted for v in engine.evaluate(WINDOW)] == [True, False, True]


@dataclasses.dataclass
class _Inner:
    t: torch.Tensor


@dataclasses.dataclass
class _Outer:
    inner: _Inner
    by_name: dict
    pair: tuple
    n: int = 3


def test_build_model_moves_every_tensor_in_one_pass(engine):
    from coraza_kubernetes_operator_tpu_torch.models.waf_model import (
        _tensors,
        _to_device,
        build_model,
    )

    timings = {}
    model = build_model(engine.compiled, automata=engine.automata_plan,
                        device=torch.device("meta"), timings=timings)
    assert timings["upload"] >= 0
    assert {t.device.type for t in _tensors(model)} == {"meta"}
    assert model.numvar_col.device.type == "meta" and model.long_col.device.type == "meta"
    assert model.narrow_blocks == engine.model.narrow_blocks == (1,)
    # The walk reaches a lone dataclass, a dict and a tuple of mixed items.
    moved = _to_device(_Outer(_Inner(torch.ones(2)), {"a": torch.zeros(1)},
                              (torch.ones(1), "x")), torch.device("meta"))
    assert {t.device.type for t in _tensors(moved)} == {"meta"}
    assert len(list(_tensors(moved))) == 3 and moved.pair[1] == "x" and moved.n == 3


def test_window_column_work_equals_a_hand_count():
    # A fresh engine: the value cache of another would serve some rows.
    eng = WafEngine(RULES, device="cpu")
    inflight = eng.prepare(WINDOW)
    eng.collect(inflight)
    # Path rows "/p3.php", "/other" meet 2 + 8 columns; ARGS rows
    # "evilpanda", "hello" meet 2.
    assert (inflight.seg_rows, inflight.seg_col_rows) == (4, 2 * 10 + 2 * 2)
    batcher = MicroBatcher(lambda: WafEngine(RULES, device="cpu"), max_batch_delay_ms=20)
    batcher.start()
    try:
        t0 = time.monotonic()
        futs = [batcher.submit(r) for r in WINDOW]
        assert [f.result(timeout=60).interrupted for f in futs] == [True, False, True]
        deadline = time.monotonic() + 10
        while not tracing.WINDOWS.records(t0) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        batcher.stop()
    (rec,) = [r for r in tracing.WINDOWS.records(t0) if r.n_requests == 3]
    assert (rec.seg_rows, rec.seg_col_rows, rec.seg_cols_per_row) == (4, 24, 6.0)


def test_seg_cols_per_row_reader(monkeypatch):
    read = importlib.import_module("portbench.metrics.seg_cols_per_row").read
    run = SimpleNamespace(c0={"t": 10.0}, c1={"t": 11.0})
    log = WindowLog()
    monkeypatch.setattr(tracing, "WINDOWS", log)
    assert read(run) is None
    for t, rows, col_rows in ((10.0, 4, 24), (10.5, 10, 100), (10.7, 0, 0), (11.0, 1, 999)):
        rec = log.open(t)
        rec.seg_rows, rec.seg_col_rows = rows, col_rows
        log.commit(rec)
    assert read(run) == pytest.approx((6.0 + 10.0) / 2)
    assert log.seg_cols_per_row() == (pytest.approx((6.0 + 10.0 + 999.0) / 3), 3)


def test_ruleset_compile_s_reader(monkeypatch):
    read = importlib.import_module("portbench.metrics.ruleset_compile_s").read
    run = SimpleNamespace(c0={"t": 100.0}, c1={"t": 130.0})
    log = CompileLog()
    monkeypatch.setattr(tracing, "COMPILES", log)
    assert read(run) is None
    for t0, t1, secs in ((1.0, 20.0, 18.0), (30.0, 60.0, 29.0), (120.0, 125.0, 5.0)):
        rec = log.open(t0)
        rec.spans = [(name, secs / len(COMPILE_STAGES)) for name in COMPILE_STAGES]
        rec.t1 = t1
        log.commit(rec)
    assert read(run) == pytest.approx(29.0)  # the newest that ended before c0


def _get(port: int, path: str) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return conn.getresponse().read()
    finally:
        conn.close()


def test_stats_and_metrics_show_the_compile_and_the_column_work():
    cache = RuleSetCache()
    cache.put("default/waf", RULES)
    srv = RuleSetCacheServer(cache, host="127.0.0.1", port=0)
    srv.start()
    sc = TpuEngineSidecar(SidecarConfig(
        cache_base_url=f"http://127.0.0.1:{srv.port}", instance_key="default/waf",
        poll_interval_s=0.05, host="127.0.0.1", port=0, device="cpu",
        max_batch_size=64, max_batch_delay_ms=1.0))
    sc.start()
    try:
        deadline = time.monotonic() + 120
        while sc.serving_mode() != "promoted" and time.monotonic() < deadline:
            time.sleep(0.02)
        for r in WINDOW:
            _get(sc.port, r.uri)
        stats = json.loads(_get(sc.port, "/waf/v1/stats"))
        comp = stats["compile"]
        assert list(comp["spans_s"]) == list(COMPILE_STAGES)
        assert comp["total_s"] == pytest.approx(sum(comp["spans_s"].values()))
        assert [b["columns"] for b in comp["segment_blocks"]] == [2, 8]
        assert comp["groups_per_tier"]["segment"] == 10 and comp["device_table_bytes"] > 0
        seg = stats["segment_columns"]
        assert seg["windows"] >= 1 and seg["cols_per_row"] > 0
        page = _get(sc.port, "/waf/v1/metrics").decode()
        for line in ('cko_ruleset_compile_s{stage="parse"}', 'cko_ruleset_groups{tier="segment"} 10',
                     'cko_segment_block_columns{block="1",narrow="true"} 8', "cko_device_table_bytes ",
                     "cko_seg_cols_per_row "):
            assert line in page, line
    finally:
        sc.stop()
        srv.stop()
