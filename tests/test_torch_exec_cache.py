"""PyTorch port: the stage graphs behind ``EXEC_CACHE.call`` on the CPU.

On the CPU there is no CUDA graph: an entry's capture runs the stage over
its static input buffers and a replay copies the call's inputs in, runs
the stage again over them and clones the outputs out. So everything but
the capture itself runs here:

- three windows of one signature (eager, capture, replay) give the bits
  of direct calls of ``match_tier_packed`` and ``eval_post_tiered``, and
  the engine's verdicts equal the JAX package's on numpy-seeded requests;
- two windows of one signature in flight: the first one's outputs stay
  as they were while the second replays;
- another mask, ``CKO_PALLAS_FINALS`` or ``cached`` layout is another
  key; another model of the same layout keeps entries of its own;
- ``reinit_device`` and dropping an engine release the old model's
  graphs;
- a stage that waits for the device from the host is a bypass, counted
  per call, logged once per key, with the right bits; hits count only
  after a replay that returned;
- a warmed stage sends nothing from the host to the device;
- a replay books the kernel launches its capture recorded, so a window
  counts the same launches eagerly and replayed.
"""

from __future__ import annotations

import gc
import logging
import threading
import weakref

import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu.engine import HttpRequest as JRequest
from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest as TRequest
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine
from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE, ExecutableCache
from coraza_kubernetes_operator_tpu_torch.models.waf_model import eval_post_tiered, match_tier_packed
from coraza_kubernetes_operator_tpu_torch.ops import dfa, kernels, segment_finals
from torch_rules import SMALL_RULES

_ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
_ATTACKS = ["ababc", "%3Cscript%3Ealert(1)", "1%27%20UNION%20ALL%20SELECT%20x", "xyxy"]


def _window(seed: int, n: int = 16) -> list[tuple]:
    """``n`` GET requests of one shape: a 20-byte random value each, with
    an attack token in place of its second half for about 40% of them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        v = bytes(_ALPHABET[rng.integers(0, _ALPHABET.size, 20)]).decode()
        if rng.random() < 0.4:
            v = v[:10] + _ATTACKS[rng.integers(len(_ATTACKS))]
        out.append(("GET", f"/path/to/resource?q={v}", [], b""))
    return out


def _reqs(cls, window):
    return [cls(method=m, uri=u, headers=h, body=b) for m, u, h, b in window]


def _vt(v):
    return (v.interrupted, v.status, v.rule_id, tuple(v.matched_ids), tuple(sorted(v.scores.items())))


@pytest.fixture(scope="module")
def jeng():
    return JEngine(SMALL_RULES)


def _stage_args(eng, window):
    """Per tier (match args, mask), the post stage's pairs and numvals."""
    tiers, numvals, masks, _cached, _mk, lease = eng._batch_tensors(_reqs(TRequest, window))
    try:  # copies: the native path's arrays live in a staging arena
        match = [((eng.model, *(torch.as_tensor(np.array(t[i])) for i in (0, 1, 6, 7))), m)
                 for t, m in zip(tiers, masks)]
        pairs = tuple(tuple(torch.as_tensor(np.array(t[i])) for i in (2, 3, 4, 5, 8)) for t in tiers)
        return match, pairs, torch.as_tensor(np.array(numvals))
    finally:
        if lease is not None:
            lease.release()


@pytest.mark.parametrize("finals", ["0", "1"], ids=["finals-off", "finals-on"])
def test_three_windows_replay_the_bits_of_direct_calls(monkeypatch, jeng, finals):
    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")  # one signature for the three windows
    monkeypatch.setenv("CKO_PALLAS_FINALS", finals)
    eng = TEngine(SMALL_RULES, device="cpu")
    windows = [_window(seed) for seed in (1, 2, 3)]
    sig = eng.batch_signature(_reqs(TRequest, windows[0]))
    assert all(eng.batch_signature(_reqs(TRequest, w)) == sig for w in windows)
    n = len(sig)
    h0, m0, _ = EXEC_CACHE.snapshot()
    for w in windows:  # eager, captured, replayed
        match, pairs, numvals = _stage_args(eng, w)
        hits = []
        for args, mask in match:
            want = match_tier_packed(*args, mask=mask)
            got = EXEC_CACHE.call(match_tier_packed, args, {"mask": mask}, {})
            assert got.dtype == want.dtype and torch.equal(got, want)
            hits.append(want)
        post_args = (eng.model, tuple(hits), pairs, numvals)
        want = eval_post_tiered(*post_args, max_phase=2, cached=None)
        got = EXEC_CACHE.call(eval_post_tiered, post_args, {"max_phase": 2}, {"cached": None})
        assert torch.equal(got, want)
    assert EXEC_CACHE.snapshot()[:2] == (h0 + n, m0 + 2 * n)
    assert EXEC_CACHE.resident(eng.model, sig)
    # The engine over the same entries: its verdicts are the JAX package's.
    for seed in (1, 2, 3, 4):
        w = _window(seed)
        assert [_vt(v) for v in eng.evaluate(_reqs(TRequest, w))] == [
            _vt(v) for v in jeng.evaluate(_reqs(JRequest, w))]
    assert EXEC_CACHE.snapshot()[0] >= h0 + 5 * n


def test_two_windows_in_flight_keep_their_outputs(jeng):
    eng = TEngine(SMALL_RULES, device="cpu")  # the value cache on: windows carry hit rows
    windows = [_window(seed) for seed in range(10, 16)]
    for w in windows[:3]:  # a cold-cache signature, then the warm one's eager run and capture
        eng.evaluate(_reqs(TRequest, w))
    sig = eng.batch_signature(_reqs(TRequest, windows[3]))
    assert EXEC_CACHE.resident(eng.model, sig) and sig == eng.batch_signature(_reqs(TRequest, windows[4]))
    h0 = EXEC_CACHE.snapshot()[0]
    first = eng.prepare(_reqs(TRequest, windows[3]))
    packed, tier_hits = first.out
    kept = packed.clone(), [h.clone() for h in tier_hits]
    second = eng.prepare(_reqs(TRequest, windows[4]))
    assert EXEC_CACHE.snapshot()[0] == h0 + 2 * len(sig)  # both replayed one set of graphs
    assert torch.equal(packed, kept[0]) and all(torch.equal(a, b) for a, b in zip(tier_hits, kept[1]))
    assert not torch.equal(second.out[0], packed)
    for inflight, w in ((first, windows[3]), (second, windows[4])):
        assert [_vt(v) for v in eng.collect(inflight)] == [
            _vt(v) for v in jeng.evaluate(_reqs(JRequest, w))]


def test_keys_split_by_mask_finals_cached_layout_and_model(monkeypatch):
    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")
    monkeypatch.setenv("CKO_PALLAS_FINALS", "0")
    eng_a, eng_b = TEngine(SMALL_RULES, device="cpu"), TEngine(SMALL_RULES, device="cpu")
    match, pairs, numvals = _stage_args(eng_a, _window(5))
    args, mask = match[0]
    other = 1 if mask != 1 else 3
    key = EXEC_CACHE.key_for(match_tier_packed, args, {"mask": mask}, {})
    assert key != EXEC_CACHE.key_for(match_tier_packed, args, {"mask": other}, {})
    monkeypatch.setenv("CKO_PALLAS_FINALS", "1")
    assert key != EXEC_CACHE.key_for(match_tier_packed, args, {"mask": mask}, {})
    monkeypatch.setenv("CKO_PALLAS_FINALS", "0")
    hits = tuple(match_tier_packed(*a, mask=m) for a, m in match)
    post = (eng_a.model, hits, pairs, numvals)
    cached = tuple(torch.zeros((1, h.shape[1]), dtype=torch.uint8) for h in hits)
    post_keys = [EXEC_CACHE.key_for(eval_post_tiered, post, {"max_phase": 2}, {"cached": c})
                 for c in (None, cached, (None,) + cached[1:])]
    assert len(set(post_keys)) == 3
    # Two masks are two graphs on the model; the other model of this layout
    # has the same key and none of them.
    for m in (mask, mask, other, other):
        out = EXEC_CACHE.call(match_tier_packed, args, {"mask": m}, {})
        assert torch.equal(out, match_tier_packed(*args, mask=m))
    assert EXEC_CACHE.resident(eng_a.model, [key, EXEC_CACHE.key_for(
        match_tier_packed, args, {"mask": other}, {})])
    args_b = (eng_b.model,) + args[1:]
    assert EXEC_CACHE.key_for(match_tier_packed, args_b, {"mask": mask}, {}) == key
    assert not EXEC_CACHE.resident(eng_b.model, [key])
    m0 = EXEC_CACHE.snapshot()[1]
    EXEC_CACHE.call(match_tier_packed, args_b, {"mask": mask}, {})
    assert EXEC_CACHE.snapshot()[1] == m0 + 1  # its own first sight


def test_reinit_and_dropping_an_engine_release_the_graphs(monkeypatch):
    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")
    reqs = _reqs(TRequest, _window(7))
    eng = TEngine(SMALL_RULES, device="cpu")
    want = [_vt(v) for v in eng.evaluate(reqs)]
    eng.evaluate(reqs)  # captures
    sig = eng.batch_signature(reqs)
    gc.collect()  # earlier tests' dead engines go first: only this one's graphs may go below
    before = len(EXEC_CACHE)
    old = weakref.ref(eng.model)
    table = eng.model.__dict__["_cko_graphs"]
    eng.reinit_device()
    gc.collect()
    assert old() is None and not table.entries and len(EXEC_CACHE) == before - len(sig)
    assert [_vt(v) for v in eng.evaluate(reqs)] == want  # a first sight on the new model

    eng.evaluate(reqs)  # captures on the new model
    assert len(EXEC_CACHE) == before
    swapped = weakref.ref(eng.model)
    eng = TEngine(SMALL_RULES, device="cpu")  # the swap: nothing holds the old engine
    gc.collect()
    assert swapped() is None and len(EXEC_CACHE) == before - len(sig)


class _Owner:
    """Stands in for a model: the entries live on the first argument."""


def test_a_stage_that_waits_on_the_host_is_a_bypass_logged_once(caplog):
    cache, owner = ExecutableCache(), _Owner()

    def syncing(owner, x):
        kernels.note_host_sync("reads a row count back")
        return x + 1

    x = torch.arange(6)
    with caplog.at_level(logging.ERROR, logger="cko"):
        outs = [cache.call(syncing, (owner, x + i), {}, {}) for i in range(4)]
    assert all(torch.equal(o, x + i + 1) for i, o in enumerate(outs))
    stats = cache.stats()
    # First sight eager; the second finds the sync and serves from its run;
    # the third and fourth run eagerly.
    assert (stats["misses"], stats["hits"], stats["captures"], stats["bypasses"]) == (1, 0, 0, 3)
    assert [r for r in caplog.records if "bypassed" in r.getMessage()].__len__() == 1
    assert [reason for _k, reason in cache.bypassed()] == ["reads a row count back"]
    assert cache.resident(owner, [cache.key_for(syncing, (owner, x), {}, {})])


def test_hits_count_only_after_a_replay_returns():
    cache, owner = ExecutableCache(), _Owner()
    fail = []

    def stage(owner, x):
        if fail:
            raise RuntimeError("replay failed")
        return x * 3

    x = torch.arange(5)
    for _ in range(3):  # eager, capture, replay
        assert torch.equal(cache.call(stage, (owner, x), {}, {}), x * 3)
    assert cache.snapshot()[:2] == (1, 2)
    fail.append(True)
    with pytest.raises(RuntimeError, match="replay failed"):
        cache.call(stage, (owner, x), {}, {})
    assert cache.snapshot()[:2] == (1, 2)


@pytest.mark.parametrize("finals", ["0", "1"], ids=["finals-off", "finals-on"])
def test_a_warmed_stage_sends_nothing_from_the_host(monkeypatch, finals):
    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")
    monkeypatch.setenv("CKO_PALLAS_FINALS", finals)
    eng = TEngine(SMALL_RULES, device="cpu")
    match, pairs, numvals = _stage_args(eng, _window(9))
    put = []
    real_as_tensor, real_tensor = torch.as_tensor, torch.tensor

    def counted(real):
        def call(*a, **k):
            if "device" in k:
                put.append(real.__name__)
            return real(*a, **k)
        return call

    monkeypatch.setattr(torch, "as_tensor", counted(real_as_tensor))
    monkeypatch.setattr(torch, "tensor", counted(real_tensor))
    runs = []
    for _ in range(2):
        put.clear()
        hits = tuple(match_tier_packed(*a, mask=m) for a, m in match)
        cached = tuple(torch.zeros((2, h.shape[1]), dtype=torch.uint8) for h in hits)
        eval_post_tiered(eng.model, hits, pairs, numvals, max_phase=2, cached=cached)
        runs.append(len(put))
    assert runs[0] > 0 and runs[1] == 0, runs  # the first run builds the constants


def test_a_replay_books_the_launches_its_capture_recorded(monkeypatch):
    monkeypatch.setattr(dfa, "LAUNCHES", 0)
    monkeypatch.setattr(segment_finals, "LAUNCHES", 0)
    cache, owner = ExecutableCache(), _Owner()

    def launching(owner, x):
        kernels.book(dfa.__name__, 2)
        kernels.book(segment_finals.__name__, 1)
        return x * 2

    x = torch.arange(3)
    for i in range(1, 5):  # eager, capture, replay, replay
        cache.call(launching, (owner, x), {}, {})
        assert (dfa.LAUNCHES, segment_finals.LAUNCHES) == (2 * i, i)
    assert cache.stats()["captures"] == 1 and cache.snapshot()[0] == 2

    # A capture records only its own thread's launches.
    other = threading.Thread(target=kernels.book, args=(dfa.__name__, 5))
    with kernels.record_launches() as rec:
        kernels.book(dfa.__name__, 7)
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert rec == {dfa.__name__: 7} and dfa.LAUNCHES == 8 + 5
    kernels.book_record(rec)
    assert dfa.LAUNCHES == 8 + 5 + 7
