"""PyTorch port: the per-stage executables (``EXEC_CACHE``).

- Two rulesets with one bucketed layout have equal batch signatures in the
  port, as in the JAX package; each model keeps its own stage entries, so
  the second engine's first window is a miss of its own (the JAX package
  shares one executable), and each gives its own verdicts.
- A key's first run is a miss (eager), its second a miss that captures,
  later runs hit (replays); probes count nothing, and no call routes a
  window off the device.
- ``prewarm`` captures a batch's stages without serving a window and
  books the capture pass's seconds; the batch's next window is all hits.
- A window's value-cache rows ride in its tiers' pair-row buckets: the
  post stage's key does not move with how many of them there are, and
  the padded rows change no verdict.
- ``configure_persistent_cache`` points the kernel and native build
  directories at one place, idempotently; ``"0"`` disables.
- Tenants on one ruleset text share one engine (``SharedEngineFactory``).
"""

from __future__ import annotations

import numpy as np
import torch

from coraza_kubernetes_operator_tpu.engine import HttpRequest as JRequest
from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
from coraza_kubernetes_operator_tpu_torch import native
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest as TRequest
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine
from coraza_kubernetes_operator_tpu_torch.engine import compile_cache
from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import (
    EXEC_CACHE,
    ExecutableCache,
    batch_signature,
    configure_persistent_cache,
)
from coraza_kubernetes_operator_tpu_torch.ops import kernels
from coraza_kubernetes_operator_tpu_torch.sidecar.tenants import SharedEngineFactory

# Byte-class-isomorphic patterns (a 1:1 letter remap): equal DFA shapes.
RULES_A = 'SecRuleEngine On\nSecRule ARGS "@rx abcdef(?:gh|ij)+k" "id:100,phase:2,deny,status:403"\n'
RULES_B = 'SecRuleEngine On\nSecRule ARGS "@rx mnopqr(?:st|uv)+w" "id:100,phase:2,deny,status:403"\n'
URIS = ["/?q=abcdefghijk", "/?q=mnopqrstuvw", "/?q=benign-value"]


def test_one_layout_one_signature_as_in_jax():
    ta, tb = TEngine(RULES_A, device="cpu"), TEngine(RULES_B, device="cpu")
    ja, jb = JEngine(RULES_A), JEngine(RULES_B)
    treqs = [TRequest(uri=u) for u in URIS]
    jreqs = [JRequest(uri=u) for u in URIS]
    assert (ta.batch_signature(treqs) == tb.batch_signature(treqs)) == (
        ja.batch_signature(jreqs) == jb.batch_signature(jreqs)) is True
    # A different layout is a different signature.
    tc = TEngine(RULES_A + 'SecRule ARGS "@contains zz" "id:101,phase:2,deny"\n', device="cpu")
    assert tc.batch_signature(treqs) != ta.batch_signature(treqs)

    va = ta.evaluate(treqs)
    hits0, misses0, _ = EXEC_CACHE.snapshot()
    vb = tb.evaluate(treqs)
    hits1, misses1, _ = EXEC_CACHE.snapshot()
    # Entries live on their model: tb's first window is its own first sight.
    assert misses1 - misses0 == len(tb.batch_signature(treqs)) and hits1 == hits0
    assert [v.interrupted for v in va] == [v.interrupted for v in ja.evaluate(jreqs)] == [
        True, False, False]
    assert [v.interrupted for v in vb] == [v.interrupted for v in jb.evaluate(jreqs)] == [
        False, True, False]


def test_hits_misses_and_probes_count(monkeypatch):
    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")  # one signature per batch
    EXEC_CACHE.clear()
    eng = TEngine(RULES_A, device="cpu")
    reqs = [TRequest(uri=u) for u in URIS]
    sig = eng.batch_signature(reqs)
    n = len(sig)  # one matcher per tier, then the post stage
    assert n >= 2
    h0, m0, _ = EXEC_CACHE.snapshot()
    c0, t0 = EXEC_CACHE.stats()["captures"], EXEC_CACHE.stats()["trace_s"]
    eng.evaluate(reqs)
    h1, m1, _ = EXEC_CACHE.snapshot()
    # A stage's first run at a new key is an eager miss; nothing captured.
    assert (h1 - h0, m1 - m0) == (0, n)
    assert EXEC_CACHE.stats()["captures"] == c0 and not EXEC_CACHE.resident(eng.model, sig)
    assert eng.compiled.report.exec_signatures == n
    eng.evaluate(reqs)  # the second sight captures each stage
    h2, m2, _ = EXEC_CACHE.snapshot()
    assert (h2 - h1, m2 - m1) == (0, n)
    stats = EXEC_CACHE.stats()
    assert stats["captures"] - c0 == n and stats["trace_s"] > t0
    assert stats["entries"] == len(EXEC_CACHE) >= n
    eng.evaluate(reqs)  # then each replays
    h3, m3, _ = EXEC_CACHE.snapshot()
    assert (h3 - h2, m3 - m2) == (n, 0)
    assert EXEC_CACHE.resident(eng.model, sig)  # probes count nothing
    assert EXEC_CACHE.snapshot()[:2] == (h3, m3)
    assert not eng.prewarm(reqs)["compiled"]
    stats = EXEC_CACHE.stats()
    # No stage waited for the device from the host; the CPU instantiates nothing.
    assert (stats["bypasses"], stats["inflight"], stats["compile_s"]) == (0, 0, 0.0)


def test_prewarm_runs_a_window_per_new_signature_and_books_it(monkeypatch):
    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")  # one signature per batch

    class Owner:
        pass

    def double(owner, x):
        return x * 2

    cache, owner = ExecutableCache(), Owner()
    x = torch.arange(4)
    assert cache.warm(double, (owner, x), {}, {})
    assert not cache.warm(double, (owner, x), {}, {})  # already captured
    assert cache.stats()["captures"] == 1 and cache.snapshot()[:2] == (0, 1) and len(cache) == 1
    assert torch.equal(cache.call(double, (owner, x + 1), {}, {}), (x + 1) * 2)
    assert cache.snapshot()[:2] == (1, 1)
    key = cache.key_for(double, (owner, x), {}, {})
    cache.clear()
    assert len(cache) == 0 and not cache.resident(owner, [key])

    EXEC_CACHE.clear()
    eng = TEngine(RULES_B, device="cpu")
    reqs = [TRequest(uri=u) for u in URIS]
    sig = eng.batch_signature(reqs)
    h0, m0, _ = EXEC_CACHE.snapshot()
    t0 = EXEC_CACHE.stats()["trace_s"]
    first = eng.prewarm(reqs)
    h1, m1, _ = EXEC_CACHE.snapshot()
    t1 = EXEC_CACHE.stats()["trace_s"]
    assert first["compiled"] and first["wall_s"] >= t1 - t0 > 0 and (h1, m1 - m0) == (h0, len(sig))
    # Nothing was served: the engine is not warmed, but every stage is captured.
    assert not eng.warmed and EXEC_CACHE.resident(eng.model, sig)
    assert not eng.prewarm(reqs)["compiled"] and EXEC_CACHE.snapshot()[:2] == (h1, m1)
    eng.evaluate(reqs)
    assert EXEC_CACHE.snapshot()[:2] == (h1 + len(sig), m1) and eng.warmed


def test_signature_keys_shapes_masks_and_layout():
    eng = TEngine(RULES_A, device="cpu")
    tiers, numvals, masks, cached, _mk, lease = eng._batch_tensors([TRequest(uri=u) for u in URIS])
    if lease is not None:
        lease.release()
    sig = batch_signature(eng.model, tiers, numvals, masks, cached, 2)
    assert sig == batch_signature(eng.model, tiers, numvals, masks, cached, 2)
    assert sig != batch_signature(eng.model, tiers, numvals, masks, cached, 1)
    assert sig != batch_signature(eng.model, tiers, numvals, (7,) * len(tiers), cached, 2)
    # Same shapes as tensors: same signature.
    as_t = [tuple(torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in t) for t in tiers]
    assert sig == batch_signature(eng.model, as_t, torch.as_tensor(numvals), masks, cached, 2)
    other = TEngine(RULES_A + 'SecRule ARGS "@contains zz" "id:101,phase:2,deny"\n', device="cpu")
    assert sig != batch_signature(other.model, tiers, numvals, masks, cached, 2)


def test_cached_rows_ride_in_the_pairs_bucket():
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import stage_specs
    from coraza_kubernetes_operator_tpu_torch.models.waf_model import eval_post_tiered

    eng = TEngine(RULES_A, device="cpu")
    reqs = [TRequest(uri=u) for u in URIS]
    want = [(v.status, v.rule_id) for v in eng.evaluate(reqs)]
    tiers, numvals, masks, cached, _mk, lease = eng._batch_tensors(reqs)  # warm: rows cached
    try:
        assert cached is not None and any(c is not None and c.shape[0] > 1 for c in cached)
        pairs = [t[5].shape[0] for t in tiers]
        fewer = tuple(None if c is None else c[:1] for c in cached)
        sig = batch_signature(eng.model, tiers, numvals, masks, cached, 2)
        assert sig == batch_signature(eng.model, tiers, numvals, masks, fewer, 2)
        *_match, post = stage_specs(eng.model, tiers, numvals, masks, cached, 2)
        padded = post[4]["cached"]
        for c, pc, p in zip(cached, padded, pairs):
            if c is not None:
                assert pc.shape == (p,) + c.shape[1:]
                np.testing.assert_array_equal(pc[: c.shape[0]], c)
                assert not pc[c.shape[0]:].any()
        # The padded rows change no verdict: the window's hit rows from the
        # matcher, then the post stage with the padded and the bare rows.
        as_t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
        hits = tuple(
            fn(*(as_t(a) if isinstance(a, np.ndarray) else a for a in args), **st)
            for _l, fn, args, st, _d in _match
        )
        pt = tuple(tuple(torch.as_tensor(a) for a in pr) for pr in post[2][2])
        nv = torch.as_tensor(numvals)
        got = [
            eval_post_tiered(eng.model, hits, pt, nv, max_phase=2, cached=tuple(as_t(c) for c in cs))
            for cs in (cached, padded)
        ]
        torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)
    finally:
        if lease is not None:
            lease.release()
    assert [(v.status, v.rule_id) for v in eng.evaluate(reqs)] == want


def test_configure_persistent_cache_is_idempotent_and_zero_disables(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_configured_dir", [])
    monkeypatch.delenv("CKO_COMPILE_CACHE_DIR", raising=False)
    before = (kernels.BUILD_DIR, native.BUILD_DIR)
    assert configure_persistent_cache() is None
    assert configure_persistent_cache("0") is None
    assert (kernels.BUILD_DIR, native.BUILD_DIR) == before
    d = str(tmp_path / "builds")
    assert configure_persistent_cache(d) == d
    assert configure_persistent_cache(d) == d
    assert kernels.BUILD_DIR == tmp_path / "builds" / "torch_kernels"
    assert native.BUILD_DIR == tmp_path / "builds" / "native"
    assert (tmp_path / "builds").is_dir()
    assert configure_persistent_cache("0") == d  # "0" leaves the one in effect
    assert EXEC_CACHE.stats()["persistent_dir"] == d
    monkeypatch.setenv("CKO_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert configure_persistent_cache() == str(tmp_path / "env")
    assert kernels.BUILD_DIR == tmp_path / "env" / "torch_kernels"


def test_tenants_on_one_text_share_one_engine():
    built = []

    def factory(rules):
        built.append(TEngine(rules, device="cpu"))
        return built[-1]

    shared = SharedEngineFactory(factory)
    texts = [f'SecRuleEngine On\nSecRule ARGS "@contains tenant-{i}" "id:{200 + i},phase:2,deny"\n'
             for i in range(3)]
    engines = [shared(texts[i % 3]) for i in range(9)]
    assert len(built) == 3 and len({id(e) for e in engines}) == 3
    assert shared.dedup_hits == 6 and shared.resident == 3
    v = engines[4].evaluate_one(TRequest(uri="/?q=tenant-1"))
    assert v.interrupted and v.rule_id == 201
