"""Shared pipelined-vs-sync overlap measurement (docs/PIPELINE.md).

Bench config 3's ``pipeline`` block and the CI gate
(``hack/pipeline_smoke.py``) must measure the exact same discipline —
warm policy, stage accounting, depth-bounded double buffering — or a
change to one silently skews the other's numbers. This is the one copy
both call.
"""

from __future__ import annotations

import time
from collections import deque


def verdict_tuple(v) -> tuple:
    """A ``Verdict``'s full observable content, as a comparable tuple —
    THE bit-identical parity predicate. The CI gate and the test suite
    both compare through this one definition, so a new ``Verdict`` field
    can't silently weaken one of them."""
    return (
        v.interrupted,
        v.status,
        v.rule_id,
        tuple(v.matched_ids),
        tuple(sorted(v.scores.items())),
    )


def measure_overlap(eng, batches, depth: int = 2) -> dict:
    """Run ``batches`` through ``eng.prepare``/``collect`` twice — once
    strictly alternating (collect window i before preparing window i+1:
    the pre-pipeline serial hot path) and once double-buffered (window
    i+1's host assembly overlaps window i's device step, bounded
    in-flight ``depth``, FIFO collection).

    Every batch's shape signature is warmed untimed first: distinct
    batches can land in distinct row buckets, and a compile paid inside
    the timed sync pass (but amortized by the pipelined pass) would fake
    the speedup being measured. The value cache is bypassed for the
    whole measurement: a cache hit shrinks the miss-row bucket and would
    mint a fresh executable mid-measurement — stable shapes keep both
    passes executing one identical executable.

    Returns ``{sync_wall, pipe_wall, host_s, device_s, decode_s,
    sync_verdicts, pipe_verdicts, compile_cache}``: walls in seconds,
    stage totals from the sync pass's ``InFlightBatch`` timings (the
    overlap target the pipelined wall should approach is
    max(host, device+decode)), per-pass verdict lists in submission
    order (bit-identical is the pipelining invariant), and the
    EXEC_CACHE ``{hits, misses}`` delta across the two timed passes
    (misses must be 0 — a mid-measurement compile voids the numbers).
    """
    from ..engine.compile_cache import EXEC_CACHE

    saved_cache = eng.value_cache
    eng.value_cache = None
    try:
        for reqs in batches:  # a stage's first run is eager, its second captures
            eng.collect(eng.prepare(reqs))
            eng.collect(eng.prepare(reqs))
        cc0 = EXEC_CACHE.snapshot()

        host = device = decode = 0.0
        sync_verdicts = []
        t0 = time.perf_counter()
        for reqs in batches:
            inf = eng.prepare(reqs)
            sync_verdicts.append(eng.collect(inf))
            host += inf.host_s
            device += inf.device_s
            decode += inf.decode_s
        sync_wall = time.perf_counter() - t0

        pipe_verdicts = []
        t0 = time.perf_counter()
        q = deque()
        for reqs in batches:
            q.append(eng.prepare(reqs))
            if len(q) >= depth:
                pipe_verdicts.append(eng.collect(q.popleft()))
        while q:
            pipe_verdicts.append(eng.collect(q.popleft()))
        pipe_wall = time.perf_counter() - t0
        cc1 = EXEC_CACHE.snapshot()
    finally:
        eng.value_cache = saved_cache
    return {
        "sync_wall": sync_wall,
        "pipe_wall": pipe_wall,
        "host_s": host,
        "device_s": device,
        "decode_s": decode,
        "sync_verdicts": sync_verdicts,
        "pipe_verdicts": pipe_verdicts,
        "compile_cache": {"hits": cc1[0] - cc0[0], "misses": cc1[1] - cc0[1]},
    }
