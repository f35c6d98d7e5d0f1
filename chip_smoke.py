#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold every kernel to its
plain PyTorch version.

Run from the repository root: ``python3 chip_smoke.py``. Phases (any
failure exits non-zero; no phase is caught):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build every kernel from ``coraza_kubernetes_operator_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together), and the
   native host runtime from ``native/src`` with ``g++``, each timed;
2. one phase per kernel at the main path's tier shapes (B x L = 12288 x
   64, 1024 x 2048) and at B = 4096, on seeded random bytes: the scan
   kernels on crs-lite's banks (the flat bin, all dfa-hot gather banks in
   one fused launch, all prefilter banks in one fused launch over
   ``model.pre_tier``), the finals kernel on every
   crs-lite segment block with finals columns, its operands taken from the
   block's own chain program (``ops/segment.py::finals_inputs``), and the
   chain kernel on every crs-lite segment block, its operands (the block's
   conv output, rows and lengths) from ``ops/segment.py::chain_inputs``,
   with the finals tier off and on (both timed, one launch per block in
   each, each block's tile plan logged); then the conv in front of the
   chain in its two layouts (``F.conv1d`` on [T, C, Lp] and a
   channels-last ``F.conv2d`` on the embed's [T, Lp, C]), bit-equal and
   timed. Each kernel's output must be bit-equal to its plain version's on
   the card. Times come from CUDA events after warm-up around the
   wrappers' calls;
3. the slice-1 path: ``WafEngine(crs-lite).evaluate`` on a 4096-request
   window on the card (Python tensorize path, finals tier off; each stage's
   first sight, so eager), verdicts identical to the same engine on the
   CPU, at least one request blocked, every scan kernel's launch count
   non-zero, and the chain kernel's too. Then the stage graphs (``engine/compile_cache.py``), with the
   engine's value cache off so a window and its twin do the same work:
   the same window's stages captured (``prewarm``) and replayed, verdicts
   identical to the CPU engine's; then fresh windows, each prewarmed
   (captures and their capture and instantiation seconds logged), in
   alternating pairs within this call: eager(a), graph(a), graph(b),
   eager(b), eager reached by calling the stage functions directly
   (``eager_stages``). Each graph window must only replay and give its
   eager twin's verdicts and kernel launches; per mode the window p50
   and the host stage split (assemble, copy-in, match, prefilter confirm,
   post, read-back, decode), resident graphs and their pool bytes; no
   stage may bypass its graph;
4. the slice-2 path: the same 4096 requests as one blob through
   ``prepare_blob`` + ``collect`` on the native tiered path with
   ``CKO_PALLAS_FINALS=1``: verdicts equal to phase 3's, all five kernels
   launched, at most one fused gather launch and one fused dense launch
   per tier; the same blob captured and replayed, verdicts equal; then
   eager/graph pairs as in phase 3 with the finals tier on and off; then
   ``evaluate_phased`` and ``evaluate_response`` against the CPU engine
   and ``host_fallback.evaluate`` against the card's verdicts;
6. the sidecar on the card (``sidecar_phase``): the port's rule-cache
   server holds crs-lite; the port's sidecar polls it with the deployed
   defaults (async frontend, windows of up to 2048 requests, 1 ms batch
   delay, pipeline depth 2; verdict cache off, the adaptive scheduler off
   so it keeps the delay and the depth) and is driven over real sockets
   (filter mode, keep-alive, 8 connections pipelining 32 each) with 768
   of phase 3's requests: served req/s, per-request p50/p99 (all, and
   after each connection's first group), windows and their mean size, the
   batcher's host and device stage p50s, each kernel's launches. A second
   sidecar, started in the same process from what the port's control
   plane deploys (``controller_config``: a ``driver.gpu`` Engine
   reconciled by ``EngineReconciler``, its Deployment holding
   ``nvidia.com/gpu``, the container's args through ``gpu-engine``'s
   ``build_config`` with only the cache server, ports and audit log
   overridden: a 100 ms batch delay, since a window costs about the same
   host time whatever its size and at 1 ms the 4096 would take minutes,
   and an ext_proc listener), serves all 4096; the three scan kernels
   and the chain kernel must launch. Every answer (status, x-waf-action, x-waf-rule-id, body)
   must equal a CPU sidecar's on the threaded frontend; again with
   ``CKO_PALLAS_FINALS=1`` (the finals kernel must launch); then 512 of
   the requests through the ext_proc listener (64 ``ExtProcClient``
   connections, one thread each; the native transport, pinned), every
   (status, x-waf-action, x-waf-rule-id)
   equal to the HTTP answer, the body too where refused; a hot reload
   must flip a request that only the new rule matches from 200 to 403
   after a shadowed rollout; one injected device loss must be answered by
   the host fallback and end ``promoted`` again. ``CKO_LAZY_TIERS=1`` (the
   JAX package's deployed default) is set throughout, and no stage may go
   through a host twin. ``/waf/v1/metrics`` must carry the build info
   (torch and CUDA versions), the compile-cache and tier-kind families,
   and the profile endpoint's trace (of a window whose stages were seen
   before, so replayed) must name the scan kernels; its kernel events give
   the window's device busy share. Each pass logs the stage cache's
   counters; no stage may bypass its graph;
7. go-ftw conformance on the card (``conformance_phase``), the corpora
   and the ledger read from the port's JSON mirror (no ``pyyaml``):
   (a) the crs-lite corpus in-process on a fresh card engine, every
   request stage in one batched window and the response-injection stages
   through ``evaluate_response``: exactly the JAX package's result on
   this tree (``CRS_LITE_FAILED``: 314 passed, ``["920160-1"]`` ignored,
   the same 11 failed with the same reasons, no skipped file), the three
   scan kernels and the chain kernel launched; (b) the same window with
   ``CKO_PALLAS_FINALS=1``: every stage verdict equal to (a)'s, the finals
   kernel launched; (c) the mini corpus (``ftw/tests``) over HTTP against
   a sidecar on the card serving ``base.conf`` + ``crs-mini.conf`` from
   phase 6's cache server under its own key, audit log matched: green, and
   its passed and ignored sets equal to an in-process replay on the card;
   every stage key that bypassed its graph is logged with its shapes and
   reason;
8. the sharded engine (``sharded_phase``): a one-rank NCCL process group,
   ``make_mesh(1, 1)``, ``ShardedWafEngine`` on crs-lite: phase 3's 4096
   requests give phase 3's verdicts (interrupted, status, rule id) and
   launch ``cko_scan_dense`` and ``cko_chain_match``; the device memory the rank's engine holds,
   beside that of ``build_model``'s single-device model; then the p50 of 3
   fresh windows beside phase 3's p50, the finals tier off in both; the
   process group is destroyed
   after. One card holds one NCCL rank, so the multi-rank meshes are held
   on the CPU over gloo;
5. after every timed window (no profiler session runs before them): each
   kernel's own device time per launch at phase 2's shapes, from one
   ``torch.profiler`` pass each (kernel events by name; the chain kernel
   finals off and on), and both conv layouts' kernels by part (conv,
   transposes); then one profiled finals-on blob window, eager (launches,
   device busy time, and no [T, Q, Gf] stack of per-group rows) and the
   same window replayed, the same with the finals tier off, and one
   phase-3 window eager and replayed; each profiled window logs its kernel
   launches, device busy ms, each hand kernel's launches and ms, the
   matcher's conv, conv transposes and chain apart, and the stage graphs'
   pool bytes. The smoke's total seconds close the log.

Phases run in the order 0-4, 6, 7, 8, 5. The last lines are the kernel
table (one JSON object; ``launches`` from phase 4's window, and per kernel
its launches on the sidecar, conformance and sharded paths where those
reach it), the card's name
and power limit, and ``{"ok": true, "device": {...}}``. With no card, or
without the package beside this file, it exits non-zero and prints no
result. ``--profile FILE`` writes the profiled phase-4 windows'
``torch.profiler`` tables by kernel name to FILE. ``--probe-profiler``
asks whether a ``torch.profiler`` session slows the windows that follow
it: before phase 5 it times fresh phase-3 and finals-off blob windows,
opens and closes one empty profiler session, times them again, and once
more after phase 5's sessions.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import http.client
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "coraza_kubernetes_operator_tpu_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
SHAPES = ((12288, 64), (1024, 2048), (4096, 64))  # main-path tiers, then B = 4096
SEED = 20261016
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet)
# Profiler event names of the hand kernels (a substring of each kernel's name).
HAND_KERNELS = ("finals_kernel", "gather_tier_kernel", "dense_tier_kernel", "flat_kernel", "chain_kernel")


# The go-ftw result the JAX package gives on the repo's crs-lite corpus
# (hack/run_ftw_chunk.py; its CPU backend crashes on the last 31
# title-sorted tests, which the port passes): 314 passed, "920160-1"
# ignored by the ledger, and these 11 failed.
# tests/test_torch_ftw_crs_lite.py replays these 11 and their passing
# neighbours through the JAX package and the port, and holds both to this
# list; it lives here because the card's machine has no JAX. The ruleset matches what
# these tests expect to pass: 942530, for one, scores an argument named
# "select". So the breakdown tests/test_ftw_crs_lite.py commits (325
# passed), which only its slow-tier test checks, does not hold on this
# tree in either package (ROADMAP C5). Phase 7a holds the card to exactly
# the reference's result: the same failures, with the same reasons.
CRS_LITE_FAILED = {
    "920510-1": "stage 0: status 403 not in [200]",
    "920550-1": "stage 0: status 403 not in [200]",
    "920550-2": "stage 0: status 403 not in [200]",
    "921220-1": "stage 0: status 403 not in [200]",
    "932210-1": "stage 0: status 403 not in [200]",
    "932210-2": "stage 0: status 403 not in [200]",
    "934131-1": "stage 0: rule 934131 not in audit log (saw [934130, 949110])",
    "941330-1": "stage 0: status 403 not in [200]",
    "941360-1": "stage 0: status 200 not in [403]",
    "942260-2": "stage 0: rule 942260 not in audit log (saw [942450, 949110])",
    "942530-1": "stage 0: status 403 not in [200]",
}

T_START = time.perf_counter()


def log(*a) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def out(line: str) -> None:
    """A result line, printed bare (the last lines are parsed)."""
    print(line, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_per_launch(fn, kernel_name: str, reps: int) -> tuple[float | None, int]:
    """A kernel's own device time per launch, from one ``torch.profiler``
    pass over ``reps`` calls of ``fn``: the CUDA kernel events whose name
    holds ``kernel_name``. Returns (ms per launch or None, launches seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel_name in e.key]
    n = sum(e.count for e in events)
    us = sum(e.self_device_time_total for e in events)
    return (us / n / 1e3 if n and us else None), n


@contextlib.contextmanager
def eager_stages():
    """Inside, every window stage runs its function directly (eager), not
    through its stage graph: ``EXEC_CACHE.call`` is shadowed by a direct
    call on the instance."""
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    EXEC_CACHE.call = lambda fn, args, statics, dyn, *_timer: fn(*args, **statics, **dyn)
    try:
        yield
    finally:
        del EXEC_CACHE.call


def cache_delta(s0: dict, s1: dict) -> dict:
    """The change of ``EXEC_CACHE.stats()``'s counters between two reads."""
    return {k: round(s1[k] - s0[k], 3) for k in ("hits", "misses", "captures", "compile_s",
                                                  "trace_s", "bypasses")}


def timed_window(engine, submit, mods, eager: bool) -> dict:
    """One window through ``submit()`` (a prepare or prepare_blob) and
    ``collect``, eager or through the stage graphs: its wall, host stage
    split, launches per kernel, stage-cache counter changes and verdicts."""
    import torch

    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    for m in mods.values():
        m.LAUNCHES = 0
    s0 = EXEC_CACHE.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eager_stages() if eager else contextlib.nullcontext():
        inflight = submit()
        got = engine.collect(inflight)
    wall = time.perf_counter() - t0
    split = {"assemble": inflight.assemble_s, **inflight.stage_s,
             "read_back": inflight.readback_s, "decode": inflight.decode_s}
    return {"wall": wall, "split": split, "launches": {k: m.LAUNCHES for k, m in mods.items()},
            "cache": cache_delta(s0, EXEC_CACHE.stats()),
            "verdicts": [(v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores) for v in got]}


def eager_graph_pairs(tag, card, engine, windows, submit, mods) -> dict:
    """Windows in alternating pairs within this call: for each two windows
    a, b: eager(a), graph(a), graph(b), eager(b). Every graph window must
    replay only (its signature was captured before) and give its eager
    twin's verdicts and kernel launches. Logs and returns the p50s."""
    res = {"eager": [], "graph": []}
    for i in range(0, len(windows) - 1, 2):
        a, b = windows[i], windows[i + 1]
        twins = {}
        for mode, w in (("eager", a), ("graph", a), ("graph", b), ("eager", b)):
            r = timed_window(engine, lambda: submit(w), mods, mode == "eager")
            res[mode].append(r)
            if mode == "graph" and (r["cache"]["misses"] or not r["cache"]["hits"]):
                raise SystemExit(f"{tag}: a graph window did not only replay: {r['cache']}")
            other = twins.setdefault(id(w), r)
            if other is not r:
                if other["verdicts"] != r["verdicts"]:
                    diff = [j for j, (x, y) in enumerate(zip(other["verdicts"], r["verdicts"])) if x != y]
                    raise SystemExit(f"{tag}: {len(diff)} graph verdicts differ from eager, first {diff[:5]}")
                if other["launches"] != r["launches"]:
                    raise SystemExit(f"{tag}: launches eager {other['launches']} != graph {r['launches']}")
    out = {}
    for mode, rs in res.items():
        walls = [r["wall"] for r in rs]
        split = {k: statistics.median(r["split"][k] for r in rs) * 1e3 for k in rs[0]["split"]}
        out[mode] = statistics.median(walls)
        log(f"{tag}: {mode} windows ms {[round(x * 1e3, 1) for x in walls]} (p50 "
            f"{out[mode] * 1e3:.1f}); host stage split p50 ms "
            f"{ {k: round(v, 2) for k, v in split.items()} }; launches per window "
            f"{rs[0]['launches']}; stage cache per window {rs[0]['cache']} [{card}]")
    return out


def prewarm_windows(tag, card, engine, windows) -> None:
    """Capture each window's stage graphs (``prewarm``), untimed: logs the
    captures and their capture and instantiation seconds."""
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    s0 = EXEC_CACHE.stats()
    t0 = time.perf_counter()
    for w in windows:
        engine.prewarm(w)
    d = cache_delta(s0, EXEC_CACHE.stats())
    n = max(1, d["captures"])
    log(f"{tag}: prewarm of {len(windows)} windows in {time.perf_counter() - t0:.3f} s: "
        f"{d['captures']} stage graphs captured, per graph capture {d['trace_s'] / n:.3f} s and "
        f"instantiation {d['compile_s'] / n:.3f} s; resident graphs {len(EXEC_CACHE)}, "
        f"pool {EXEC_CACHE.pool_bytes() / 2**30:.2f} GiB [{card}]")


def profiled_window(engine, submit, eager: bool):
    """(wall ms, device busy ms, kernel launches, per-kernel (launches, ms),
    profiler, the matcher's parts (launches, ms)) for one window under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with eager_stages() if eager else contextlib.nullcontext():
            t0 = time.perf_counter()
            engine.collect(submit())
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Kernel events only: an aten op's self device time repeats its kernels'.
    kernel_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernel_events) / 1e3
    n_launch = sum(e.count for e in kernel_events)
    mine = {name: (sum(e.count for e in kernel_events if name in e.key),
                   sum(e.self_device_time_total for e in kernel_events if name in e.key) / 1e3)
            for name in HAND_KERNELS}
    return wall_ms, device_ms, n_launch, mine, events, kernel_parts(kernel_events)


def part_of(key: str) -> str | None:
    """The part of the conv-segment matcher a kernel event belongs to: the
    chain kernel, the conv's layout transposes (cuDNN's NCHW <-> NHWC
    kernels and tensor transforms) or the conv itself (cuDNN's other
    kernels); None for the rest."""
    if "chain_kernel" in key:
        return "chain"
    if any(k in key for k in ("nchwToNhwc", "nhwcToNchw", "tensorTransform")):
        return "conv transposes"
    if any(k in key for k in ("cudnn", "fprop", "implicit_convolve")):
        return "conv"
    return None


def kernel_parts(kernel_events) -> dict:
    """{part: (launches, device ms)} over CUDA kernel events."""
    parts = {"conv": [0, 0.0], "conv transposes": [0, 0.0], "chain": [0, 0.0]}
    for e in kernel_events:
        p = part_of(e.key)
        if p:
            parts[p][0] += e.count
            parts[p][1] += e.self_device_time_total / 1e3
    return {k: (n, round(ms, 4)) for k, (n, ms) in parts.items()}


def profiled_parts(fn) -> dict:
    """``kernel_parts`` of one call of ``fn`` (after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_parts([e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA])


def conv_layouts(segment, blk, b: int, length: int, rng, dev):
    """(conv1d, channels-last conv2d) calls of ``blk``'s conv on seeded
    rows, each from the embed planes (``ops/segment.py::_match``'s steps 1
    and 2 in either layout); both give [T, N2, Q]."""
    import torch
    import torch.nn.functional as F

    _prog, dc = segment._block_consts(blk.kernel, blk.spec, dev, blk.consts)
    weight = segment._conv_weight(dc, 0, dev)  # [N2, C, W] bf16
    w4 = weight[:, :, None, :].contiguous(memory_format=torch.channels_last)
    d, _l = random_rows(rng, b, length)
    planes = dc.planes[:, F.pad(torch.as_tensor(d, device=dev).to(torch.int64), (1, blk.spec.w))]

    def ncl():
        return F.conv1d(planes.permute(1, 0, 2).to(weight.dtype, memory_format=torch.contiguous_format),
                        weight)

    def nhwc():
        x = planes.permute(1, 2, 0).to(weight.dtype, memory_format=torch.contiguous_format)  # [T, Lp, C]
        return F.conv2d(x.permute(0, 2, 1)[:, :, None, :], w4)[:, :, 0, :]

    return ncl, nhwc


class GroupRowStacks:
    """Counts ``torch.stack``/``torch.cat`` calls, while active, whose
    inputs are Gf per-group reachability rows [T, Q] (or [T, Q, 1]) for a
    finals block's group count Gf and a tier's Q: the [T, Q, Gf] stack the
    finals tier no longer builds. (The profiler records no shapes for a
    tensor list, so the calls are watched at the Python level.)"""

    def __init__(self, gfs: set, qs: set):
        import torch

        self.gfs, self.qs, self.count = gfs, qs, 0
        watcher = self

        class Mode(torch.overrides.TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func in (torch.stack, torch.cat) and args:
                    watcher.look(args[0])
                return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def look(self, rows) -> None:
        if isinstance(rows, (list, tuple)) and len(rows) in self.gfs and all(
                x.dim() in (2, 3) and x.shape[1] in self.qs and tuple(x.shape[2:]) in ((), (1,))
                for x in rows):
            self.count += 1

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def random_rows(rng, b: int, length: int):
    """Seeded traffic-like bytes: mostly printable ASCII with some
    attack-token fragments spliced in, ragged lengths in [0, L]."""
    import numpy as np

    alphabet = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
        b" ='\"<>()/;-_.%&+,:!*#@", dtype=np.uint8
    )
    data = alphabet[rng.integers(0, alphabet.size, size=(b, length))]
    tokens = [b"select", b"union", b"<script>", b"../", b"' or 1=1", b"/etc/passwd",
              b"cmd.exe", b"javascript:", b"onerror=", b"%27", b"exec(", b"${"]
    for r in rng.choice(b, size=b // 3, replace=False):
        tok = np.frombuffer(tokens[rng.integers(len(tokens))], dtype=np.uint8)
        if tok.size < length:
            at = rng.integers(0, length - tok.size)
            data[r, at : at + tok.size] = tok
    lens = rng.integers(0, length + 1, size=b).astype(np.int32)
    data[np.arange(length)[None, :] >= lens[:, None]] = 0
    return data, lens


# -- phase 6 helpers: an HTTP/1.1 client with keep-alive and pipelining ------


def request_bytes(req) -> bytes:
    """One request on the wire, encoded like a real client: the synthetic
    attack URIs carry raw spaces, which a request line must not."""
    uri = req.uri.replace(" ", "%20")
    lines = [f"{req.method} {uri} HTTP/1.1"]
    for k, v in req.headers:
        lines.append(f"{k}: {v}")
    if req.body:
        lines.append(f"Content-Length: {len(req.body)}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1", "replace")
    return head + (req.body or b"")


def read_response(f) -> tuple:
    """(status, x-waf-action, x-waf-rule-id, body) of one response."""
    status_line = f.readline()
    if not status_line:
        raise ConnectionError("the sidecar closed the connection mid-stream")
    status = int(status_line.split()[1])
    headers = {}
    while True:
        ln = f.readline()
        if ln in (b"\r\n", b"\n", b""):
            break
        k, _, v = ln.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    length = int(headers.get("content-length", 0))
    body = f.read(length) if length else b""
    return (status, headers.get("x-waf-action"), headers.get("x-waf-rule-id"), body)


def drive(port: int, payloads: list, conns: int, depth: int):
    """Send ``payloads`` over ``conns`` keep-alive connections, each
    pipelining groups of ``depth``. Returns (answers and, in the same
    order, per-request seconds from its group's send to its answer, wall
    seconds). Request ``i`` rides connection ``i % conns`` in that
    connection's group ``i // conns // depth``."""
    shares = [payloads[i::conns] for i in range(conns)]
    out: list = [None] * conns
    # Connect one at a time: a burst of connects can overflow a listener's
    # accept backlog (the threaded frontend's is 5) into SYN retries.
    socks = [socket.create_connection(("127.0.0.1", port), timeout=300) for _ in range(conns)]

    def worker(idx):
        try:
            answers, lat = [], []
            s = socks[idx]
            try:
                f = s.makefile("rb")
                for i in range(0, len(shares[idx]), depth):
                    group = shares[idx][i : i + depth]
                    t0 = time.perf_counter()
                    s.sendall(b"".join(group))
                    for _ in group:
                        answers.append(read_response(f))
                        lat.append(time.perf_counter() - t0)
            finally:
                s.close()
            out[idx] = (answers, lat)
        except BaseException as err:  # raised in the main thread below
            out[idx] = err

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(conns)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    answers: list = [None] * len(payloads)
    lat: list = [None] * len(payloads)
    for i, r in enumerate(out):
        if isinstance(r, BaseException):
            raise r
        answers[i::conns] = r[0]
        lat[i::conns] = r[1]
    return answers, lat, wall


def drive_extproc(port: int, reqs: list, conns: int):
    """Send ``reqs`` through the sidecar's ext_proc listener over ``conns``
    ``ExtProcClient`` connections, one thread each (a client runs one
    stream at a time). Each request goes as its HTTP bytes carry it
    (``request_bytes``: the same path and headers, Content-Length
    included). Returns (answers as ``read_response`` gives them, per-request
    seconds, wall seconds); request ``i`` rides connection ``i % conns``."""
    from coraza_kubernetes_operator_tpu_torch.sidecar.extproc import ExtProcClient

    out: list = [None] * conns
    clients = [ExtProcClient("127.0.0.1", port, timeout_s=300) for _ in range(conns)]

    def worker(idx):
        try:
            answers, lat = [], []
            for req in reqs[idx::conns]:
                headers = list(req.headers)
                if req.body:
                    headers.append(("Content-Length", str(len(req.body))))
                t0 = time.perf_counter()
                r = clients[idx].filter(req.method, req.uri.replace(" ", "%20"), headers, req.body or b"")
                lat.append(time.perf_counter() - t0)
                answers.append((r["status"], r["headers"].get("x-waf-action"),
                                r["headers"].get("x-waf-rule-id"), r["body"]))
            out[idx] = (answers, lat)
        except BaseException as err:  # raised in the main thread below
            out[idx] = err
        finally:
            clients[idx].close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(conns)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    answers: list = [None] * len(reqs)
    lat: list = [None] * len(reqs)
    for i, r in enumerate(out):
        if isinstance(r, BaseException):
            raise r
        answers[i::conns] = r[0]
        lat[i::conns] = r[1]
    return answers, lat, wall


def controller_config(cache_port: int, key: str, **knobs):
    """The sidecar config the port's control plane deploys for a
    ``driver.gpu`` Engine (defaults) on RuleSet ``key``: the Engine
    reconciled by ``EngineReconciler`` on an in-memory store, the rendered
    container's args with only the cache server (this process's), the
    ports (0: ephemeral) and the audit log (off) overridden, parsed by
    ``gpu-engine``'s ``build_config``; then ``knobs``, fields the
    controller does not render. Returns (config, the rendered container)."""
    import dataclasses

    from coraza_kubernetes_operator_tpu_torch.cmd import gpu_engine
    from coraza_kubernetes_operator_tpu_torch.controlplane import (
        DriverConfig, Engine, EngineReconciler, EngineSpec, EventRecorder, GpuDriverConfig,
        ObjectMeta, ObjectStore,
    )
    from coraza_kubernetes_operator_tpu_torch.controlplane.api_types import RuleSetReference

    ns, name = key.split("/")
    store = ObjectStore()
    store.create(Engine(metadata=ObjectMeta(name="chip-smoke", namespace=ns),
                        spec=EngineSpec(rule_set=RuleSetReference(name),
                                        driver=DriverConfig(gpu=GpuDriverConfig()))))
    EngineReconciler(store, EventRecorder(), cache_server_cluster="coraza-cache").reconcile(ns, "chip-smoke")
    dep = store.get("Deployment", ns, "coraza-gpu-engine-chip-smoke")
    container = dep.spec["template"]["spec"]["containers"][0]
    if container["resources"]["limits"] != {"nvidia.com/gpu": "1"}:
        raise SystemExit(f"phase 6: the rendered Deployment requests {container['resources']}")
    overrides = {"--cache-server-cluster": "127.0.0.1", "--cache-server-port": str(cache_port),
                 "--port": "0", "--extproc-port": "0", "--audit-log": ""}
    args = [a for a in container["args"] if a.split("=")[0] not in overrides]
    cfg = gpu_engine.build_config(args + [f"{k}={v}" for k, v in overrides.items()])
    return dataclasses.replace(cfg, **knobs), container


def http_call(port: int, method: str, path: str, token: str, body: bytes = b""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body or None,
                     headers={"Authorization": f"Bearer {token}",
                              "Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def wait_for(pred, timeout_s: float, what: str, interval_s: float = 0.05, phase: int = 6) -> float:
    """Seconds until ``pred()`` holds; exits non-zero past ``timeout_s``."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise SystemExit(f"phase {phase}: timed out after {timeout_s} s waiting for {what}")
        time.sleep(interval_s)
    return time.perf_counter() - t0


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def sidecar_phase(card, reqs, verdicts, cpu_eng, mods, table, cache, srv) -> None:
    """Phase 6: the port's sidecar on the card, driven over real sockets;
    ``srv`` serves ``cache`` (the port's rule-cache server)."""
    import torch

    from coraza_kubernetes_operator_tpu_torch.engine import waf as waf_mod
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE
    from coraza_kubernetes_operator_tpu_torch.engine.value_cache import ValueHitCache
    from coraza_kubernetes_operator_tpu_torch.ftw.corpus import load_ruleset_text
    from coraza_kubernetes_operator_tpu_torch.sidecar import SidecarConfig, TpuEngineSidecar
    from coraza_kubernetes_operator_tpu_torch.sidecar.batcher import LANE_BULK

    key, token = "default/crs-lite", "chip-smoke"
    scans = ("cko_scan_flat", "cko_scan_gather", "cko_scan_dense", "cko_chain_match")
    os.environ["CKO_VERDICT_CACHE_MAX"] = "0"  # every request rides a device window
    os.environ["CKO_PALLAS_FINALS"] = "0"
    # The JAX package's tpu-engine sets this by default (it answers stages
    # not compiled yet through the host twins). The port has no such mode:
    # with it set, no window may leave the card.
    os.environ["CKO_LAZY_TIERS"] = "1"
    host_twin_calls = [0]
    real_twins = {name: getattr(waf_mod.WafEngine, name) for name in ("_host_tier_hits", "_host_post")}

    def counted(real):
        def twin(self, *a, **k):
            host_twin_calls[0] += 1
            return real(self, *a, **k)
        return twin

    for name, real in real_twins.items():
        setattr(waf_mod.WafEngine, name, counted(real))
    rules = load_ruleset_text()
    cache.put(key, rules)
    running = []

    def config(**kw):
        base = dict(cache_base_url=f"http://127.0.0.1:{srv.port}", instance_key=key,
                    poll_interval_s=0.2, host="127.0.0.1", port=0, max_batch_size=2048,
                    max_batch_delay_ms=1.0, pipeline_depth=2, frontend="async",
                    metrics_auth_token=token, shadow_promote_windows=2,
                    shadow_idle_check_s=0.05, compile_budget_s=600.0,
                    # The adaptive scheduler would retune the batch delay and
                    # the depth of 2 (toward a 50 ms p99 it cannot reach
                    # here, so it shrinks windows): keep them as set.
                    adaptive_enabled=False)
        return SidecarConfig(**{**base, **kw})

    def start(cfg, engine=None):
        sc = TpuEngineSidecar(cfg, engine=engine)
        running.append(sc)
        t0 = time.perf_counter()
        sc.start()
        wait_for(lambda: sc.serving_mode() == "promoted", 300, "promotion")
        return sc, time.perf_counter() - t0

    def stop(sc):
        sc.stop()
        running.remove(sc)

    def counts():
        return {k: m.LAUNCHES for k, m in mods.items()}

    def zero():
        for m in mods.values():
            m.LAUNCHES = 0

    def mark(sc):
        st = sc.batcher.stats
        return len(st.batch_sizes), len(st.host_stage_s), st.errors

    def since(sc, m):
        st = sc.batcher.stats
        sizes = st.batch_sizes[m[0]:]
        return (len(sizes), sum(sizes) / max(1, len(sizes)),
                pct(st.step_latencies_s[m[0]:], 0.5) * 1e3,
                pct(st.host_stage_s[m[1]:], 0.5) * 1e3,
                pct(st.device_stage_s[m[1]:], 0.5) * 1e3, st.errors - m[2])

    def same(got, want, what):
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if len(got) != len(want) or diff:
            i = diff[0] if diff else None
            raise SystemExit(f"phase 6: {what}: {len(diff)} answers differ from the CPU "
                             f"sidecar's, first {diff[:5]}: "
                             f"{got[i] if i is not None else ''} vs {want[i] if i is not None else ''}; "
                             f"phase 3's statuses there {[verdicts[j].status for j in diff[:5]]}; "
                             f"stage cache {EXEC_CACHE.stats()}")

    def serve(sc, tag, n, conns=8, depth=32):
        """Phase 3's first ``n`` requests over ``conns`` connections x
        ``depth`` pipelined; logs what a client saw and what the batcher
        did. Requests after each connection's first group are the steady
        state (the first group is one burst of conns x depth)."""
        zero()
        torch.cuda.synchronize()
        m = mark(sc)
        s0 = EXEC_CACHE.stats()
        answers, lat, wall = drive(sc.port, payloads[:n], conns, depth)
        delay = sc.batcher.lane_delay_s[LANE_BULK] * 1e3
        launched = counts()
        windows, mean, step, host, dev, errs = since(sc, m)
        steady = [x for i, x in enumerate(lat) if i // conns >= depth]
        log(f"phase 6: {tag}: {n} requests at a {delay:g} ms batch delay, {n / wall:.1f} "
            f"req/s served ({wall:.3f} s), "
            f"request p50 {pct(lat, 0.5) * 1e3:.1f} ms p99 {pct(lat, 0.99) * 1e3:.1f} ms "
            f"(after each connection's first group: {len(steady)} requests, p50 "
            f"{pct(steady, 0.5) * 1e3:.1f} ms p99 {pct(steady, 0.99) * 1e3:.1f} ms), "
            f"{windows} windows of mean {mean:.1f} requests, step p50 {step:.1f} ms, batcher "
            f"host stage p50 {host:.2f} ms, device stage p50 {dev:.2f} ms, errors {errs}; "
            f"kernel launches {launched}; mode {sc.serving_mode()}; stage cache "
            f"{cache_delta(s0, EXEC_CACHE.stats())}, resident graphs {len(EXEC_CACHE)} [{card}]")
        if errs or sc.serving_mode() != "promoted":
            raise SystemExit(f"phase 6: {tag}: {errs} window errors, mode {sc.serving_mode()}")
        if host_twin_calls[0]:
            raise SystemExit(f"phase 6: {tag}: {host_twin_calls[0]} host-twin stage calls on the card")
        return answers, launched

    payloads = [request_bytes(r) for r in reqs]
    try:
        # 1. the sidecar on the card as deployed (the gpu-engine defaults:
        # 1 ms batch delay), from the cache server's crs-lite.
        sc, cold_s = start(config())
        engine = sc.tenants.engine_for(None)
        if engine.device.type != "cuda":
            raise SystemExit(f"phase 6: the sidecar's engine is on {engine.device}")
        log(f"phase 6: sidecar up on {engine.device}; start to the first device verdict "
            f"(promotion) {cold_s:.3f} s, the process's first sidecar [{card}]")

        # 2. phase 3's requests over sockets, 8 connections x 32 pipelined:
        # 768 of them as deployed (three groups per connection), then all
        # 4096 on a second sidecar started with a 100 ms batch delay
        # (--max-batch-delay-ms 100): at 1 ms a window holds what the ingest
        # loop parsed in 1 ms and costs about as much host time as a large
        # one, so the 4096 would take minutes.
        pinned, _launched = serve(sc, "finals off, as deployed", 768)
        stop(sc)
        # The second sidecar as the port's controller deploys it: a
        # driver.gpu Engine's rendered args through gpu-engine's
        # build_config (maxBatchDelayMs defaults to 100 there), with the
        # smoke's own knobs the controller does not render: the metrics
        # token (profile endpoint), the adaptive scheduler off (it keeps the
        # rendered delay), a fast rule poll and shadow for the reload, and
        # the package's own ext_proc transport (``auto`` would take grpcio,
        # which the card's machine has).
        rendered, container = controller_config(
            srv.port, key, host="127.0.0.1", poll_interval_s=0.2, metrics_auth_token=token,
            shadow_promote_windows=2, shadow_idle_check_s=0.05, compile_budget_s=600.0,
            adaptive_enabled=False, extproc_impl="native")
        sc, restart_s = start(rendered)
        log(f"phase 6: second sidecar from the controller's render ({container['name']}, limits "
            f"{container['resources']['limits']}, args {container['args']}): batch delay "
            f"{rendered.max_batch_delay_ms:g} ms, HTTP port {sc.port}, ext_proc port "
            f"{rendered.extproc_port} ({rendered.extproc_impl}); start to the first device "
            f"verdict {restart_s:.3f} s in the same process (compiled ruleset, kernels and "
            f"CUDA context already there) against {cold_s:.3f} s for the first [{card}]")
        if rendered.extproc_impl != "native" or not rendered.extproc_port:
            raise SystemExit(f"phase 6: ext_proc listener {rendered.extproc_impl}:{rendered.extproc_port}")
        engine = sc.tenants.engine_for(None)
        answers, launched = serve(sc, "finals off", len(payloads))
        if not all(launched[k] for k in scans):
            raise SystemExit(f"phase 6: a scan kernel was not launched on the sidecar path: {launched}")
        for k, n in launched.items():
            table[k]["sidecar_launches"] = n
        if pinned != answers[: len(pinned)]:
            raise SystemExit("phase 6: the 1 ms windows answer otherwise than the 100 ms windows")

        # 3. the same bytes to a CPU sidecar (threaded frontend); phase 3's
        # CPU engine serves it, so its value cache holds most values. A CPU
        # window costs seconds whatever its size, so 1024 connections (a
        # thread each there) fill windows of 1024: four windows in all.
        cpu_sc, _ = start(config(instance_key="default/cpu-reference", frontend="threaded",
                                 device="cpu", request_timeout_s=900.0, max_batch_size=1024,
                                 max_batch_delay_ms=2000.0, max_connections=4096),
                          engine=cpu_eng)
        t0 = time.perf_counter()
        m = mark(cpu_sc)
        want, _lat, _wall = drive(cpu_sc.port, payloads, 1024, 4)
        cpu_windows = since(cpu_sc, m)
        stop(cpu_sc)
        same(answers, want, "finals off")
        blocked = sum(a[0] != 200 for a in answers)
        moved = [i for i, (a, v) in enumerate(zip(answers, verdicts)) if a[0] != v.status]
        log(f"phase 6: {len(answers)} answers equal to the CPU sidecar's ({time.perf_counter() - t0:.1f} s, "
            f"{cpu_windows[0]} CPU windows of mean {cpu_windows[1]:.1f} requests, step p50 "
            f"{cpu_windows[2]:.0f} ms); "
            f"{blocked} blocked over HTTP against {sum(v.interrupted for v in verdicts)} in phase 3; "
            f"{len(moved)} requests answer otherwise than their phase-3 verdict, e.g. "
            f"{[(i, reqs[i].method, reqs[i].uri[:60], verdicts[i].status, answers[i][0]) for i in moved[:4]]}")

        # 4. again with the finals tier on, the value cache emptied so the
        # windows do the first pass's work.
        os.environ["CKO_PALLAS_FINALS"] = "1"
        vc = engine.value_cache
        if vc is not None:
            engine.value_cache = ValueHitCache(vc.packed_len, vc.max_bytes)
        answers_on, launched = serve(sc, "finals on", len(payloads))
        same(answers_on, want, "finals on")
        if not launched["cko_finals_match"]:
            raise SystemExit(f"phase 6: cko_finals_match did not launch with the tier on: {launched}")
        table["cko_finals_match"]["sidecar_launches"] = launched["cko_finals_match"]

        # 4b. 512 of the same requests through the native ext_proc listener,
        # 64 ExtProcClient connections: each answer equal to the HTTP one.
        zero()
        m = mark(sc)
        ext, lat, wall = drive_extproc(rendered.extproc_port, reqs[:512], 64)
        windows, mean, step, host, dev, errs = since(sc, m)
        ext_stats = sc.stats()["extproc"]
        log(f"phase 6: ext_proc ({rendered.extproc_impl}, finals on): 512 requests over 64 "
            f"connections, {512 / wall:.1f} req/s ({wall:.3f} s), request p50 "
            f"{pct(lat, 0.5) * 1e3:.1f} ms p99 {pct(lat, 0.99) * 1e3:.1f} ms, {windows} windows of "
            f"mean {mean:.1f} requests, step p50 {step:.1f} ms, host stage p50 {host:.2f} ms, device "
            f"stage p50 {dev:.2f} ms, errors {errs}; kernel launches {counts()}; "
            f"streams {ext_stats['streams_total']}, immediate {ext_stats['immediate_total']}, "
            f"continue {ext_stats['continue_total']} [{card}]")
        http = answers_on[:512]
        diff = [i for i, (a, b) in enumerate(zip(ext, http))
                if a[:3] != b[:3] or (a[0] != 200 and a[3] != b[3])]
        if diff or errs:
            raise SystemExit(f"phase 6: {len(diff)} ext_proc answers differ from HTTP, first "
                             f"{[(i, ext[i][:3], http[i][:3]) for i in diff[:4]]}; errors {errs}")
        if ext_stats["streams_total"] < 512 or not all(counts()[k] for k in scans):
            raise SystemExit(f"phase 6: ext_proc streams {ext_stats}, launches {counts()}")

        # 5. hot reload: crs-lite plus one phase-2 rule, through a shadowed
        # rollout on the same card.
        base = next(r for r, v in zip(reqs, verdicts)
                    if not v.interrupted and r.method == "GET" and not r.body)
        probe = [request_bytes(waf_mod.HttpRequest(uri="/?probe=ckochipsmokeprobe",
                                                   headers=list(base.headers)))]
        got = drive(sc.port, probe, 1, 1)[0][0]
        if got[0] != 200:
            raise SystemExit(f"phase 6: the reload probe is blocked before the reload: {got[:3]}")
        reloader = sc.tenants._reloaders[key]
        uuid0 = reloader.current_uuid
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m = mark(sc)
        misses0 = EXEC_CACHE.snapshot()[1]
        t0 = time.perf_counter()
        cache.put(key, rules + 'SecRule ARGS "@contains ckochipsmokeprobe" '
                  '"id:990001,phase:2,deny,status:403,t:none"\n')
        shadow = payloads[:64]
        while reloader.current_uuid == uuid0:
            if time.perf_counter() - t0 > 300:
                raise SystemExit(f"phase 6: the reload did not promote: {sc.rollout.stats()}")
            drive(sc.port, shadow, 8, 32)  # live windows the candidate shadows
        reload_s = time.perf_counter() - t0
        n, mean, step, host, dev, errs = since(sc, m)
        peak = torch.cuda.max_memory_allocated()
        got = drive(sc.port, probe, 1, 1)[0][0]
        rollout = sc.rollout.stats()
        log(f"phase 6: hot reload promoted in {reload_s:.3f} s (rollouts {rollout['promoted']} "
            f"promoted, {rollout['rolled_back']} rolled back, shadow {rollout['shadow']}); "
            f"{n} live windows meanwhile (mean {mean:.1f} requests) at step p50 {step:.1f} ms, "
            f"host stage p50 {host:.2f} ms, device stage p50 {dev:.2f} ms; device memory "
            f"{mem0 / 2**20:.1f} MiB before, peak {peak / 2**20:.1f} MiB with the candidate "
            f"[{card}]; stage cache misses meanwhile {EXEC_CACHE.snapshot()[1] - misses0}; "
            f"probe now {got[:3]}")
        if got[:3] != (403, "deny", "990001"):
            raise SystemExit(f"phase 6: the reloaded rule does not block its probe: {got[:3]}")
        if host_twin_calls[0]:
            raise SystemExit(f"phase 6: {host_twin_calls[0]} host-twin stage calls on the card")

        # 6. one injected device loss.
        os.environ["CKO_FAULT_DEVICE_LOST_N"] = "1"
        try:
            t0 = time.perf_counter()
            lost, _lat, _wall = drive(sc.port, payloads[:64], 8, 8)
            dl = sc.degraded.device_loss
            wait_for(lambda: dl.stats()["recoveries"] >= 1, 300, "the device re-init")
            wait_for(lambda: sc.serving_mode() == "promoted", 300, "promotion after the re-init")
            back_s = time.perf_counter() - t0
        finally:
            del os.environ["CKO_FAULT_DEVICE_LOST_N"]
        same(lost, want[:64], "device loss")
        log(f"phase 6: device loss answered by the host fallback, equal to the CPU; re-init "
            f"and promotion {back_s:.3f} s; {dl.stats()}; fallback requests "
            f"{sc.degraded.fallback_requests}")
        if dl.stats()["losses_total"] < 1:
            raise SystemExit("phase 6: the injected device loss was not seen")

        # 7. metrics and a profile taken while traffic flows.
        status, body = http_call(sc.port, "GET", "/waf/v1/metrics", token)
        text = body.decode()
        info = [ln for ln in text.splitlines() if ln.startswith("cko_build_info{")]
        want_info = (f'torch="{torch.__version__}"', f'cuda="{torch.version.cuda}"', 'platform="cuda"')
        if status != 200 or len(info) != 1 or not all(w in info[0] for w in want_info):
            raise SystemExit(f"phase 6: metrics {status}: build info {info}")
        for family in ("cko_compile_cache_hits_total", "cko_compile_cache_misses_total", "cko_tier_kind"):
            if f"# TYPE {family}" not in text:
                raise SystemExit(f"phase 6: /waf/v1/metrics lacks {family}")
        prof_dir = ROOT / "build" / "profile"
        for _ in range(4):  # the profiled window's stages: first sight, capture, then replays
            drive(sc.port, payloads[:8], 1, 8)
        status, body = http_call(sc.port, "POST", "/waf/v1/profile", token,
                                 json.dumps({"action": "start", "dir": str(prof_dir)}).encode())
        if status != 200:
            raise SystemExit(f"phase 6: profile start {status}: {body[:200]}")
        s0 = EXEC_CACHE.stats()
        drive(sc.port, payloads[:8], 1, 8)  # one window: the trace holds every op
        status, body = http_call(sc.port, "POST", "/waf/v1/profile", token,
                                 json.dumps({"action": "stop"}).encode())
        profiled = cache_delta(s0, EXEC_CACHE.stats())
        if status != 200:
            raise SystemExit(f"phase 6: profile stop {status}: {body[:200]}")
        trace = Path(json.loads(body)["trace"])
        text = trace.read_bytes()  # a window's trace is ~100 MB: count names, do not parse
        names = {}
        # Names are demangled: "(anonymous namespace)::dense_tier_kernel(...)".
        for m in re.finditer(rb'"name":\s*"[^"]*?(dense_tier_kernel|gather_tier_kernel|'
                             rb'flat_kernel|finals_kernel)', text):
            k = m.group(1).decode()
            names[k] = names.get(k, 0) + 1
        n_events = len(re.findall(rb'"ph":', text))
        # Device busy share: kernel time over the span from the first kernel
        # to the end of the last.
        spans = [(float(t), float(d)) for t, d in re.findall(
            rb'"cat":\s*"kernel",\s*"name":\s*"(?:[^"\\]|\\.)*",\s*"pid":\s*[^,]+,\s*"tid":'
            rb'\s*[^,]+,\s*"ts":\s*([0-9.]+),\s*"dur":\s*([0-9.]+)', text)]
        busy = (f"{sum(d for _t, d in spans) / 1e3:.3f} ms of "
                f"{(max(t + d for t, d in spans) - min(t for t, _d in spans)) / 1e3:.3f} ms "
                f"in {len(spans)} kernels" if spans else "not measured (no kernel event parsed)")
        log(f"phase 6: {info[0]}; profile trace {trace.name} ({len(text)} B, "
            f"{n_events} events) names {names}; the profiled window's stage cache {profiled}; "
            f"device busy {busy} [{card}]")
        missing = [k for k in ("dense_tier_kernel", "gather_tier_kernel", "flat_kernel") if k not in names]
        if missing:
            raise SystemExit(f"phase 6: the profile trace does not name {missing}")
        trace.unlink()
        log(f"phase 6: stage cache in this process {EXEC_CACHE.stats()}; resident graphs "
            f"{len(EXEC_CACHE)}, pool {EXEC_CACHE.pool_bytes() / 2**30:.2f} GiB; "
            f"host-twin stage calls {host_twin_calls[0]}")
        if EXEC_CACHE.bypasses:
            raise SystemExit(f"phase 6: {EXEC_CACHE.bypasses} stage calls bypassed: "
                             f"{EXEC_CACHE.bypassed()}")
    finally:
        for sc_ in running:
            sc_.stop()
        for name, real in real_twins.items():
            setattr(waf_mod.WafEngine, name, real)
        for var in ("CKO_VERDICT_CACHE_MAX", "CKO_LAZY_TIERS"):
            os.environ.pop(var, None)
        os.environ["CKO_PALLAS_FINALS"] = "1"


def conformance_phase(card, compiled, mods, table, cache, srv) -> None:
    """Phase 7: go-ftw conformance on the card. (a) the crs-lite corpus
    replayed in-process (every request stage in one batched window, the
    response-injection stages through ``evaluate_response``) must give the
    JAX package's result (``CRS_LITE_FAILED``); (b) the same batched window with the
    finals tier on must give (a)'s verdicts; (c) the mini corpus over HTTP
    against a sidecar on the card (rules from ``srv``, audit log matched)
    must pass or be ignored, with the passed and ignored sets of an
    in-process replay on the card."""
    import torch

    from coraza_kubernetes_operator_tpu_torch import ftw
    from coraza_kubernetes_operator_tpu_torch.engine import WafEngine
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE
    from coraza_kubernetes_operator_tpu_torch.ftw.loader import FTW_DIR
    from coraza_kubernetes_operator_tpu_torch.sidecar import SidecarConfig, TpuEngineSidecar

    s0, seen0 = EXEC_CACHE.stats(), len(EXEC_CACHE.bypassed())

    def zero():
        for m in mods.values():
            m.LAUNCHES = 0

    def counts():
        return {k: m.LAUNCHES for k, m in mods.items()}

    def vkey(v):
        return (v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)

    overrides = ftw.load_overrides(FTW_DIR / "ftw.yml")  # the ledger's JSON mirror
    tests, skipped = ftw.load_tests_report(FTW_DIR / "tests-crs-lite")
    n_stages = sum(len(t.stages) for t in tests)
    n_response = sum(s.response_status is not None for t in tests for s in t.stages)

    # (a) the crs-lite corpus in-process, finals tier off (the default).
    os.environ["CKO_PALLAS_FINALS"] = "0"
    t0 = time.perf_counter()
    engine = WafEngine(compiled)  # on the card
    build_s = time.perf_counter() - t0
    windows = []  # (requests, verdicts) of every evaluate the runner makes
    real_evaluate = engine.evaluate

    def recorded(reqs):
        got = real_evaluate(reqs)
        windows.append((reqs, got))
        return got

    engine.evaluate = recorded
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = ftw.FtwRunner(engine=engine, overrides=overrides).run(tests)
    result.skipped_files = skipped
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launched = counts()
    engine.evaluate = real_evaluate
    batch_reqs, batch_off = windows[0]
    log(f"phase 7a: crs-lite corpus in-process on {engine.device}: {len(tests)} tests, "
        f"{n_stages} stages ({len(batch_reqs)} request stages in one window, {n_response} "
        f"response-injection stages), {result.summary()['passed']} passed, ignored "
        f"{sorted(result.ignored)}, {len(result.failed)} failed, {len(skipped)} skipped files; "
        f"engine built in {build_s:.3f} s, replay {run_s:.3f} s; kernel launches {launched} [{card}]")
    if result.failed != CRS_LITE_FAILED or skipped or len(tests) != 326:
        raise SystemExit(f"phase 7a: {len(tests)} tests, skipped {skipped}, failures other than "
                         f"the reference's: {sorted(set(result.failed.items()) ^ set(CRS_LITE_FAILED.items()))}")
    if len(result.passed) != 326 - 1 - len(CRS_LITE_FAILED) or sorted(result.ignored) != ["920160-1"]:
        raise SystemExit(f"phase 7a: {len(result.passed)} passed, ignored {sorted(result.ignored)}")
    if not all(launched[k] for k in ("cko_scan_flat", "cko_scan_gather", "cko_scan_dense",
                                     "cko_chain_match")):
        raise SystemExit(f"phase 7a: a scan kernel or the chain kernel did not launch: {launched}")
    for k, n in launched.items():
        table[k]["ftw_launches"] = n

    # (b) the same batched request window with the finals tier on.
    os.environ["CKO_PALLAS_FINALS"] = "1"
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_on = engine.evaluate(batch_reqs)
    on_s = time.perf_counter() - t0
    launched = counts()
    diff = [i for i, (a, b) in enumerate(zip(batch_on, batch_off)) if vkey(a) != vkey(b)]
    log(f"phase 7b: the {len(batch_reqs)}-stage window with CKO_PALLAS_FINALS=1 in {on_s:.3f} s: "
        f"{len(diff)} verdicts differ from 7a's; kernel launches {launched} [{card}]")
    if diff or len(batch_on) != len(batch_off):
        raise SystemExit(f"phase 7b: {len(diff)} stage verdicts differ with the finals tier on, "
                         f"first {diff[:5]}")
    if not launched["cko_finals_match"]:
        raise SystemExit(f"phase 7b: cko_finals_match did not launch: {launched}")
    table["cko_finals_match"]["ftw_launches"] = launched["cko_finals_match"]

    # (c) the mini corpus over HTTP against a sidecar on the card.
    key = "default/ftw-mini"
    mini = "\n".join((FTW_DIR / "rules" / n).read_text() for n in ("base.conf", "crs-mini.conf"))
    cache.put(key, mini)
    audit = ROOT / "build" / "ftw" / "audit.log"
    audit.parent.mkdir(parents=True, exist_ok=True)
    audit.unlink(missing_ok=True)
    mini_tests = ftw.load_tests(FTW_DIR / "tests")
    if any(s.response_status is not None for t in mini_tests for s in t.stages):
        raise SystemExit("phase 7c: the mini corpus holds a response-injection stage")
    sc = TpuEngineSidecar(SidecarConfig(
        cache_base_url=f"http://127.0.0.1:{srv.port}", instance_key=key, poll_interval_s=0.2,
        host="127.0.0.1", port=0, audit_log=str(audit), audit_relevant_only=False,
        adaptive_enabled=False, compile_budget_s=600.0))
    t0 = time.perf_counter()
    sc.start()
    try:
        wait_for(lambda: sc.serving_mode() == "promoted", 300, "promotion", phase=7)
        up_s = time.perf_counter() - t0
        device = sc.tenants.engine_for(None).device
        t0 = time.perf_counter()
        http = ftw.FtwRunner(base_url=f"http://127.0.0.1:{sc.port}", audit_log_path=str(audit),
                             overrides=overrides).run(mini_tests)
        http_s = time.perf_counter() - t0
    finally:
        sc.stop()
    t0 = time.perf_counter()
    inproc = ftw.FtwRunner(engine=WafEngine(mini), overrides=overrides).run(mini_tests)
    inproc_s = time.perf_counter() - t0
    log(f"phase 7c: mini corpus ({len(mini_tests)} tests) over HTTP against a sidecar on {device} "
        f"(up in {up_s:.3f} s): {http.summary()} in {http_s:.3f} s; in-process on the card: "
        f"{inproc.summary()} in {inproc_s:.3f} s; audit log {audit.stat().st_size} B [{card}]")
    if not http.ok or device.type != "cuda":
        raise SystemExit(f"phase 7c: over HTTP on {device}: {http.summary()}")
    if sorted(http.passed) != sorted(inproc.passed) or http.ignored != inproc.ignored:
        raise SystemExit(f"phase 7c: HTTP {http.summary()} differs from in-process {inproc.summary()}")
    # Bypassed stages (a long bank's plain loop reads lengths back): each
    # key's stage, the signature's tensor shapes and the reason.
    bypassed = [(k[0], [a for a in k[1] if isinstance(a, tuple) and a[:1] == ("t",)], why)
                for k, why in EXEC_CACHE.bypassed()[seen0:]]
    log(f"phase 7: stage cache {cache_delta(s0, EXEC_CACHE.stats())}; bypassed keys "
        f"{bypassed}")


def sharded_phase(card, compiled, reqs, verdicts, p50_phase3, mods, table, n_windows) -> None:
    """Phase 8: the sharded engine on a one-rank NCCL group, mesh (1, 1):
    phase 3's 4096 requests must give phase 3's verdicts and launch
    ``cko_scan_dense``; then the p50 of fresh windows."""
    import socket

    import torch
    import torch.distributed as dist

    from coraza_kubernetes_operator_tpu_torch.corpus import synthetic_requests
    from coraza_kubernetes_operator_tpu_torch.models.waf_model import build_model
    from coraza_kubernetes_operator_tpu_torch.parallel import ShardedWafEngine, make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        # Device bytes the rank's engine holds, beside those of the
        # single-device model build_model lays out from the same rules.
        # Earlier phases' dead engines go first: their stage graphs would
        # otherwise be freed by a collection in the middle of a reading.
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sharded = ShardedWafEngine(compiled=compiled, mesh=make_mesh(1, 1))
        build_s = time.perf_counter() - t0
        rank_mib = (torch.cuda.memory_allocated() - mem0) / 2**20
        rank_peak_mib = (torch.cuda.max_memory_allocated() - mem0) / 2**20
        mem1 = torch.cuda.memory_allocated()
        full = build_model(compiled, device=sharded.device)
        torch.cuda.synchronize()
        full_mib = (torch.cuda.memory_allocated() - mem1) / 2**20
        del full
        log(f"phase 8: device memory: the rank's sharded engine {rank_mib:.2f} MiB (peak while "
            f"building {rank_peak_mib:.2f} MiB); build_model's single-device model "
            f"{full_mib:.2f} MiB [{card}]")
        model = sharded.model
        for m in mods.values():
            m.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded.evaluate(reqs)
        first_s = time.perf_counter() - t0
        launched = {k: m.LAUNCHES for k, m in mods.items()}
        log(f"phase 8: sharded engine on mesh (1, 1) over {dist.get_backend()} on {sharded.device} "
            f"built in {build_s:.3f} s: {len(model.banks)} DFA buckets (widths "
            f"{model.bucket_widths}, {sum(b.t256.numel() > 0 for b in model.banks)} with a dense "
            f"table), {len(model.segs)} segment blocks; first {len(reqs)}-request window "
            f"{first_s * 1e3:.1f} ms; kernel launches {launched} [{card}]")
        want = [(v.interrupted, v.status, v.rule_id) for v in verdicts]
        diff = [i for i, v in enumerate(got) if (v.interrupted, v.status, v.rule_id) != want[i]]
        if diff or len(got) != len(want):
            raise SystemExit(f"phase 8: {len(diff)} sharded verdicts differ from phase 3's, "
                             f"first {diff[:5]}")
        for k in ("cko_scan_dense", "cko_chain_match"):
            if not launched[k]:
                raise SystemExit(f"phase 8: {k} did not launch: {launched}")
            table[k]["sharded_launches"] = launched[k]
        walls = []
        for w in range(n_windows):
            window = synthetic_requests(4096, attack_ratio=0.3, seed=100 + w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(sharded.evaluate(window)) != len(window):
                raise SystemExit("phase 8: a window returned the wrong number of verdicts")
            walls.append(time.perf_counter() - t0)
        p50 = statistics.median(walls)
        log(f"phase 8: p50 sharded window {p50 * 1e3:.1f} ms over {n_windows} fresh windows "
            f"(phase 3's windows; phase 3 p50 {p50_phase3 * 1e3:.1f} ms in this run); windows ms "
            f"{[round(x * 1e3, 1) for x in walls]}; {sum(v.interrupted for v in got)} of the "
            f"4096 blocked, equal to phase 3 [{card}]")
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=5, help="timed windows after the first")
    ap.add_argument("--profile", type=Path, metavar="FILE",
                    help="write the profiled blob window's table by kernel to FILE")
    ap.add_argument("--probe-profiler", action="store_true",
                    help="time windows before and after torch.profiler sessions")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG} not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import torch.nn.functional as F

    from coraza_kubernetes_operator_tpu_torch import native
    from coraza_kubernetes_operator_tpu_torch.corpus import synthetic_requests
    from coraza_kubernetes_operator_tpu_torch.engine import WafEngine
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE
    from coraza_kubernetes_operator_tpu_torch.engine.request import HttpRequest, HttpResponse
    from coraza_kubernetes_operator_tpu_torch.ftw.corpus import load_ruleset_text
    from coraza_kubernetes_operator_tpu_torch.ops import (
        dfa, dfa_flat, dfa_gather, kernels, segment, segment_chain, segment_finals,
    )

    # -- phase 0: the card ---------------------------------------------------
    card = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    # One shared-memory lookup per lane per clock: the shared-memory pipe
    # serves 32 lanes (banks) per SM per clock.
    lookups_per_s = props.multi_processor_count * 32 * sm_clock_hz
    log(f"phase 0: card {card}; torch {torch.__version__}; cuda {torch.version.cuda}; "
        f"{props.multi_processor_count} SMs, max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    dev = torch.device("cuda")

    # -- phase 1: build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = kernels.build()
    log(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    lib = native.build_library()
    log(f"phase 1: built the native host runtime {lib.name} in {time.perf_counter() - t0:.3f} s")

    # -- phase 2: each kernel against its plain version -----------------------
    rules = load_ruleset_text()
    t0 = time.perf_counter()
    # Phase 3 drives the slice-1 path: the Python tensorize path.
    os.environ["CKO_NATIVE"] = "0"
    eng = WafEngine(rules)  # on the card: the default device
    del os.environ["CKO_NATIVE"]
    if eng.native_enabled:
        raise SystemExit("the phase-3 engine is on the native path")
    model = eng.model
    log(f"phase 2: crs-lite engine built on {eng.device} in {time.perf_counter() - t0:.3f} s: "
        f"{len(model.segs)} segment blocks, {len(model.flat_banks)} flat bins, "
        f"{len(model.gather_banks)} gather banks, {len(model.pre_banks)} prefilter banks")
    if not (model.flat_banks and model.gather_banks and model.pre_banks):
        raise SystemExit("crs-lite model lacks a bank kind of the main path")
    rng = np.random.default_rng(SEED)
    # Each kernel's own device time per launch is read by torch.profiler
    # after the timed windows (phase 5), so no profiler session runs
    # before them: (kernel, B, L, function making the cases, kernel event name, reps,
    # the table key that takes the SHAPES[0] reading).
    deferred = []

    def scan_case(name, banks, b, length, rng):
        """Per call: (kernel call, plain call, bytes moved, lookups). The
        bytes are what the function needs: each pipeline's rows once (on
        crs-lite's prefilter tier, six banks over six pipelines, that is
        once per bank), the tables and records once, and the output once."""
        if name in ("gather", "dense"):
            # All banks of the tier in one fused launch, one input per pipeline.
            tier = model.gather_tier if name == "gather" else model.pre_tier
            scan, plain = ((dfa_gather.scan_gather_tier, dfa_gather.scan_gather_tier_plain)
                           if name == "gather" else (dfa.scan_dense_tier, dfa.scan_dense_tier_plain))
            ins = [random_rows(rng, b, length) for _ in tier.pipelines]
            tens = [(torch.as_tensor(d, device=dev), torch.as_tensor(l, device=dev)) for d, l in ins]
            on = (True,) * len(tier.banks)
            # Per active byte: one table lookup per group (and, for gather,
            # one class lookup per bank).
            per_bank = 1 if name == "gather" else 0
            steps = sum(int(np.minimum(ins[slot][1], length).sum()) * (bk.n_groups + per_bank)
                        for bk, slot in zip(tier.banks, tier.pipe_slot))
            nbytes = (sum(d.nbytes + l.nbytes for d, l in ins) + 2 * tier.tab.numel()
                      + 4 * (tier.grp_info.numel() + sum(r.numel() for _base, r in tier.launches))
                      + tier.mend.numel() + tier.n_groups + b * tier.n_groups)
            if name == "gather":
                nbytes += tier.cmaps.numel()
            return [(lambda x=tens: scan(tier, x, on), lambda x=tens: plain(tier, x, on),
                     nbytes, steps)]
        cases = []
        for bank in banks:  # the flat bins
            pids = bank.pipeline_ids
            ins = {p: random_rows(rng, b, length) for p in pids}
            tens = {p: (torch.as_tensor(d, device=dev), torch.as_tensor(l, device=dev))
                    for p, (d, l) in ins.items()}
            steps = sum(int(np.minimum(ins[p][1], length).sum()) for p in bank.group_pipe)
            nbytes = sum(d.nbytes + l.nbytes for d, l in ins.values())
            lay, g = bank.layout, bank.n_groups
            cases.append((lambda bk=bank, x=tens: dfa_flat.scan_flat_bank(bk, x),
                          lambda bk=bank, x=tens: dfa_flat.scan_flat_xla(bk, x),
                          nbytes + lay.tab.numel() * 2 + lay.grp_info.numel() * 4
                          + lay.mend.numel() + g + b * g,
                          steps))
        return cases

    # (name, short, module, banks, source, replaces, device kernel name)
    kernel_defs = [
        ("cko_scan_flat", "flat", dfa_flat, model.flat_banks,
         f"{PKG}/csrc/dfa_scan.cu", "coraza_kubernetes_operator_tpu/ops/dfa_flat.py:439",
         "flat_kernel"),
        ("cko_scan_gather", "gather", dfa_gather, model.gather_banks,
         f"{PKG}/csrc/dfa_scan.cu", "coraza_kubernetes_operator_tpu/ops/dfa_gather_pallas.py:46",
         "gather_tier_kernel"),
        ("cko_scan_dense", "dense", dfa, model.pre_banks,
         f"{PKG}/csrc/dfa_scan.cu", "coraza_kubernetes_operator_tpu/ops/dfa_pallas.py:52",
         "dense_tier_kernel"),
    ]
    table = {}
    for kname, short, _mod, banks, src, replaces, dev_name in kernel_defs:
        for b, length in SHAPES:
            cases = scan_case(short, banks, b, length, rng)
            err = 0
            for kern, plain, _nb, _st in cases:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise SystemExit(f"{kname} B={b} L={length}: shape/dtype {got.shape} "
                                     f"{got.dtype} vs {want.shape} {want.dtype}")
                diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
                err = max(err, int(diff.max()))
                if err:
                    raise SystemExit(f"{kname} B={b} L={length}: {int((diff != 0).sum())} "
                                     "bits differ from the plain version")
            reps = 20 if length <= 64 else 5
            ms = cuda_ms(lambda: [c[0]() for c in cases], reps)
            plain_ms = cuda_ms(lambda: [c[1]() for c in cases], 2)
            deferred.append((kname, b, length, lambda s_=short, bk=banks, b=b, length=length:
                             scan_case(s_, bk, b, length, np.random.default_rng(SEED)),
                             dev_name, reps, "device_ms_per_launch"))
            nbytes = sum(c[2] for c in cases)
            lookups = sum(c[3] for c in cases)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, lookups / lookups_per_s * 1e3
            bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
            log(f"phase 2: {kname} B={b} L={length} launches={len(cases)}: bit-equal; "
                f"ms={ms:.4f} ({ms / len(cases):.4f} per launch) plain_ms={plain_ms:.3f} "
                f"bound_ms={bound_ms:.5f} ({bound_by}: {nbytes} B, {lookups} lookups) [{card}]")
            if (b, length) == SHAPES[0]:
                table[kname] = {
                    "name": kname, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    "launches_per_call": len(cases), "device_ms_per_launch": None,
                }

    # The finals kernel: every crs-lite segment block with finals columns,
    # its operands from the block's own chain program on seeded rows.
    fin_blocks = [i for i, s in enumerate(model.segs) if segment.finals_cols(s.spec)]
    log(f"phase 2: segment blocks with finals columns {fin_blocks}, columns "
        f"{[segment.finals_cols(model.segs[i].spec) for i in fin_blocks]}")

    def finals_cases(b, length, rng):
        """Per block: (kernel call, plain call, conv1d call, bytes moved,
        gated MACs, dense MACs)."""
        cases = []
        for i in fin_blocks:
            blk = model.segs[i]
            d, l = random_rows(rng, b, length)
            embed, suffix, lens, tables, q = segment.finals_inputs(
                blk.kernel, blk.spec, torch.as_tensor(d, device=dev), torch.as_tensor(l, device=dev),
                cache=blk.finals,
            )
            c, nf, w, ns = embed.shape[2], tables.nf, tables.w, suffix.shape[2]
            gj = segment_finals.reach(suffix, lens, tables, q)  # [T, Q, Gf]
            # MACs the function needs: every window score where the column's
            # group is reachable (the others cannot set a bit).
            per_group = gj.sum(dim=(0, 1), dtype=torch.int64)
            gated = int(per_group[tables.col_group.long()].sum()) * w * c
            # Bytes the function needs: the suffix bytes at positions 1 ..
            # len + 1 (reach reads no other), the embed positions of the
            # windows that start at a reachable position, lengths,
            # descriptors, the weights as the kernel reads them (bitplanes,
            # thresholds, column groups), and out.
            sfx_pos = int((lens.to(torch.int64) + 1).clamp(max=q - 1).sum())
            starts = gj.any(dim=2).to(torch.float32)[:, None]  # [T, 1, Q]
            windows = F.conv1d(F.pad(starts, (w - 1, w - 1)), torch.ones((1, 1, w), device=dev))
            emb_pos = int((windows > 0).sum())  # embed positions inside some window
            del gj
            nbytes = (emb_pos * c + sfx_pos * ns + 4 * b + tables.desc.numel() * 4
                      + tables.kbits.numel() * 8 + tables.thr.numel() * 4 + 4 * nf + b * nf)
            conv_w = tables.weights.reshape(w, c, nf).permute(2, 1, 0).to(torch.bfloat16).contiguous()
            conv_x = embed.permute(0, 2, 1).to(torch.bfloat16).contiguous()
            operands = (embed, suffix, lens, tables)
            cases.append((
                lambda a=operands, q=q: segment_finals.finals_match(*a, q=q),
                lambda a=operands, q=q: segment_finals.finals_match_plain(*a, q=q),
                lambda x=conv_x, k=conv_w: F.conv1d(x, k),
                nbytes, gated, b * q * nf * w * c,
            ))
        return cases

    for b, length in SHAPES:
        cases = finals_cases(b, length, rng)
        err = 0
        for kern, plain, *_ in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise SystemExit(f"cko_finals_match B={b} L={length}: shape/dtype {got.shape} "
                                 f"{got.dtype} vs {want.shape} {want.dtype}")
            diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
            err = max(err, int(diff.max()))
            if err:
                raise SystemExit(f"cko_finals_match B={b} L={length}: {int((diff != 0).sum())} "
                                 "bits differ from the plain version")
        reps = 10 if length <= 64 else 3
        ms = cuda_ms(lambda: [c[0]() for c in cases], reps)
        plain_ms = cuda_ms(lambda: [c[1]() for c in cases], 2)
        conv_ms = cuda_ms(lambda: [c[2]() for c in cases], reps)
        deferred.append(("cko_finals_match", b, length, lambda b=b, length=length:
                         finals_cases(b, length, np.random.default_rng(SEED)), "finals_kernel", reps,
                         "device_ms_per_launch"))
        nbytes = sum(c[3] for c in cases)
        gated = sum(c[4] for c in cases)
        dense = sum(c[5] for c in cases)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * gated / BF16_FLOP_PER_S * 1e3
        bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
        log(f"phase 2: cko_finals_match B={b} L={length} blocks={len(cases)}: bit-equal; "
            f"ms={ms:.4f} ({ms / len(cases):.4f} per launch) "
            f"plain_ms={plain_ms:.3f} conv1d_ms(conv part only)={conv_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by}: {nbytes} B, {gated} gated MACs; dense "
            f"{dense} MACs = {2 * dense / BF16_FLOP_PER_S * 1e3:.5f} ms) [{card}]")
        if (b, length) == SHAPES[0]:
            table["cko_finals_match"] = {
                "name": "cko_finals_match", "route": "cuda",
                "source": f"{PKG}/csrc/segment_finals.cu",
                "replaces": "coraza_kubernetes_operator_tpu/ops/segment_pallas.py:55",
                "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": conv_ms,
                "launches_per_call": len(cases), "device_ms_per_launch": None,
            }
        del cases
        torch.cuda.empty_cache()

    # The chain kernel: every crs-lite segment block, its operands from the
    # block's own conv on seeded rows (segment.chain_inputs).
    def chain_cases(b, length, rng, tier=False):
        """Per block: (kernel call, plain call, bytes needed, operations,
        finals tier on: the block has finals columns and ``tier``, the
        kernel's tile: rows, shared bytes, global scratch)."""
        cases = []
        for blk in model.segs:
            d, l = random_rows(rng, b, length)
            ins = segment.chain_inputs(blk.kernel, blk.spec, torch.as_tensor(d, device=dev),
                                       torch.as_tensor(l, device=dev), consts=blk.consts, finals_tier=tier)
            if ins is None:
                continue
            conv, d_, l_, tables, off, t_on = ins
            q = length + 2
            # Bytes the function needs: the conv output at positions p <=
            # len + 1 of each row (no chain reads a later one), the rows,
            # lengths and tables once, and the outputs once.
            live = int(np.minimum(l.astype(np.int64) + 2, q).sum()) * conv.shape[1]
            outs = b * (tables.n_bucket_cols + (0 if t_on else tables.nf)) + (b * q * tables.ns if t_on else 0)
            nbytes = 2 * live + d.nbytes + l.nbytes + sum(v.nbytes for v in tables.host.values()) + outs
            # Operations: a compare, shift and OR per conv element, and a few
            # (8) per position of each class-gap walk of each item.
            h = tables.host
            walks = sum(int(u[3]) * int((h["ops"][u[4] : u[4] + u[5], 0] == segment_chain.OP_GAPCLS).sum())
                        for u in h["units"])
            ops = 3 * live + 8 * b * q * walks
            operands = (conv, d_, l_, tables)
            plan = segment_chain.chain_plan(b, q, conv.shape[1], tables.ns, tables.ncls, tables.n_units)
            cases.append((
                lambda a=operands, o=off, t=t_on: segment_chain.chain_match(*a, off=o, tier=t),
                lambda a=operands, o=off, t=t_on: segment_chain.chain_match_plain(*a, off=o, tier=t),
                nbytes, ops, t_on, (plan.rows, plan.smem, bool(plan.scratch_words)),
            ))
        return cases

    for b, length in SHAPES:
        for tier in (False, True):
            cases = chain_cases(b, length, rng, tier)
            n0 = segment_chain.LAUNCHES
            for kern, plain, _nb, _ops, t_on, _plan in cases:
                (bh, sfx), (want, want_sfx) = kern(), plain()
                torch.cuda.synchronize()
                if not torch.equal(bh, want) or (t_on and not torch.equal(sfx, want_sfx)):
                    raise SystemExit(f"cko_chain_match B={b} L={length} finals tier {tier}: "
                                     f"{int((bh != want).sum())} hit bits differ from the plain version")
            per_call = segment_chain.LAUNCHES - n0
            if per_call != len(cases):
                raise SystemExit(f"cko_chain_match B={b} L={length} finals tier {tier}: {per_call} "
                                 f"launches for {len(cases)} blocks (one each expected)")
            reps = 10 if length <= 64 else 3
            ms = cuda_ms(lambda: [c[0]() for c in cases], reps)
            plain_ms = cuda_ms(lambda: [c[1]() for c in cases], 2)
            nbytes, ops = sum(c[2] for c in cases), sum(c[3] for c in cases)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / CUDA_CORE_OPS_PER_S * 1e3
            bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
            tag = "on" if tier else "off"
            log(f"phase 2: cko_chain_match B={b} L={length} finals tier {tag} "
                f"blocks={len(cases)} launches={per_call}: bit-equal; ms={ms:.4f} "
                f"({ms / per_call:.4f} per launch) plain_ms={plain_ms:.3f} bound_ms={bound_ms:.5f} "
                f"({bound_by}: {nbytes} B, {ops} operations); tiles per block (rows, shared bytes, "
                f"global scratch) {[c[5] for c in cases]} [{card}]")
            key = "device_ms_per_launch" + ("_finals_on" if tier else "")
            deferred.append(("cko_chain_match", b, length, lambda b=b, length=length, tier=tier:
                             chain_cases(b, length, np.random.default_rng(SEED), tier), "chain_kernel", reps,
                             key))
            if (b, length) == SHAPES[0] and not tier:
                table["cko_chain_match"] = {
                    "name": "cko_chain_match", "route": "cuda",
                    "source": f"{PKG}/csrc/segment_chain.cu",
                    "replaces": "coraza_kubernetes_operator_tpu/ops/segment.py:687",  # XLA-fused, no pallas_call
                    "launches": 0, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    "launches_per_call": per_call, "device_ms_per_launch": None,
                }
            elif (b, length) == SHAPES[0]:
                table["cko_chain_match"].update({
                    "ms_finals_on": ms, "plain_ms_finals_on": plain_ms, "bound_ms_finals_on": bound_ms,
                    "bound_by_finals_on": bound_by, "launches_per_call_finals_on": per_call,
                    "device_ms_per_launch_finals_on": None,
                })
            del cases
            torch.cuda.empty_cache()

    # The conv in front of the chain in two layouts: F.conv1d on the embed
    # as [T, C, Lp] (the port's; cuDNN transposes it to NHWC and back) and
    # F.conv2d on the embed's own [T, Lp, C] viewed as [T, C, 1, Lp]
    # channels-last. Same bits; CUDA-event times here, each layout's
    # kernels by part (conv, transposes) in phase 5.
    for b, length in SHAPES:
        convs = [conv_layouts(segment, blk, b, length, rng, dev) for blk in model.segs]
        for ncl, nhwc in convs:
            if not torch.equal(ncl().float(), nhwc().float()):
                raise SystemExit(f"conv layouts B={b} L={length}: the channels-last conv differs")
        reps = 5 if length <= 64 else 2
        times = [cuda_ms(lambda i=i: [c[i]() for c in convs], reps) for i in (0, 1)]
        log(f"phase 2: conv B={b} L={length} over {len(convs)} blocks: bit-equal; conv1d [T, C, Lp] "
            f"{times[0]:.4f} ms, conv2d channels-last {times[1]:.4f} ms [{card}]")
        del convs
        torch.cuda.empty_cache()

    # -- phase 3: the slice-1 path ---------------------------------------------
    reqs = synthetic_requests(4096, attack_ratio=0.3, seed=1)
    mods = {**{k: mod for k, _s, mod, *_ in kernel_defs}, "cko_finals_match": segment_finals,
            "cko_chain_match": segment_chain}
    p3_mods = {k: mod for k, mod in mods.items() if k != "cko_finals_match"}  # the tier is off
    n_pairs = max(1, args.windows // 2)
    for mod in p3_mods.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdicts = eng.evaluate(reqs)
    first_s = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in p3_mods.items()}
    log(f"phase 3: first window {first_s * 1e3:.1f} ms; kernel launches {launches}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the slice-1 path was not launched: {launches}")
    blocked = sum(v.interrupted for v in verdicts)
    if blocked < 1:
        raise SystemExit("no request of the window was blocked")
    t0 = time.perf_counter()
    cpu_eng = WafEngine(eng.compiled, device="cpu")
    cpu_verdicts = cpu_eng.evaluate(reqs)
    log(f"phase 3: CPU reference window {time.perf_counter() - t0:.1f} s")

    def key(v):
        return (v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)

    def differ(got, want, what):
        diff = [i for i, (a, c) in enumerate(zip(got, want)) if key(a) != key(c)]
        if len(got) != len(want) or diff:
            raise SystemExit(f"{what}: {len(diff)} verdicts differ, first {diff[:5]}")

    differ(verdicts, cpu_verdicts, "phase 3 against the CPU engine")
    log(f"phase 3: 4096 verdicts identical to the CPU engine; {blocked} blocked")

    # The stage graphs. From here on the engine's windows carry no value
    # cache, so a window and its eager twin do the same work under one
    # signature. The CPU-verified window first: its stages are captured
    # (prewarm), then it replays.
    eng.value_cache = None
    prewarm_windows("phase 3", card, eng, [reqs])
    r = timed_window(eng, lambda: eng.prepare(reqs), mods, eager=False)
    if r["cache"]["misses"] or not r["cache"]["hits"]:
        raise SystemExit(f"phase 3: the captured window did not only replay: {r['cache']}")
    if r["verdicts"] != [key(v) for v in cpu_verdicts]:
        raise SystemExit("phase 3: the replayed window's verdicts differ from the CPU engine's")
    log(f"phase 3: the same 4096 requests replayed through their stage graphs in "
        f"{r['wall'] * 1e3:.1f} ms: verdicts identical to the CPU engine; stage cache {r['cache']}; "
        f"launches {r['launches']}")
    windows3 = [synthetic_requests(4096, attack_ratio=0.3, seed=100 + w) for w in range(2 * n_pairs)]
    prewarm_windows("phase 3", card, eng, windows3)
    torch.cuda.reset_peak_memory_stats()
    p3 = eager_graph_pairs("phase 3", card, eng, windows3, eng.prepare, mods)
    p50 = p3["eager"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 3: p50 window eager {p50 * 1e3:.1f} ms ({4096 / p50:.0f} req/s), graph "
        f"{p3['graph'] * 1e3:.1f} ms ({4096 / p3['graph']:.0f} req/s), over {2 * n_pairs} fresh "
        f"windows each in eager/graph pairs (no value cache), peak device memory {peak:.2f} GiB; "
        f"resident graphs {len(EXEC_CACHE)}, pool {EXEC_CACHE.pool_bytes() / 2**30:.2f} GiB; "
        f"stage cache {EXEC_CACHE.stats()} [{card}]")
    if EXEC_CACHE.bypasses:
        raise SystemExit(f"phase 3: {EXEC_CACHE.bypasses} stage calls bypassed: {EXEC_CACHE.bypassed()}")

    # -- phase 4: the slice-2 path ---------------------------------------------
    os.environ["CKO_PALLAS_FINALS"] = "1"
    t0 = time.perf_counter()
    eng4 = WafEngine(eng.compiled)
    if not (eng4.native_enabled and eng4._native.tiered):
        raise SystemExit("the phase-4 engine is not on the native tiered path")
    log(f"phase 4: native engine built on {eng4.device} in {time.perf_counter() - t0:.3f} s")
    # The window's tiers (one matcher call each), from its tiering alone.
    tiers4, *_rest, lease = eng4._batch_tensors(reqs)
    tier_widths = [int(t[0].shape[1]) for t in tiers4]
    lease.release()
    for mod in mods.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inflight = eng4.prepare_blob(native.serialize_requests(reqs), len(reqs))
    verdicts4 = eng4.collect(inflight)
    first_s = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    for k, n in launches.items():
        table[k]["launches"] = n
    log(f"phase 4: first blob window {first_s * 1e3:.1f} ms (assemble "
        f"{inflight.assemble_s * 1e3:.1f} ms); {len(tier_widths)} tiers of widths {tier_widths}; "
        f"kernel launches {launches}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the slice-2 path was not launched: {launches}")
    for k in ("cko_scan_gather", "cko_scan_dense"):
        if launches[k] > len(tier_widths):
            raise SystemExit(f"{launches[k]} {k} launches for {len(tier_widths)} tiers")
    if not inflight.arena_lease._released:
        raise SystemExit("collect did not release the window's arena lease")
    differ(verdicts4, verdicts, "phase 4 against phase 3")
    log("phase 4: 4096 blob-window verdicts identical to phase 3's (and the CPU engine's)")

    eng4.value_cache = None  # as in phase 3's pairs
    blob0 = native.serialize_requests(reqs)
    prewarm_windows("phase 4", card, eng4, [reqs])
    r = timed_window(eng4, lambda: eng4.prepare_blob(blob0, len(reqs)), mods, eager=False)
    if r["cache"]["misses"] or not r["cache"]["hits"]:
        raise SystemExit(f"phase 4: the captured blob window did not only replay: {r['cache']}")
    if r["verdicts"] != [key(v) for v in verdicts]:
        raise SystemExit("phase 4: the replayed blob window's verdicts differ from phase 3's")
    log(f"phase 4: the same blob replayed through its stage graphs (finals on) in "
        f"{r['wall'] * 1e3:.1f} ms: verdicts identical to phase 3's; stage cache {r['cache']}; "
        f"launches {r['launches']}")
    p4 = {}
    for knob in ("1", "0"):
        os.environ["CKO_PALLAS_FINALS"] = knob
        tag = f"phase 4, finals {'on' if knob == '1' else 'off'}"
        ws = [(w, native.serialize_requests(w)) for w in (
            synthetic_requests(4096, attack_ratio=0.3, seed=200 + 2 * i + int(knob))
            for i in range(2 * n_pairs))]
        prewarm_windows(tag, card, eng4, [w for w, _b in ws])
        p4[knob] = eager_graph_pairs(tag, card, eng4, ws, lambda w: eng4.prepare_blob(w[1], len(w[0])),
                                     mods)
    os.environ["CKO_PALLAS_FINALS"] = "1"
    log(f"phase 4: p50 blob window finals on: eager {p4['1']['eager'] * 1e3:.1f} ms, graph "
        f"{p4['1']['graph'] * 1e3:.1f} ms; finals off: eager {p4['0']['eager'] * 1e3:.1f} ms, "
        f"graph {p4['0']['graph'] * 1e3:.1f} ms ({2 * n_pairs} fresh windows each, eager/graph "
        f"pairs, no value cache); resident graphs {len(EXEC_CACHE)}, pool "
        f"{EXEC_CACHE.pool_bytes() / 2**30:.2f} GiB; stage cache {EXEC_CACHE.stats()} [{card}]")
    if EXEC_CACHE.bypasses:
        raise SystemExit(f"phase 4: {EXEC_CACHE.bypasses} stage calls bypassed: {EXEC_CACHE.bypassed()}")

    t0 = time.perf_counter()
    sub = reqs[:512]
    differ(eng4.evaluate_phased(sub), cpu_eng.evaluate_phased(sub), "evaluate_phased")
    responses = [
        (HttpRequest(uri="/index.html"), HttpResponse(status=200, body=b"<html>ok</html>")),
        (HttpRequest(uri="/x?id=1"), HttpResponse(status=500, body=b"SQL syntax error near")),
        (HttpRequest(uri="/etc"), HttpResponse(status=200, headers=[("Content-Type", "text/plain")],
                                               body=b"daemon:x:1:1:daemon:/usr/sbin:/usr/sbin/nologin")),
    ]
    differ([eng4.evaluate_response(q, r) for q, r in responses],
           [cpu_eng.evaluate_response(q, r) for q, r in responses], "evaluate_response")
    differ(eng4.host_fallback.evaluate(sub), verdicts[:512], "host_fallback.evaluate")
    log(f"phase 4: evaluate_phased (512), evaluate_response ({len(responses)}) equal to the "
        f"CPU engine, host_fallback.evaluate (512) equal to the card in "
        f"{time.perf_counter() - t0:.1f} s")

    def probe(tag: str, seed: int, n: int = 3) -> None:
        """Fresh phase-3 windows and finals-off blob windows, in turns."""
        py, off = [], []
        os.environ["CKO_PALLAS_FINALS"] = "0"
        for w in range(n):
            for engine, walls_ in ((eng, py), (eng4, off)):
                window = synthetic_requests(4096, attack_ratio=0.3, seed=seed + 2 * w + (engine is eng4))
                blob = native.serialize_requests(window) if engine is eng4 else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inflight = engine.prepare_blob(blob, len(window)) if blob else engine.prepare(window)
                engine.collect(inflight)
                walls_.append(time.perf_counter() - t0)
        os.environ["CKO_PALLAS_FINALS"] = "1"
        log(f"probe {tag}: phase-3 windows ms {[round(x * 1e3, 1) for x in py]} (p50 "
            f"{statistics.median(py) * 1e3:.1f}), finals-off blob windows ms "
            f"{[round(x * 1e3, 1) for x in off]} (p50 {statistics.median(off) * 1e3:.1f}) [{card}]")

    if args.probe_profiler:
        from torch.profiler import ProfilerActivity, profile

        probe("before any profiler session", 300)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            pass
        probe("after one empty profiler session", 400)

    # -- phases 6 and 7: the sidecar, then go-ftw conformance, on the card ------
    from coraza_kubernetes_operator_tpu_torch.cache import RuleSetCache, RuleSetCacheServer

    cache = RuleSetCache()
    srv = RuleSetCacheServer(cache, host="127.0.0.1", port=0)
    srv.start()
    try:
        t0 = time.perf_counter()
        sidecar_phase(card, reqs, verdicts, cpu_eng, mods, table, cache, srv)
        log(f"phase 6: done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        conformance_phase(card, eng.compiled, mods, table, cache, srv)
        log(f"phase 7: done in {time.perf_counter() - t0:.1f} s")
    finally:
        srv.stop()

    # -- phase 8: the sharded engine on a one-rank NCCL mesh --------------------
    os.environ["CKO_PALLAS_FINALS"] = "0"  # as in phase 3, whose p50 it stands beside
    t0 = time.perf_counter()
    sharded_phase(card, eng.compiled, reqs, verdicts, p50, mods, table, 3)
    log(f"phase 8: done in {time.perf_counter() - t0:.1f} s")
    os.environ["CKO_PALLAS_FINALS"] = "1"

    # -- phase 5: each kernel's own device time per launch ----------------------
    for kname, b, length, build, dev_name, reps, key in deferred:
        cases = build()
        dev_ms, seen = device_ms_per_launch(lambda: [c[0]() for c in cases], dev_name, reps)
        log(f"phase 5: {kname} B={b} L={length}: {key}={dev_ms} ({seen} "
            f"{dev_name} events over {reps} reps of {len(cases)} calls) [{card}]")
        if (b, length) == SHAPES[0]:
            table[kname][key] = dev_ms
        del cases
        torch.cuda.empty_cache()
    for b, length in SHAPES:
        convs = [conv_layouts(segment, blk, b, length, np.random.default_rng(SEED), dev) for blk in model.segs]
        parts = [profiled_parts(lambda i=i: [c[i]() for c in convs]) for i in (0, 1)]
        log(f"phase 5: conv B={b} L={length} over {len(convs)} blocks, (launches, device ms) by "
            f"part: conv1d [T, C, Lp] {parts[0]}; conv2d channels-last {parts[1]} [{card}]")
        del convs
        torch.cuda.empty_cache()
    if args.probe_profiler:
        probe(f"after phase 5's {len(deferred)} profiler sessions", 500)

    # One profiled finals-on blob window: launches, device busy time, each
    # scan and finals kernel's events, and no [T, Q, Gf] stack of group rows.
    gfs = {t.gf for s_ in model.segs for t in s_.finals.values()} | {
        t.gf for s_ in eng4.model.segs for t in s_.finals.values()}
    qs = {w_ + 2 for w_ in tier_widths}
    with GroupRowStacks(gfs, qs) as control:  # the watch sees such a stack
        torch.stack([torch.zeros((8, min(qs)), dtype=torch.bool, device=dev)] * min(gfs), dim=-1)
    if control.count != 1:
        raise SystemExit("the stack watch does not see a [T, Q, Gf] stack")
    window = synthetic_requests(4096, attack_ratio=0.3, seed=999)
    blob = native.serialize_requests(window)
    with GroupRowStacks(gfs, qs) as watch:
        wall_ms, device_ms, n_launch, mine, events, parts = profiled_window(
            eng4, lambda: eng4.prepare_blob(blob, len(window)), eager=True)
    stacks = watch.count
    log(f"phase 4: profiled blob window (finals on, eager): {wall_ms:.1f} ms wall (profiler on), "
        f"device busy {device_ms:.3f} ms ({device_ms / wall_ms:.1%}) in "
        f"{n_launch} kernel launches; (launches, device ms) {mine}; by part {parts}; [T, Q, Gf] stacks of "
        f"group rows (Gf in {sorted(gfs)}, Q in {sorted(qs)}): {stacks}; resident graphs "
        f"{len(EXEC_CACHE)}, pool {EXEC_CACHE.pool_bytes()} B [{card}]")
    if stacks:
        raise SystemExit(f"the finals-on window built {stacks} [T, Q, Gf] stacks")
    report = events.table(sort_by="self_cuda_time_total", row_limit=40)
    log("\n".join(report.splitlines()[:25]))
    # The same window through its stage graphs, then with the finals tier
    # off, eager and replayed; then the Python path's window eager and
    # replayed: device busy and launches per window, the matcher by part.
    eng4.prewarm(window)
    g = profiled_window(eng4, lambda: eng4.prepare_blob(blob, len(window)), eager=False)
    log(f"phase 4: profiled blob window (finals on, graph): {g[0]:.1f} ms wall (profiler on), "
        f"device busy {g[1]:.3f} ms ({g[1] / g[0]:.1%}) in {g[2]} kernel launches; (launches, "
        f"device ms) {g[3]}; by part {g[5]}; resident graphs {len(EXEC_CACHE)}, pool "
        f"{EXEC_CACHE.pool_bytes()} B [{card}]")
    reports = {"finals on, eager": report, "finals on, graph": g[4].table(sort_by="self_cuda_time_total",
                                                                          row_limit=40)}
    log("\n".join(reports["finals on, graph"].splitlines()[:25]))
    if not all(g[3][k][0] for k in HAND_KERNELS):
        log(f"phase 4: the profiler does not name every hand kernel inside the replayed graphs: {g[3]}")
    os.environ["CKO_PALLAS_FINALS"] = "0"
    eng4.prewarm(window)
    for mode in ("eager", "graph"):
        w_ms, d_ms, n_l, mine4, ev4, parts4 = profiled_window(
            eng4, lambda: eng4.prepare_blob(blob, len(window)), eager=mode == "eager")
        log(f"phase 4: profiled blob window (finals off, {mode}): {w_ms:.1f} ms wall (profiler on), "
            f"device busy {d_ms:.3f} ms ({d_ms / w_ms:.1%}) in {n_l} kernel launches; (launches, "
            f"device ms) {mine4}; by part {parts4}; resident graphs {len(EXEC_CACHE)}, pool "
            f"{EXEC_CACHE.pool_bytes()} B [{card}]")
        reports[f"finals off, {mode}"] = ev4.table(sort_by="self_cuda_time_total", row_limit=40)
    window3 = synthetic_requests(4096, attack_ratio=0.3, seed=998)
    eng.prewarm(window3)
    for mode in ("eager", "graph"):
        w_ms, d_ms, n_l, mine3, _ev, parts3 = profiled_window(eng, lambda: eng.prepare(window3),
                                                              eager=mode == "eager")
        log(f"phase 3: profiled window ({mode}): {w_ms:.1f} ms wall (profiler on), device busy "
            f"{d_ms:.3f} ms ({d_ms / w_ms:.1%}) in {n_l} kernel launches; (launches, device ms) "
            f"{mine3}; by part {parts3}; resident graphs {len(EXEC_CACHE)}, pool {EXEC_CACHE.pool_bytes()} B [{card}]")
    os.environ["CKO_PALLAS_FINALS"] = "1"
    if args.profile:
        args.profile.parent.mkdir(parents=True, exist_ok=True)
        args.profile.write_text(f"{card}\n" + "".join(f"{k}\n{v}\n" for k, v in reports.items()))
    log(f"stage cache at the end {EXEC_CACHE.stats()}; resident graphs {len(EXEC_CACHE)}, pool "
        f"{EXEC_CACHE.pool_bytes() / 2**30:.2f} GiB; smoke {time.perf_counter() - T_START:.1f} s")

    out(json.dumps({"kernels": list(table.values())}))
    out(card)
    out(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
