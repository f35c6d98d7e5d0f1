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
   block's own chain program (``ops/segment.py::finals_inputs``). Each
   kernel's output must be bit-equal to its plain version's on the card.
   Times come from CUDA events after warm-up around the wrappers' calls;
3. the slice-1 path: ``WafEngine(crs-lite).evaluate`` on a 4096-request
   window on the card (Python tensorize path, finals tier off), verdicts
   identical to the same engine on the CPU, at least one request blocked,
   every scan kernel's launch count non-zero; then the p50 window time
   over a few fresh windows;
4. the slice-2 path: the same 4096 requests as one blob through
   ``prepare_blob`` + ``collect`` on the native tiered path with
   ``CKO_PALLAS_FINALS=1``: verdicts equal to phase 3's, all four kernels
   launched, at most one fused gather launch and one fused dense launch
   per tier; the p50 window
   with the finals tier on and off (fresh windows, in turns) and the p50
   native assemble time; then ``evaluate_phased`` and
   ``evaluate_response`` against the CPU engine and
   ``host_fallback.evaluate`` against the card's verdicts;
5. after every timed window (no profiler session runs before them): each
   kernel's own device time per launch at phase 2's shapes, from one
   ``torch.profiler`` pass each (kernel events by name); then one
   profiled finals-on blob window (launches, device busy time, and no
   [T, Q, Gf] stack of per-group rows).

The last lines are the kernel table (one JSON object), the card's name
and power limit, and ``{"ok": true, "device": {...}}``. With no card, or
without the package beside this file, it exits non-zero and prints no
result. ``--profile FILE`` writes the profiled phase-4 window's
``torch.profiler`` table by kernel name to FILE. ``--probe-profiler``
asks whether a ``torch.profiler`` session slows the windows that follow
it: before phase 5 it times fresh phase-3 and finals-off blob windows,
opens and closes one empty profiler session, times them again, and once
more after phase 5's sessions.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "coraza_kubernetes_operator_tpu_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
SHAPES = ((12288, 64), (1024, 2048), (4096, 64))  # main-path tiers, then B = 4096
SEED = 20261016


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
    from coraza_kubernetes_operator_tpu_torch.engine import waf as waf_mod
    from coraza_kubernetes_operator_tpu_torch.engine.request import HttpRequest, HttpResponse
    from coraza_kubernetes_operator_tpu_torch.ftw.corpus import load_ruleset_text
    from coraza_kubernetes_operator_tpu_torch.ops import (
        dfa, dfa_flat, dfa_gather, kernels, segment, segment_finals,
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
    # before them: (kernel, B, L, function making the cases, kernel event name, reps).
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
                             dev_name, reps))
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
                         finals_cases(b, length, np.random.default_rng(SEED)), "finals_kernel", reps))
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

    # -- phase 3: the slice-1 path ---------------------------------------------
    reqs = synthetic_requests(4096, attack_ratio=0.3, seed=1)
    for _k, _s, mod, *_ in kernel_defs:
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdicts = eng.evaluate(reqs)
    first_s = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, _s, mod, *_ in kernel_defs}
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

    walls, host = [], []
    torch.cuda.reset_peak_memory_stats()
    for w in range(args.windows):
        window = synthetic_requests(4096, attack_ratio=0.3, seed=100 + w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inflight = eng.prepare(window)
        verdicts_w = eng.collect(inflight)
        walls.append(time.perf_counter() - t0)
        host.append(inflight.host_s)
        if len(verdicts_w) != len(window):
            raise SystemExit("window returned the wrong number of verdicts")
    p50 = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 3: p50 window {p50 * 1e3:.1f} ms ({4096 / p50:.0f} req/s) over "
        f"{args.windows} fresh windows, p50 prepare {statistics.median(host) * 1e3:.1f} ms, "
        f"peak device memory {peak:.2f} GiB; windows ms {[round(x * 1e3, 1) for x in walls]} "
        f"[{card}]")

    # -- phase 4: the slice-2 path ---------------------------------------------
    os.environ["CKO_PALLAS_FINALS"] = "1"
    t0 = time.perf_counter()
    eng4 = WafEngine(eng.compiled)
    if not (eng4.native_enabled and eng4._native.tiered):
        raise SystemExit("the phase-4 engine is not on the native tiered path")
    log(f"phase 4: native engine built on {eng4.device} in {time.perf_counter() - t0:.3f} s")
    mods = {**{k: mod for k, _s, mod, *_ in kernel_defs}, "cko_finals_match": segment_finals}
    # Count the window's tiers (one matcher call each) around the engine's
    # own call.
    tier_widths = []
    real_match = waf_mod.match_tier_packed

    def counted(model_, data, *a, **k):
        tier_widths.append(int(data.shape[1]))
        return real_match(model_, data, *a, **k)

    waf_mod.match_tier_packed = counted
    for mod in mods.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inflight = eng4.prepare_blob(native.serialize_requests(reqs), len(reqs))
    verdicts4 = eng4.collect(inflight)
    first_s = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    waf_mod.match_tier_packed = real_match
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

    walls = {"1": [], "0": []}
    assemble = []
    for w in range(args.windows):
        for knob in ("1", "0"):
            os.environ["CKO_PALLAS_FINALS"] = knob
            window = synthetic_requests(4096, attack_ratio=0.3, seed=200 + 2 * w + int(knob))
            blob = native.serialize_requests(window)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inflight = eng4.prepare_blob(blob, len(window))
            if len(eng4.collect(inflight)) != len(window):
                raise SystemExit("blob window returned the wrong number of verdicts")
            walls[knob].append(time.perf_counter() - t0)
            assemble.append(inflight.assemble_s)
    os.environ["CKO_PALLAS_FINALS"] = "1"
    p50_on, p50_off = statistics.median(walls["1"]), statistics.median(walls["0"])
    log(f"phase 4: p50 blob window finals on {p50_on * 1e3:.1f} ms, off {p50_off * 1e3:.1f} ms "
        f"over {args.windows} fresh windows each (in turns), p50 native assemble "
        f"{statistics.median(assemble) * 1e3:.2f} ms; on ms "
        f"{[round(x * 1e3, 1) for x in walls['1']]}, off ms "
        f"{[round(x * 1e3, 1) for x in walls['0']]} [{card}]")

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

    # -- phase 5: each kernel's own device time per launch ----------------------
    for kname, b, length, build, dev_name, reps in deferred:
        cases = build()
        dev_ms, seen = device_ms_per_launch(lambda: [c[0]() for c in cases], dev_name, reps)
        log(f"phase 5: {kname} B={b} L={length}: device_ms_per_launch={dev_ms} ({seen} "
            f"{dev_name} events over {reps} reps of {len(cases)} launches) [{card}]")
        if (b, length) == SHAPES[0]:
            table[kname]["device_ms_per_launch"] = dev_ms
        del cases
        torch.cuda.empty_cache()
    if args.probe_profiler:
        probe(f"after phase 5's {len(deferred)} profiler sessions", 500)

    # One profiled finals-on blob window: launches, device busy time, each
    # scan and finals kernel's events, and no [T, Q, Gf] stack of group rows.
    from torch.profiler import ProfilerActivity, profile

    gfs = {t.gf for s_ in model.segs for t in s_.finals.values()} | {
        t.gf for s_ in eng4.model.segs for t in s_.finals.values()}
    qs = {w_ + 2 for w_ in tier_widths}
    with GroupRowStacks(gfs, qs) as control:  # the watch sees such a stack
        torch.stack([torch.zeros((8, min(qs)), dtype=torch.bool, device=dev)] * min(gfs), dim=-1)
    if control.count != 1:
        raise SystemExit("the stack watch does not see a [T, Q, Gf] stack")
    window = synthetic_requests(4096, attack_ratio=0.3, seed=999)
    blob = native.serialize_requests(window)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            GroupRowStacks(gfs, qs) as watch:
        t0 = time.perf_counter()
        inflight = eng4.prepare_blob(blob, len(window))
        eng4.collect(inflight)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Kernel events only: an aten op's self device time repeats its kernels'.
    kernel_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernel_events) / 1e3
    n_launch = sum(e.count for e in kernel_events)
    mine = {name: (sum(e.count for e in kernel_events if name in e.key),
                   sum(e.self_device_time_total for e in kernel_events if name in e.key) / 1e3)
            for name in ("finals_kernel", "gather_tier_kernel", "dense_tier_kernel", "flat_kernel")}
    stacks = watch.count
    log(f"phase 4: profiled blob window (finals on): {wall_ms:.1f} ms wall (profiler on), "
        f"assemble {inflight.assemble_s * 1e3:.1f} ms, device busy {device_ms:.3f} ms in "
        f"{n_launch} kernel launches; (launches, device ms) {mine}; [T, Q, Gf] stacks of "
        f"group rows (Gf in {sorted(gfs)}, Q in {sorted(qs)}): {stacks} [{card}]")
    if stacks:
        raise SystemExit(f"the finals-on window built {stacks} [T, Q, Gf] stacks")
    report = events.table(sort_by="self_cuda_time_total", row_limit=40)
    log("\n".join(report.splitlines()[:25]))
    if args.profile:
        args.profile.parent.mkdir(parents=True, exist_ok=True)
        args.profile.write_text(f"{card}\n{report}\n")

    out(json.dumps({"kernels": list(table.values())}))
    out(card)
    out(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
