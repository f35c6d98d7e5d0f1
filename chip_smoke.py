#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold every kernel to its
plain PyTorch version.

Run from the repository root: ``python3 chip_smoke.py``. Phases (any
failure exits non-zero; no phase is caught):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build every kernel from ``coraza_kubernetes_operator_tpu_torch/csrc``
   with ``nvcc``;
2. one phase per kernel: the crs-lite banks of the main path (the flat
   bin, the dfa-hot gather banks, the prefilter banks) on seeded random
   bytes at the main path's tier shapes (B x L = 12288 x 64, 1024 x 2048)
   and at B = 4096; the kernel's output must be bit-equal to the plain
   version's on the card. Times come from CUDA events after warm-up;
3. the main path: ``WafEngine(crs-lite).evaluate`` on a 4096-request
   window on the card, verdicts identical to the same engine on the CPU,
   at least one request blocked, every kernel's launch count non-zero;
   then the p50 window time over a few fresh windows.

The last lines are the kernel table (one JSON object), the card's name
and power limit, and ``{"ok": true, "device": {...}}``. With no card, or
without the package beside this file, it exits non-zero and prints no
result. ``--profile FILE`` adds a ``torch.profiler`` breakdown of one
window by kernel name, written to FILE.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "coraza_kubernetes_operator_tpu_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
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
                    help="profile one window by kernel; write the table to FILE")
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

    from coraza_kubernetes_operator_tpu_torch.corpus import synthetic_requests
    from coraza_kubernetes_operator_tpu_torch.engine import WafEngine
    from coraza_kubernetes_operator_tpu_torch.ftw.corpus import load_ruleset_text
    from coraza_kubernetes_operator_tpu_torch.ops import dfa, dfa_flat, dfa_gather, kernels

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

    # -- phase 2: each kernel against its plain version -----------------------
    rules = load_ruleset_text()
    t0 = time.perf_counter()
    eng = WafEngine(rules)  # on the card: the default device
    model = eng.model
    log(f"phase 2: crs-lite engine built on {eng.device} in {time.perf_counter() - t0:.3f} s: "
        f"{len(model.segs)} segment blocks, {len(model.flat_banks)} flat bins, "
        f"{len(model.gather_banks)} gather banks, {len(model.pre_banks)} prefilter banks")
    if not (model.flat_banks and model.gather_banks and model.pre_banks):
        raise SystemExit("crs-lite model lacks a bank kind of the main path")
    rng = np.random.default_rng(SEED)

    def scan_case(name, banks):
        """Per bank: (kernel call, plain call, bytes moved, lookups)."""
        cases = []
        for bank in banks:
            if name == "flat":
                pids = bank.pipeline_ids
                ins = {p: random_rows(rng, b, length) for p in pids}
                tens = {p: (torch.as_tensor(d, device=dev), torch.as_tensor(l, device=dev))
                        for p, (d, l) in ins.items()}
                steps = sum(int(np.minimum(ins[p][1], length).sum()) for p in bank.group_pipe)
                nbytes = sum(d.nbytes + l.nbytes for d, l in ins.values())
                kt, g = bank.kt, bank.n_groups
                cases.append((lambda bk=bank, x=tens: dfa_flat.scan_flat_bank(bk, x),
                              lambda bk=bank, x=tens: dfa_flat.scan_flat_xla(bk, x),
                              nbytes + kt.tab.numel() * 2 + kt.mend.numel() + b * g,
                              steps))
                continue
            d, l = random_rows(rng, b, length)
            dt, lt = torch.as_tensor(d, device=dev), torch.as_tensor(l, device=dev)
            g = bank.n_groups
            # Per active byte: one table lookup per group; a gather bank's
            # joint class map is shared by its groups, so one class lookup.
            steps = int(np.minimum(l, length).sum()) * (g + 1 if name == "gather" else g)
            nbytes = d.nbytes + l.nbytes + bank.kt.tab.numel() * 2 + bank.kt.mend.numel() + b * g
            if name == "gather":
                cases.append((lambda bk=bank, x=dt, y=lt: dfa_gather.scan_gather_bank(bk, x, y),
                              lambda bk=bank, x=dt, y=lt: dfa_gather.scan_gather_bank_jnp(bk, x, y),
                              nbytes + 256, steps))
            else:
                cases.append((lambda bk=bank, x=dt, y=lt: dfa.scan_dfa_bank(bk, x, y),
                              lambda bk=bank, x=dt, y=lt: dfa.scan_dfa_bank_take(bk, x, y),
                              nbytes, steps))
        return cases

    kernel_defs = [
        ("cko_scan_flat", "flat", dfa_flat, model.flat_banks,
         f"{PKG}/csrc/dfa_scan.cu", "coraza_kubernetes_operator_tpu/ops/dfa_flat.py:439"),
        ("cko_scan_gather", "gather", dfa_gather, model.gather_banks,
         f"{PKG}/csrc/dfa_scan.cu", "coraza_kubernetes_operator_tpu/ops/dfa_gather_pallas.py:46"),
        ("cko_scan_dense", "dense", dfa, model.pre_banks,
         f"{PKG}/csrc/dfa_scan.cu", "coraza_kubernetes_operator_tpu/ops/dfa_pallas.py:52"),
    ]
    table = {}
    for kname, short, _mod, banks, src, replaces in kernel_defs:
        for b, length in SHAPES:
            cases = scan_case(short, banks)
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
            nbytes = sum(c[2] for c in cases)
            lookups = sum(c[3] for c in cases)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, lookups / lookups_per_s * 1e3
            bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
            log(f"phase 2: {kname} B={b} L={length} banks={len(cases)}: bit-equal; "
                f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.5f} ({bound_by}: "
                f"{nbytes} B, {lookups} lookups) [{card}]")
            if (b, length) == SHAPES[0]:
                table[kname] = {
                    "name": kname, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                }

    # -- phase 3: the main path ------------------------------------------------
    reqs = synthetic_requests(4096, attack_ratio=0.3, seed=1)
    for _k, _s, mod, *_ in kernel_defs:
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdicts = eng.evaluate(reqs)
    first_s = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, _s, mod, *_ in kernel_defs}
    for k, n in launches.items():
        table[k]["launches"] = n
    log(f"phase 3: first window {first_s * 1e3:.1f} ms; kernel launches {launches}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the main path was not launched: {launches}")
    blocked = sum(v.interrupted for v in verdicts)
    if blocked < 1:
        raise SystemExit("no request of the window was blocked")
    t0 = time.perf_counter()
    cpu_verdicts = WafEngine(rules, device="cpu").evaluate(reqs)
    log(f"phase 3: CPU reference window {time.perf_counter() - t0:.1f} s")

    def key(v):
        return (v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)

    diff = [i for i, (a, c) in enumerate(zip(verdicts, cpu_verdicts)) if key(a) != key(c)]
    if len(cpu_verdicts) != len(verdicts) or diff:
        raise SystemExit(f"{len(diff)} verdicts differ from the CPU engine, first {diff[:5]}")
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

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        window = synthetic_requests(4096, attack_ratio=0.3, seed=999)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.evaluate(window)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        # Kernel events only: an aten op's self device time repeats its kernels'.
        kernel_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernel_events) / 1e3
        launches = sum(e.count for e in kernel_events)
        report = events.table(sort_by="self_cuda_time_total", row_limit=40)
        args.profile.parent.mkdir(parents=True, exist_ok=True)
        args.profile.write_text(f"{card}\n{report}\n")
        log(f"phase 3: profiled window: {wall_ms:.1f} ms wall (profiler on), device busy "
            f"{device_ms:.1f} ms in {launches} kernel launches [{card}]")
        log("\n".join(report.splitlines()[:25]))

    out(json.dumps({"kernels": list(table.values())}))
    out(card)
    out(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
