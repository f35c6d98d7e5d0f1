"""The device trace of a steady slice of the window (``--trace 1`` runs).

``torch.profiler`` (CUPTI) records every kernel on the card for the last
``SLICE_S`` seconds of the window but half a second, or less where a graph
capture cuts it short (``profile_slice``); this module turns the kernel
intervals into device busy time (their union), the time of each part of the
matcher (``part_of``, a frozen copy of ``chip_smoke.py``'s), the longest
device operations and the longest idle gaps, each named by the CUDA runtime
call that issued the work ending it.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

SLICE_S = 3.0


def part_of(key: str) -> str | None:
    """The part of the matcher a kernel belongs to: the chain kernel, the
    conv's layout transposes (cuDNN's NCHW <-> NHWC kernels and tensor
    transforms), the conv itself (cuDNN's other kernels), the finals kernel
    or a DFA scan kernel; None for the rest."""
    if "chain_kernel" in key:
        return "chain"
    if "finals" in key:
        return "finals"
    if any(k in key for k in ("flat_kernel", "gather_tier_kernel", "dense_tier_kernel")):
        return "scan"
    if any(k in key for k in ("nchwToNhwc", "nhwcToNchw", "tensorTransform")):
        return "conv transposes"
    if any(k in key for k in ("cudnn", "fprop", "implicit_convolve")):
        return "conv"
    return None


class _YieldingLock:
    """Stands in for the program's capture lock while a slice is traced:
    a thread that asks for it sets ``wanted``, which ends the slice at
    once, and then waits for the real lock as it would have. ``asking``
    counts the threads still waiting; ``waits`` keeps how long each waited."""

    def __init__(self, real, wanted):
        self.real, self.wanted, self.waits, self.asking = real, wanted, [], 0
        self._count = threading.Lock()

    def acquire(self, *args, **kwargs):
        t = time.monotonic()
        with self._count:
            self.asking += 1
        self.wanted.set()
        try:
            return self.real.acquire(*args, **kwargs)
        finally:
            with self._count:
                self.asking -= 1
            self.waits.append(time.monotonic() - t)

    def settle(self, timeout: float = 30.0) -> None:
        """Wait until every thread that asked has had the real lock, so
        that ``waits`` holds each of them."""
        end = time.monotonic() + timeout
        while self.asking and time.monotonic() < end:
            time.sleep(0.001)

    def release(self):
        self.real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def profile_slice(length: float, owner=None, attr: str = "_capture_lock",
                  min_s: float = 0.5) -> dict:
    """Trace up to ``length`` seconds with CUPTI; returns the device
    intervals (kernels, copies, sets), the CUDA runtime calls, the slice's
    host times and how the slice went.

    CUPTI tracing while another thread captured a CUDA graph hung two
    traced runs of six, so no capture runs while the slice is traced: the
    program's capture lock (``owner.<attr>``, private) is held, and a
    thread that asks for it ends the slice at once (``cut_by_capture``
    counts such cuts). The capture then waits only for the profiler to
    stop (``longest_capture_wait_s``): a longer stall would trip the
    sidecar's window deadline, 1 s at the least, and send the window to
    its host fallback. The slice starts only while no capture is waiting.
    A slice cut within ``min_s`` is dropped and traced once more, in a
    second session, for what is left of ``length`` (the one run that
    resumed a slice in sessions after each of several cuts lost a stream's
    verdict, cause not found, so there is no third). Without the lock,
    the slice runs unguarded and says so (``guarded``). The trace is read
    from its exported JSON, which stays linear in its size."""
    real = getattr(owner, attr, None) if owner is not None else None
    wanted, proxy = threading.Event(), None
    if real is not None:
        proxy = _YieldingLock(real, wanted)
        setattr(owner, attr, proxy)
    t_end, cuts, got = time.monotonic() + length, 0, None
    try:
        for _session in range(2):
            if real is not None:
                _take(real, proxy, wanted)
            try:
                prof, t0, t1 = _record(max(0.0, t_end - time.monotonic()), wanted)
            finally:
                if real is not None:
                    real.release()
            got = (prof, t0, t1)
            if not wanted.is_set():
                break
            cuts += 1
            if t1 - t0 >= min_s or t_end - time.monotonic() < min_s:
                break
    finally:
        if proxy is not None:
            setattr(owner, attr, real)
            proxy.settle()
    return dict(_read(*got), guarded=real is not None, cut_by_capture=cuts,
                longest_capture_wait_s=max(proxy.waits, default=0.0) if proxy else 0.0)


def _take(real, proxy, wanted) -> None:
    """Take the real capture lock at a moment when no capture asks for it."""
    while True:
        proxy.settle()
        wanted.clear()
        real.acquire()
        if not wanted.is_set():
            return
        real.release()


def _record(length: float, wanted):
    """A profiler session of ``length`` seconds, or until ``wanted`` is set."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        t0 = time.monotonic()
        wanted.wait(timeout=length)
        torch.cuda.synchronize()
        t1 = time.monotonic()
    finally:
        prof.stop()
    return prof, t0, t1


def _read(prof, t0: float, t1: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    device, runtime = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(iv)
        elif cat == "cuda_runtime":
            runtime.append(iv)
    return {"t0": t0, "t1": t1, "window_s": t1 - t0, "kernels": device, "host": runtime}


def summarize(prof: dict) -> dict:
    """busy_s, per-part device seconds, the top device operations and idle
    gaps (each at most 10, seconds as measured)."""
    ks = sorted(prof["kernels"])
    busy_us, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e, _name in ks:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict[str, float] = {}
    parts: dict[str, float] = {}
    for s, e, name in ks:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        p = part_of(name)
        if p:
            parts[p] = parts.get(p, 0.0) + (e - s) / 1e6
    host = sorted(prof["host"])
    named = []
    for length, g0, g1 in sorted(gaps, reverse=True)[:10]:
        # The CUDA runtime call that issued the work ending the gap: what the
        # host was doing when the device went idle again.
        before = [h for h in host if h[0] <= g1]
        label = max(before)[2] if before else "host (no CUDA call traced)"
        named.append([label, length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": prof["window_s"], "parts": parts, "n_kernels": len(ks),
            "device_ops": [[n, s] for n, s in top], "idle_gaps": named}
