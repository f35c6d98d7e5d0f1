"""Device selection for the port's entry points, and the driver-API
timing events the engine brackets its stages with."""

from __future__ import annotations

import ctypes
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, else raise.
    The CPU is used only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class StageEvents:
    """Timing CUDA events and stage-graph launches through the CUDA driver
    API (``libcuda``'s ``cuEventRecord``, ``cuGraphLaunch`` and
    ``cuEventElapsedTime`` through ``ctypes.PyDLL``), which keep the GIL.
    ``torch.cuda.Event.record`` and ``CUDAGraph.replay`` give it up, and
    among the sidecar's threads the caller then waits up to a switch
    interval (5 ms) to take it back: the thread stalls, and an end event
    recorded after such a wait lands late on the card. A launch that keeps
    the GIL also never overlaps a call that holds it, such as
    ``torch.profiler``'s stop: a traced process hung with its stop and a
    ``CUDAGraph.replay`` under way at once. The price: while a call here
    blocks in the driver, no other Python thread runs. Events are pooled:
    ``release`` hands them back once read. A failing call raises."""

    def __init__(self):
        self._lib = None
        self._free: list[int] = []
        self._lock = threading.Lock()

    def _cu(self):
        if self._lib is None:
            lib = ctypes.PyDLL("libcuda.so.1")
            vp = ctypes.c_void_p
            for name, args in (("cuEventCreate", [ctypes.POINTER(vp), ctypes.c_uint]),
                               ("cuEventRecord", [vp, vp]),
                               ("cuGraphLaunch", [vp, vp]),
                               ("cuEventElapsedTime", [ctypes.POINTER(ctypes.c_float), vp, vp])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            self._lib = lib
        return self._lib

    @staticmethod
    def _check(name: str, err: int) -> None:
        if err:
            raise RuntimeError(f"{name} failed: CUresult {err}")

    def record(self, stream: int) -> int:
        """A pooled event recorded now on ``stream`` (a ``cuda_stream``
        handle); the caller's thread must have the card's context current,
        as any thread that has run work on it does."""
        cu = self._cu()
        with self._lock:
            ev = self._free.pop() if self._free else None
        if ev is None:
            handle = ctypes.c_void_p()
            self._check("cuEventCreate", cu.cuEventCreate(ctypes.byref(handle), 0))
            ev = handle.value
        self._check("cuEventRecord", cu.cuEventRecord(ev, stream))
        return ev

    def launch(self, exec_handle: int, stream: int) -> None:
        """A captured graph's replay on ``stream``: ``exec_handle`` is its
        ``raw_cuda_graph_exec()``, read once at capture. Stage graphs draw
        no random numbers, so ``CUDAGraph.replay``'s generator bookkeeping
        has nothing to do here."""
        self._check("cuGraphLaunch", self._cu().cuGraphLaunch(exec_handle, stream))

    def elapsed_s(self, start: int, end: int) -> float:
        """Seconds from ``start`` to ``end``, both complete (else raises)."""
        ms = ctypes.c_float()
        err = self._cu().cuEventElapsedTime(ctypes.byref(ms), start, end)
        if err == _NOT_READY:
            raise RuntimeError("cuEventElapsedTime: an event has not run")
        self._check("cuEventElapsedTime", err)
        return ms.value / 1e3

    def release(self, events) -> None:
        with self._lock:
            self._free.extend(events)


_NOT_READY = 600  # CUDA_ERROR_NOT_READY

STAGE_EVENTS = StageEvents()
