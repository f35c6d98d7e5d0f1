"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. Libraries land in ``build/torch_kernels/`` at the
repository root, named by a hash of the sources, and are built at first
use: importing this module never needs ``nvcc`` or a card.

Launchers return ``cudaGetLastError()`` after the launch; ``check``
raises on anything but 0. Each wrapper counts its launches in its
module's ``LAUNCHES`` through ``book``, under ``COUNT_LOCK`` (several
host threads launch in the sidecar, and ``+=`` on a module global is not
atomic). A CUDA graph capture runs the wrappers without running a
kernel, and its replays run no Python: so while a thread captures
(``record_launches``) its bookings go to the capture's record, and each
replay books that record (``book_record``). A window's counts are then
the same whether its stages ran eagerly or replayed.

Every launcher is typed from the literal ``_ABI`` table below (the shape
of ``native/__init__.py``'s), which ``analysis/nativelint.py`` checks
against the ``extern "C"`` declarators in ``csrc/``: a call whose values
do not fit the table raises ``ctypes.ArgumentError``. Pointers and the
stream go through ``ctypes.c_void_p`` (a bare Python int would be cut to
32 bits), scalars as ``ctypes.c_int`` instances.

A launcher runs on the calling thread's current card (``cudaGetDevice``),
which need not be the card its tensors are on, so every launch happens
inside ``on_device``, which makes the tensors' card current.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# The launchers' C signatures. Tokens: ptr -> c_void_p (device pointers,
# the stream), int -> c_int, charp -> c_char_p (a NUL-terminated string),
# pipes -> ScanPipes by value. "ret" is the return token.
_ABI: dict = {
    "cko_scan_dense": {
        # pipes, B, L, Lt, tab, recs, grp_info, mend, always, on,
        # smem_tab_bytes, smem, n_recs, gmax, out, G, stream.
        "args": [
            "pipes", "int", "int", "int", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr",
            "int", "int", "int", "int", "ptr", "int", "ptr",
        ],
        "ret": "int",
    },
    "cko_scan_gather": {
        # As cko_scan_dense, with the class maps (cmaps) before on.
        "args": [
            "pipes", "int", "int", "int", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr",
            "int", "int", "int", "int", "ptr", "int", "ptr",
        ],
        "ret": "int",
    },
    "cko_scan_flat": {
        # pipes, B, L, Lt, R, tab, recs, grp_info, mend, always,
        # smem_tab_bytes, smem, n_recs, out, G, stream.
        "args": [
            "pipes", "int", "int", "int", "int", "ptr", "ptr", "ptr", "ptr", "ptr",
            "int", "int", "int", "ptr", "int", "ptr",
        ],
        "ret": "int",
    },
    "cko_finals_match": {
        # embed, suffix, lens, kbits, thr, desc, group, T, Lp, C, Q, NS, W,
        # Gf, Nf, QT, Dmax, smem, out, stream.
        "args": [
            "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr",
            "int", "int", "int", "int", "int", "int", "int", "int", "int", "int", "int",
            "ptr", "ptr",
        ],
        "ret": "int",
    },
    # Defined in each source: the text of a launcher's error code.
    "cko_error_string": {"args": ["int"], "ret": "charp"},
}

# Pipelines one launch reads (``kMaxPipes`` of ``csrc/dfa_scan.cu``).
MAX_PIPES = 8
PipePtrs = ctypes.c_void_p * MAX_PIPES


class ScanPipes(ctypes.Structure):
    """``ScanPipes`` of ``csrc/dfa_scan.cu``: per pipeline slot the base
    of its [B, L] bytes and of its [B] lengths, passed by value."""

    _fields_ = [("data", PipePtrs), ("lens", PipePtrs)]


# Token -> ctypes type.
_CTYPES: dict = {
    "ptr": ctypes.c_void_p,
    "int": ctypes.c_int,
    "charp": ctypes.c_char_p,
    "pipes": ScanPipes,
}

_LOCK = threading.Lock()
COUNT_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[str, object] = {}
# Per thread: the launch record of the capture it runs (None outside one)
# and the host syncs noted since ``watch_host_syncs`` began (None when
# nothing watches).
_THREAD = threading.local()


def book(module: str, n: int) -> None:
    """Count ``n`` launches in ``sys.modules[module].LAUNCHES``, or in the
    record of the capture this thread runs."""
    rec = getattr(_THREAD, "launches", None)
    if rec is not None:
        rec[module] = rec.get(module, 0) + n
        return
    with COUNT_LOCK:
        mod = sys.modules[module]
        mod.LAUNCHES += n


def book_record(rec: dict) -> None:
    """Book a capture's record: what one replay of its graph launched."""
    if not rec:
        return
    with COUNT_LOCK:
        for module, n in rec.items():
            mod = sys.modules[module]
            mod.LAUNCHES += n


@contextlib.contextmanager
def record_launches():
    """Inside, this thread's ``book`` calls fill the yielded dict (module
    name -> launches) instead of the counters."""
    prev = getattr(_THREAD, "launches", None)
    rec: dict[str, int] = {}
    _THREAD.launches = rec
    try:
        yield rec
    finally:
        _THREAD.launches = prev


def note_host_sync(reason: str) -> None:
    """Say that the running stage waits for the device from the host (a
    read-back it branches on). A CUDA graph cannot hold such a stage."""
    seen = getattr(_THREAD, "syncs", None)
    if seen is not None:
        seen.append(reason)


@contextlib.contextmanager
def watch_host_syncs():
    """Inside, this thread's ``note_host_sync`` reasons fill the yielded
    list."""
    prev = getattr(_THREAD, "syncs", None)
    seen: list[str] = []
    _THREAD.syncs = seen
    try:
        yield seen
    finally:
        _THREAD.syncs = prev


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def build() -> dict[str, Path]:
    """Compile every source that has no library for the current source
    hash, one ``nvcc`` per source, all started together; returns {source
    stem: library path}. ``nvcc`` writes its errors to stderr and a failed
    build raises."""
    with _LOCK:
        tag = _source_hash()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        libs = {src.stem: BUILD_DIR / f"lib{src.stem}-{tag}.so" for src in sources()}
        jobs = []
        for src in sources():
            if libs[src.stem].exists():
                continue
            tmp = libs[src.stem].with_suffix(f".so.tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs.append((subprocess.Popen(cmd), cmd, tmp, libs[src.stem]))
        failed = None
        for proc, cmd, tmp, lib in jobs:
            if proc.wait() != 0:
                failed = failed or subprocess.CalledProcessError(proc.returncode, cmd)
            else:
                os.replace(tmp, lib)
        if failed is not None:
            raise failed
        return libs


def bind(lib, name: str):
    """``lib``'s function ``name`` typed from ``_ABI``."""
    spec = _ABI[name]
    fn = getattr(lib, name)
    fn.argtypes = [_CTYPES[t] for t in spec["args"]]
    fn.restype = _CTYPES[spec["ret"]] if spec.get("ret") else None
    return fn


def function(stem: str, name: str):
    """The C launcher ``name`` from ``csrc/<stem>.cu``, built and loaded on
    first use, typed from ``_ABI``."""
    fn = _FUNCS.get(name)
    if fn is not None:
        return fn
    libs = build()
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(libs[stem]))
            bind(lib, "cko_error_string")
            _LIBS[stem] = lib
        fn = _FUNCS.setdefault(name, bind(lib, name))
    return fn


def check(rc: int, stem: str, name: str) -> None:
    if rc != 0:
        msg = _LIBS[stem].cko_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (null for None)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


@contextlib.contextmanager
def on_device(device):
    """Make ``device`` the calling thread's current card for the launches
    inside, and yield the handle of its current stream (taken inside, so it
    is that card's stream)."""
    import torch

    with torch.cuda.device(device):
        yield ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
