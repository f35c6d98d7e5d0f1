"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. Libraries land in ``build/torch_kernels/`` at the
repository root, named by a hash of the sources, and are built at first
use: importing this module never needs ``nvcc`` or a card.

Launchers return ``cudaGetLastError()`` after the launch; ``check``
raises on anything but 0. Each wrapper counts its launches in its
module's ``LAUNCHES`` under ``COUNT_LOCK`` (several host threads launch
in the sidecar, and ``+=`` on a module global is not atomic). Pointers and the stream go through
``ctypes.c_void_p`` (a bare Python int would be cut to 32 bits).

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
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
COUNT_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[str, object] = {}


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


def function(stem: str, name: str, argtypes: list):
    """The C launcher ``name`` from ``csrc/<stem>.cu``, built and loaded on
    first use, with its argument types set."""
    fn = _FUNCS.get(name)
    if fn is not None:
        return fn
    libs = build()
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(libs[stem]))
            lib.cko_error_string.argtypes = [ctypes.c_int]
            lib.cko_error_string.restype = ctypes.c_char_p
            _LIBS[stem] = lib
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
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
