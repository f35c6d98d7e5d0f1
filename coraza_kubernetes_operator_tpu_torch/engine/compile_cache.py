"""Shape-signature ledger (port of ``engine/compile_cache.py``).

PyTorch runs eagerly, so there is no executable to compile, cache or
warm ahead of its first run: a window at a new shape simply runs, and
its first run pays what first use costs (the caching allocator grows its
pools, cuDNN picks a convolution algorithm for the shape). What the
reference's cache tells an operator still holds, though: whether traffic
keeps arriving at shapes this process has not run before. So the port
keeps the reference's counters and its persistent-directory wiring, and
nothing else:

1. **Signatures** (:func:`batch_signature`): the model's layout (its
   tensors' shapes and dtypes and its static structure; the host-side
   planning metadata ``block_kinds``/``block_cost`` is left out) plus the
   window's tier shapes, masks, cached-row shapes, numvals shape and
   phase bound. Two rulesets with one bucketed layout share a signature.
2. **Counters** (:class:`ExecutableCache` / ``EXEC_CACHE``): every window
   dispatch counts a hit (its signature ran before in this process) or a
   miss (its first run). Counting never waits for the device.
   ``compile_s`` is the seconds ``WafEngine.prewarm`` spent running
   warm-up windows. These back the ``cko_compile_cache_*`` metrics.
3. **Persistent artefacts** (:func:`configure_persistent_cache`): the
   directory that the ``nvcc`` kernel libraries and the native runtime
   are built into, from ``CKO_COMPILE_CACHE_DIR``, so a cold *process*
   finds them built.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from pathlib import Path

import numpy as np
import torch

from ..models.waf_model import WafModel
from ..utils import get_logger

log = get_logger("engine.compile_cache")

CACHE_DIR_ENV = "CKO_COMPILE_CACHE_DIR"

_configured_dir: list[str] = []
_configure_lock = threading.Lock()

# Host-side planning metadata: never part of a model's layout signature.
_HOST_META = frozenset({"block_kinds", "block_cost"})


def configure_persistent_cache(cache_dir: str | None = None) -> str | None:
    """Build the ``nvcc`` kernel libraries into ``<dir>/torch_kernels``
    and the native host runtime into ``<dir>/native``, with ``dir`` the
    argument or ``$CKO_COMPILE_CACHE_DIR``. Both are keyed by a hash of
    their sources, so a warm directory skips the builds. Idempotent;
    returns the directory in effect, or None when unset (``"0"``
    disables: the repository's ``build/`` stays in use)."""
    d = cache_dir if cache_dir is not None else os.environ.get(CACHE_DIR_ENV, "")
    if not d or d == "0":
        return _configured_dir[0] if _configured_dir else None
    d = os.path.abspath(d)
    with _configure_lock:
        if _configured_dir and _configured_dir[0] == d:
            return d
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as err:  # never let cache wiring break serving
            log.error("persistent build cache unavailable", err, dir=d)
            return None
        from .. import native
        from ..ops import kernels

        kernels.BUILD_DIR = Path(d) / "torch_kernels"
        native.BUILD_DIR = Path(d) / "native"
        _configured_dir[:] = [d]
    log.info("persistent build cache enabled", dir=d)
    return d


def _aval(x):
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype).removeprefix("torch."))
    if isinstance(x, np.ndarray):
        return ("t", x.shape, x.dtype.name)
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if isinstance(x, (tuple, list)):
        return tuple(_aval(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _aval(getattr(x, f.name)) for f in dataclasses.fields(x)
        )
    if isinstance(x, dict):
        return None  # per-device caches (SegmentBlock.finals)
    return type(x).__name__


def model_layout(model: WafModel) -> tuple:
    """A model's layout signature: its fields' shapes, dtypes and static
    values, digested once per model object (a full layout holds hundreds
    of entries)."""
    sig = model.__dict__.get("_cko_layout")
    if sig is None:
        full = tuple(
            (f.name, _aval(getattr(model, f.name)))
            for f in dataclasses.fields(model)
            if f.name not in _HOST_META
        )
        sig = (type(model).__name__, hashlib.sha256(repr(full).encode()).hexdigest())
        model.__dict__["_cko_layout"] = sig
    return sig


def batch_signature(model: WafModel, tiers, numvals, masks, cached, max_phase: int) -> tuple:
    """Hashable shape signature of one tiered window: the model's layout,
    per tier (unique rows x width, pair rows, mask), the cached-row
    shapes, the numvals shape and the phase bound."""
    return (
        model_layout(model),
        tuple((tuple(t[0].shape), int(t[2].shape[0]), m) for t, m in zip(tiers, masks)),
        None if cached is None else tuple(None if c is None else tuple(c.shape) for c in cached),
        tuple(numvals.shape),
        max_phase,
    )


class ExecutableCache:
    """Process-wide hit/miss counters over window shape signatures."""

    # The reference's surface also reports trace seconds, calls that fell
    # back from a rejected compiled executable, and compiles in flight.
    # The port traces, compiles and warms nothing, so these stay 0.
    trace_s = 0.0
    bypasses = 0
    inflight = 0

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: set[tuple] = set()
        self.hits = 0
        self.misses = 0
        # Seconds WafEngine.prewarm spent running warm-up windows.
        self.compile_s = 0.0

    def dispatch(self, key: tuple) -> bool:
        """Count one window dispatch: a hit when ``key`` ran before in this
        process, else a miss. Returns True for a miss."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                return False
            self._entries.add(key)
            self.misses += 1
            n = len(self._entries)
        log.info("new window signature", entries=n)
        return True

    def resident(self, key: tuple) -> bool:
        """Whether ``key`` ran before in this process (counts nothing)."""
        with self._lock:
            return key in self._entries

    def record_warm(self, key: tuple, seconds: float) -> None:
        """Book a prewarm window's seconds and mark ``key`` resident (a miss
        when it was not: a window that dropped rows ran under another
        signature)."""
        with self._lock:
            self.compile_s += seconds
            if key not in self._entries:
                self._entries.add(key)
                self.misses += 1

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "compile_s": round(self.compile_s, 3),
                "trace_s": self.trace_s,
                "bypasses": self.bypasses,
                "inflight": self.inflight,
                "persistent_dir": _configured_dir[0] if _configured_dir else None,
            }

    def snapshot(self) -> tuple[int, int, float]:
        """(hits, misses, compile_s) — for delta reporting."""
        with self._lock:
            return (self.hits, self.misses, self.compile_s)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# Process-wide singleton: tenants, reloads and the promotion probe share
# it, as they share the first-use state it stands for.
EXEC_CACHE = ExecutableCache()
