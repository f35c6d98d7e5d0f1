"""Per-stage executables (port of ``engine/compile_cache.py``): one CUDA
graph per (stage, signature).

The reference runs every window stage (each tier's matcher,
``match_tier_packed``, then the post stage, ``eval_post_tiered``) through
``EXEC_CACHE.call``, which compiles each (stage, signature) once and from
then on calls one compiled executable. Its counterpart here is a
``torch.cuda.CUDAGraph``: the stage's Python issues its ops (tens of
thousands of small kernels for a 4096-request matcher tier) once, while
the graph is captured, and a later window of that signature replays
them with no Python and one launch from the host.

1. **Keys** (:meth:`ExecutableCache.key_for`): the stage function's name,
   its arguments' signatures (a model's layout digest, each tensor's
   shape and dtype, the ``cached`` rows' shapes or None per tier: padded
   to the tier's pair rows, ``stage_specs``), its
   static arguments (the kind mask, the phase bound) and
   ``CKO_PALLAS_FINALS``, which is read per call and changes the matcher's
   program. :func:`batch_signature` is a window's tuple of stage keys.
2. **Entries**, per model (the first argument of every stage): a key's
   first sight runs the stage eagerly (a miss). Its second sight runs it
   once more eagerly in the calling thread (so the thread's cuBLAS and
   cuDNN state and the kernels' first-launch set-up exist before the
   capture, and that run serves the call), then captures the stage on a
   side stream over the entry's static input buffers (a miss;
   ``trace_s`` is the capture pass, ``compile_s`` the graph's
   instantiation); nothing runs on that side stream but captures. Every
   later sight copies the call's inputs into those buffers, replays, and
   clones the outputs out (a hit), since the
   depth-2 pipeline still holds one window's outputs while the next
   window of the same signature replays. A one-off signature so never
   pays for a capture. The reference compiles at first sight.
   ``warm`` makes the eager run and the capture without serving a
   window (prewarm, a rollout's candidate).
3. **Bypasses**: a stage that waits for the device from the host inside
   (``ops/kernels.py::note_host_sync``: the plain DFA loop of a long bank
   without a dense table) cannot be captured; its second eager run finds
   that and the key stays eager. So does a key whose capture raised. Each
   such call counts in ``bypasses``, logged once per key.
4. **Lifetime**: a graph holds raw pointers into its model's tensors, so
   a model's entries live on the model (``model.__dict__``) and die with
   it: a hot reload or ``WafEngine.reinit_device`` leaves no graph that
   reads freed memory, and no entry keeps a retired model alive. A
   model's graphs share one memory pool, so one graph's intermediates may
   overlap another's outputs: each replay's copy-in, replay and clone-out
   go onto the stream with no other replay of the model between them
   (threads of the sidecar's lanes replay at once). At most
   ``MAX_GRAPHS`` stay resident per model: the
   least recently used goes, and its key's next sight captures again.
   Another model of the same layout has entries of its own (the
   reference shares one executable across rulesets of one layout).
5. **Launch counts**: a capture books no kernel launch (it runs none);
   it records what it launched, and each replay books that record
   (``ops/kernels.py``), so a window counts the same launches either way.
   **Timing**: ``call``'s ``timer``, a context manager, wraps the
   stage's device work as the host issues it in one go: a first sight's,
   a capture's or a bypass's eager run, or a replay's graph launch (the
   engine's records a CUDA event on either side). A replay launches its
   graph through the driver API with the GIL held
   (``utils/device.py::STAGE_EVENTS``), from the executable handle read
   at capture.
6. **Persistent artefacts** (:func:`configure_persistent_cache`): the
   directory that the ``nvcc`` kernel libraries and the native runtime
   are built into, from ``CKO_COMPILE_CACHE_DIR``, so a cold *process*
   finds them built.

On the CPU there is no graph: an entry's "capture" runs the stage over
its static buffers and a "replay" runs it again over them after the
copy-in, so the copy-in, copy-out and counting run in the CPU tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time
import weakref
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from ..models.waf_model import WafModel, eval_post_tiered, match_tier_packed
from ..ops import kernels
from ..ops.segment import finals_tier_requested
from ..utils import get_logger
from ..utils.device import STAGE_EVENTS

log = get_logger("engine.compile_cache")

CACHE_DIR_ENV = "CKO_COMPILE_CACHE_DIR"

_configured_dir: list[str] = []
_configure_lock = threading.Lock()

# Host-side planning metadata: never part of a model's layout signature.
_HOST_META = frozenset({"block_kinds", "block_cost", "narrow_blocks"})

# Graphs resident per model. A window holds one matcher graph per tier
# (one to five) and one post graph; a model that serves the Python path,
# the blob path and sidecar windows of every size from one request (an
# idle lane closes its window at once) to a backlog sees on the order of
# a hundred signatures, and a bound below that evicts and recaptures
# through the whole run. The graphs share their model's pool, so the
# bound limits the graph executables and their static buffers, not the
# pool's peak.
MAX_GRAPHS = 256
# Keys remembered per model (seen once, or holding a graph).
MAX_ENTRIES = 8 * MAX_GRAPHS


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
    if isinstance(x, WafModel):
        return model_layout(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _aval(getattr(x, f.name)) for f in dataclasses.fields(x)
        )
    if isinstance(x, dict):
        return None  # per-device caches (SegmentBlock.finals, .consts)
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


def stage_specs(model: WafModel, tiers, numvals, masks, cached, max_phase: int):
    """One tiered window's stages as ``(label, fn, args, statics, dyn)``:
    one matcher per tier, then the post stage, on the window's host
    arrays. The post stage's hit rows are zero placeholders of the
    matchers' output shape: only shapes enter a key, and ``warm`` captures
    the program a real window replays."""
    g = int(model.e_lg.shape[0])
    pb = (g + 7) // 8
    match = [
        (f"match:{t[0].shape[0]}x{t[0].shape[1]}", match_tier_packed,
         (model, t[0], t[1], t[6], t[7]), {"mask": m}, {})
        for t, m in zip(tiers, masks)
    ]
    hits = tuple(np.zeros((t[0].shape[0], pb), dtype=np.uint8) for t in tiers)
    pairs = tuple(tuple(t[i] for i in (2, 3, 4, 5, 8)) for t in tiers)
    post = ("post", eval_post_tiered, (model, hits, pairs, numvals),
            {"max_phase": max_phase}, {"cached": _cached_in_pairs(cached, tiers)})
    return match + [post]


def _cached_in_pairs(cached, tiers):
    """Each tier's value-cache rows padded to its pair rows' bucket (a
    tier never has more cached unique rows than pairs). The post stage's
    key then holds no shape of its own for them: it no longer moves with
    the cache's hit ratio as the cache fills, nor splits windows of one
    pairs bucket into several by how many of their rows were cached.
    The padding rows are zero and no pair's uid reaches them."""
    if cached is None:
        return None
    out = []
    for c, t in zip(cached, tiers):
        p = t[5].shape[0]
        if c is None or c.shape[0] >= p:
            out.append(c)
        else:
            full = np.zeros((p,) + c.shape[1:], dtype=c.dtype)
            full[: c.shape[0]] = c
            out.append(full)
    return tuple(out)


def batch_signature(model: WafModel, tiers, numvals, masks, cached, max_phase: int) -> tuple:
    """Hashable signature of one tiered window: its stages' keys (one per
    tier's matcher, then the post stage's)."""
    return tuple(
        ExecutableCache.key_for(fn, args, statics, dyn)
        for _label, fn, args, statics, dyn in stage_specs(
            model, tiers, numvals, masks, cached, max_phase
        )
    )


def _leaves(x, out: list) -> list:
    """The tensors of ``x`` (nested tuples and lists), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    return out


def _rebuild(x, it):
    """``x`` with each tensor replaced by the next of ``it``."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if isinstance(x, tuple):
        return tuple(_rebuild(v, it) for v in x)
    if isinstance(x, list):
        return [_rebuild(v, it) for v in x]
    return x


class _Entry:
    """One (stage, signature) of one model: seen, then captured."""

    def __init__(self, label: str):
        self.label = label
        # Serialises a capture and each replay's copy-in, replay and
        # copy-out: the static buffers are one window's at a time.
        self.lock = threading.Lock()
        self.graph = None  # torch.cuda.CUDAGraph, or _HOST on the CPU
        self.inputs: list = []  # static input buffers, argument order
        self.outputs: list = []  # static outputs the graph writes
        self.out_tree = None  # the stage's return value over self.outputs
        self.launches: dict = {}  # kernel launches one replay makes
        self.bypass: str | None = None  # why this key stays eager
        self.exec_handle: int | None = None  # the graph's executable (on the card)

    def drop(self) -> None:
        self.graph, self.inputs, self.outputs, self.out_tree = None, [], [], None
        self.launches, self.exec_handle = {}, None


_HOST = "host"  # an entry "captured" on the CPU: replays rerun the stage


_UNTIMED = contextlib.nullcontext()  # ``call``'s timer when nothing is timed


class _Table:
    """A model's entries, least recently used first, and the graph pool
    per device that its graphs share."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self.pools: dict = {}
        # The model's graphs share a pool: one graph's intermediates may lie
        # where another keeps its outputs. So a replay's copy-in, replay and
        # clone-out are enqueued with no other replay of the model between
        # them (the stream runs them in that order).
        self.replay_lock = threading.Lock()

    def lookup(self, key: tuple, label: str) -> tuple[_Entry, bool]:
        """(entry, whether this is the key's first sight)."""
        with self.lock:
            entry = self.entries.get(key)
            if entry is not None:
                self.entries.move_to_end(key)
                return entry, False
            entry = self.entries[key] = _Entry(label)
            return entry, True

    def pool(self, dev):
        with self.lock:
            if dev not in self.pools:
                self.pools[dev] = torch.cuda.graph_pool_handle()
            return self.pools[dev]

    def graphs(self) -> int:
        with self.lock:
            return sum(e.graph is not None for e in self.entries.values())

    def trim(self) -> None:
        """Evict past ``MAX_GRAPHS`` graphs and ``MAX_ENTRIES`` keys, least
        recently used first. An entry's lock is taken only after the
        table's is released, so a replay in flight finishes first."""
        with self.lock:
            while len(self.entries) > MAX_ENTRIES:
                self.entries.popitem(last=False)
            held = [e for e in self.entries.values() if e.graph is not None]
            victims = held[: max(0, len(held) - MAX_GRAPHS)]
        for entry in victims:
            with entry.lock:
                entry.drop()

    def clear(self) -> None:
        with self.lock:
            self.entries.clear()


class ExecutableCache:
    """Process-wide counters over the per-model stage graphs."""

    def __init__(self):
        self._lock = threading.Lock()
        # torch allows one capture at a time in a process.
        self._capture_lock = threading.Lock()
        self._tables: dict[int, _Table] = {}
        self._streams: dict = {}
        self.hits = 0  # replays
        self.misses = 0  # first sights and captures
        self.captures = 0
        self.compile_s = 0.0  # graph instantiation
        self.trace_s = 0.0  # capture passes
        self.bypasses = 0  # calls run eagerly because their key cannot be captured
        self._bypassed: dict[tuple, str] = {}
        self.inflight = 0  # captures running

    # -- keys and tables ------------------------------------------------------

    @staticmethod
    def key_for(fn, args: tuple, statics: dict, dyn: dict) -> tuple:
        return (
            getattr(fn, "__name__", None) or str(fn),
            _aval(args),
            _aval(dyn.get("cached")),
            tuple(sorted(statics.items())),
            finals_tier_requested(),
        )

    def _table(self, owner) -> _Table:
        table = owner.__dict__.get("_cko_graphs")
        if table is None:
            with self._lock:
                table = owner.__dict__.get("_cko_graphs")
                if table is None:
                    table = owner.__dict__["_cko_graphs"] = _Table()
                    self._tables[id(table)] = table
                    # The owner's death drops its graphs (and their pool).
                    weakref.finalize(owner, self._forget, id(table))
        return table

    def _forget(self, table_id: int) -> None:
        with self._lock:
            self._tables.pop(table_id, None)

    def release(self, owner) -> None:
        """Drop ``owner``'s entries now (``WafEngine.reinit_device``)."""
        table = owner.__dict__.get("_cko_graphs")
        if table is not None:
            table.clear()

    # -- core -----------------------------------------------------------------

    def call(self, fn, args: tuple, statics: dict, dyn: dict, timer=_UNTIMED):
        """``fn(*args, **statics, **dyn)`` through the key's entry on
        ``args[0]``: eager at first sight, captured at the second, replayed
        after. Hits count only after a replay; a key that cannot be
        captured runs eagerly, counted in ``bypasses``. ``timer`` wraps
        the call's device work (module docstring, 5)."""
        key = self.key_for(fn, args, statics, dyn)
        table = self._table(args[0])
        entry, first = table.lookup(key, _label(fn, args))
        if first:
            with self._lock:
                self.misses += 1
            with timer:
                return fn(*args, **statics, **dyn)
        out = None  # stays None when the key is known to stay eager
        with entry.lock:
            if entry.bypass is None and entry.graph is not None:
                with table.replay_lock:
                    out = self._replay(entry, fn, args, statics, dyn, timer)
                with self._lock:
                    self.hits += 1
                return out
            if entry.bypass is None:
                # Second sight. When the capture fails, its eager run
                # has served this call all the same.
                with timer:
                    out = self._mint(entry, table, key, fn, args, statics, dyn)
            bypass = entry.bypass
        if bypass is None:
            table.trim()
            return out
        self._count_bypass(key, bypass, entry.label)
        if out is not None:
            return out
        with timer:
            return fn(*args, **statics, **dyn)

    def warm(self, fn, args: tuple, statics: dict, dyn: dict) -> bool:
        """Capture the key's graph without serving a window (the eager run
        before the capture is made and dropped). Returns True when this call
        minted a graph."""
        key = self.key_for(fn, args, statics, dyn)
        table = self._table(args[0])
        entry, _first = table.lookup(key, _label(fn, args))
        with entry.lock:
            if entry.graph is not None or entry.bypass is not None:
                return False
            self._mint(entry, table, key, fn, args, statics, dyn)
            minted = entry.graph is not None
        if minted:
            table.trim()
        return minted

    def _mint(self, entry: _Entry, table: _Table, key, fn, args, statics, dyn):
        """Capture ``entry`` (its lock held); returns this call's result.
        On failure the entry keeps a bypass reason and the result still
        comes from the eager run."""
        leaves = _leaves(dyn.get("cached"), _leaves(args, []))
        dev = leaves[0].device if leaves else torch.device("cpu")
        with self._capture_lock:
            with self._lock:
                self.inflight += 1
            try:
                if dev.type == "cuda":
                    return self._capture_cuda(entry, table, fn, args, statics, dyn, leaves, dev)
                return self._capture_host(entry, fn, args, statics, dyn, leaves)
            finally:
                with self._lock:
                    self.inflight -= 1

    def _capture_cuda(self, entry, table, fn, args, statics, dyn, leaves, dev):
        cur = torch.cuda.current_stream(dev)
        # The eager run stays on the calling stream: a tensor made on the
        # capture stream and read on this one could be handed out again by
        # the allocator before that read ran, and eager work on the capture
        # stream would share its cuBLAS workspace with replays running
        # meanwhile on this one (from another thread).
        with kernels.watch_host_syncs() as syncs:
            out = fn(*args, **statics, **dyn)
        if syncs:
            entry.bypass = syncs[0]
            return out
        inputs = [torch.empty_like(a) for a in leaves]
        for s, a in zip(inputs, leaves):
            s.copy_(a)
        s_args, s_dyn = self._over(inputs, args, dyn)
        side = self._side_stream(dev)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side), kernels.record_launches() as rec:
                t0 = time.perf_counter()
                graph.capture_begin(pool=table.pool(dev), capture_error_mode="thread_local")
                try:
                    s_out = fn(*s_args, **statics, **s_dyn)
                except RuntimeError as err:
                    _abandon(graph, dev)
                    entry.bypass = f"capture failed: {err}"
                    return out
                t1 = time.perf_counter()
                try:
                    graph.capture_end()
                except RuntimeError as err:
                    _abandon(graph, dev)
                    entry.bypass = f"capture failed: {err}"
                    return out
                t2 = time.perf_counter()
        finally:
            cur.wait_stream(side)
        self._keep(entry, graph, inputs, s_out, rec, t1 - t0, t2 - t1)
        return out

    def _capture_host(self, entry, fn, args, statics, dyn, leaves):
        inputs = [a.clone() for a in leaves]
        s_args, s_dyn = self._over(inputs, args, dyn)
        with kernels.watch_host_syncs() as syncs, kernels.record_launches() as rec:
            t0 = time.perf_counter()
            s_out = fn(*s_args, **statics, **s_dyn)
            t1 = time.perf_counter()
        kernels.book_record(rec)  # the capture pass ran this call's stage
        if syncs:
            entry.bypass = syncs[0]
            return s_out
        self._keep(entry, _HOST, inputs, s_out, rec, t1 - t0, 0.0)
        return _rebuild(s_out, iter([o.clone() for o in entry.outputs]))

    def _keep(self, entry, graph, inputs, s_out, rec, trace_s, compile_s) -> None:
        entry.graph, entry.inputs, entry.out_tree = graph, inputs, s_out
        if graph is not _HOST:
            entry.exec_handle = graph.raw_cuda_graph_exec()
        entry.outputs = _leaves(s_out, [])
        entry.launches = dict(rec)
        with self._lock:
            self.misses += 1
            self.captures += 1
            self.trace_s += trace_s
            self.compile_s += compile_s
        log.info(
            "captured stage graph", stage=entry.label, trace_s=round(trace_s, 3),
            compile_s=round(compile_s, 3), launches=sum(entry.launches.values()),
        )

    @staticmethod
    def _over(inputs, args, dyn):
        """``args`` and ``dyn`` with their tensors replaced by ``inputs``."""
        it = iter(inputs)
        s_args = _rebuild(args, it)
        return s_args, {**dyn, "cached": _rebuild(dyn.get("cached"), it)} if "cached" in dyn else dyn

    def _replay(self, entry: _Entry, fn, args, statics, dyn, timer=_UNTIMED):
        leaves = _leaves(dyn.get("cached"), _leaves(args, []))
        for s, a in zip(entry.inputs, leaves):
            s.copy_(a)
        if entry.graph is _HOST:
            s_args, s_dyn = self._over(entry.inputs, args, dyn)
            with kernels.record_launches(), timer:  # booked from the record below
                new = fn(*s_args, **statics, **s_dyn)
            for o, n in zip(entry.outputs, _leaves(new, [])):
                o.copy_(n)
        else:
            dev = entry.inputs[0].device
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                with timer:
                    STAGE_EVENTS.launch(entry.exec_handle, stream)
        kernels.book_record(entry.launches)
        return _rebuild(entry.out_tree, iter([o.clone() for o in entry.outputs]))

    def _count_bypass(self, key: tuple, reason: str, label: str) -> None:
        with self._lock:
            self.bypasses += 1
            first = key not in self._bypassed
            self._bypassed[key] = reason
        if first:  # once per key: a persistent bypass must not flood logs
            log.error("stage graph bypassed to eager", reason, stage=label)

    def _side_stream(self, dev):
        with self._lock:
            if dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(dev)
            return self._streams[dev]

    # -- introspection ------------------------------------------------------

    def resident(self, owner, keys) -> bool:
        """Whether every key of ``keys`` has a graph, or is known to stay
        eager, on ``owner`` (counts nothing)."""
        table = owner.__dict__.get("_cko_graphs")
        if table is None:
            return False
        with table.lock:
            got = [table.entries.get(k) for k in keys]
        return all(e is not None and (e.graph is not None or e.bypass is not None) for e in got)

    def bypassed(self) -> list[tuple[tuple, str]]:
        """(key, reason) of every key that bypassed, in first-bypass order."""
        with self._lock:
            return list(self._bypassed.items())

    def pool_bytes(self) -> int:
        """Device bytes the graphs' pools hold (reads the allocator's
        snapshot: for reports, not for a hot path)."""
        with self._lock:
            tables = list(self._tables.values())
        pools = set()
        for t in tables:
            with t.lock:
                pools.update(tuple(p) for p in t.pools.values())
        if not pools or not torch.cuda.is_available():
            return 0
        return sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) in pools
        )

    def __len__(self) -> int:
        with self._lock:
            tables = list(self._tables.values())
        return sum(t.graphs() for t in tables)

    def stats(self) -> dict:
        graphs = len(self)
        with self._lock:
            return {
                "entries": graphs,
                "hits": self.hits,
                "misses": self.misses,
                "captures": self.captures,
                "compile_s": round(self.compile_s, 3),
                "trace_s": round(self.trace_s, 3),
                "bypasses": self.bypasses,
                "inflight": self.inflight,
                "persistent_dir": _configured_dir[0] if _configured_dir else None,
            }

    def snapshot(self) -> tuple[int, int, float]:
        """(hits, misses, compile_s) — for delta reporting."""
        with self._lock:
            return (self.hits, self.misses, self.compile_s)

    def clear(self) -> None:
        """Drop every model's entries (the counters stay)."""
        with self._lock:
            tables = list(self._tables.values())
        for t in tables:
            t.clear()


def _label(fn, args) -> str:
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)][:1]
    return f"{getattr(fn, '__name__', fn)}{shapes[0] if shapes else ''}"


def _abandon(graph, dev) -> None:
    """End a capture that raised. Ending an invalidated capture raises
    too, and then the allocator is still routing the capture's
    allocations to its pool: stop that as well."""
    try:
        graph.capture_end()
        return
    except RuntimeError:
        pass
    try:
        torch._C._cuda_endAllocateToPool(dev.index, graph.pool())
    except (AttributeError, RuntimeError):
        pass


# Process-wide singleton: every engine's stages count here; the graphs
# themselves live on their models.
EXEC_CACHE = ExecutableCache()
