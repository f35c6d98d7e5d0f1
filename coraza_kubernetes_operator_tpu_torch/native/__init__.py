"""ctypes bridge to the C++ host runtime (``libcko_native.so``).

Copy of ``coraza_kubernetes_operator_tpu/native/__init__.py`` with its
imports rewritten and one change of loading: the library is built from
the repository's ``native/src/cko_native.cpp`` at first use (``g++``
with ``native/Makefile``'s ``CXXFLAGS`` plus ``-shared``) into
``build/native/``, named by a hash of the source and flags, and written
by atomic rename. A failed build raises. ``CKO_NATIVE_LIB`` loads a
given library instead, and ``CKO_NATIVE=0`` (read per call) keeps
engines on the Python path.

The native library implements request extraction + batch tensorization
(the Python reference lives in ``engine/request.py`` + ``engine/waf.py``);
this module serializes the compiled-ruleset context it needs, feeds it
request batches, and exposes ``NativeTensorizer`` with the same output
tuple as ``WafEngine._tensorize``. Engines use the Python path when a
host pipeline uses a transform the native tier does not implement
(md5/sha1).

Differential tests in ``tests/test_torch_native.py`` hold the two paths
bit-for-bit equal.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np

from ..engine.request import HttpRequest
from .arena import StagingArena

# Transform opcode order — must match TransformOp in native/src/cko_native.cpp.
_OPCODES = {
    "none": 0, "lowercase": 1, "uppercase": 2, "urldecode": 3,
    "urldecodeuni": 4, "urlencode": 5, "htmlentitydecode": 6,
    "removenulls": 7, "replacenulls": 8, "removewhitespace": 9,
    "compresswhitespace": 10, "trim": 11, "trimleft": 12, "trimright": 13,
    "removecomments": 14, "removecommentschar": 15, "replacecomments": 16,
    "normalizepath": 17, "normalisepath": 17, "normalizepathwin": 18,
    "normalisepathwin": 18, "cmdline": 19, "jsdecode": 20, "cssdecode": 21,
    "base64decode": 22, "base64decodeext": 23, "base64encode": 24,
    "hexdecode": 25, "hexencode": 26, "escapeseqdecode": 27,
    "utf8tounicode": 28, "length": 29,
}

# Collection enum — must match Coll in cko_native.cpp.
_COLLECTION_IDS = {
    "ARGS": 0, "ARGS_GET": 1, "ARGS_POST": 2, "ARGS_NAMES": 3,
    "ARGS_GET_NAMES": 4, "ARGS_POST_NAMES": 5, "REQUEST_HEADERS": 6,
    "REQUEST_HEADERS_NAMES": 7, "REQUEST_COOKIES": 8,
    "REQUEST_COOKIES_NAMES": 9, "FILES": 10, "FILES_NAMES": 11,
}

# Scalar order — must match ScalarId in cko_native.cpp and the scalars dict
# in engine/request.py:extract.
_SCALAR_ORDER = [
    "REQUEST_URI", "REQUEST_URI_RAW", "REQUEST_FILENAME", "REQUEST_BASENAME",
    "REQUEST_LINE", "REQUEST_METHOD", "REQUEST_PROTOCOL", "QUERY_STRING",
    "REQUEST_BODY", "FULL_REQUEST", "PATH_INFO", "REMOTE_ADDR",
    "SERVER_NAME", "STATUS_LINE", "RESPONSE_BODY", "AUTH_TYPE",
    "REQBODY_PROCESSOR",
]

# Numeric order — must match NumId and the numeric_values dict.
_NUMERIC_ORDER = [
    "REQUEST_BODY_LENGTH", "REQBODY_ERROR", "MULTIPART_STRICT_ERROR",
    "MULTIPART_UNMATCHED_BOUNDARY", "ARGS_COMBINED_SIZE",
    "FULL_REQUEST_LENGTH", "FILES_COMBINED_SIZE", "RESPONSE_STATUS",
    "DURATION",
]




# ---------------------------------------------------------------------------
# ABI contract — the single source of truth for the Python↔C++ boundary.
# ---------------------------------------------------------------------------
# One entry per exported symbol in native/src/cko_native.cpp. Two
# consumers read THIS table, so a binding edit cannot drift from the
# check:
#   * ``load_library()`` materializes ctypes argtypes/restype from it;
#   * ``analysis/nativelint.py`` literal-parses it (the table must stay a
#     pure literal — no computed values) and cross-checks every entry
#     against the ``extern "C"`` declarators in the C++ source
#     (docs/ANALYSIS.md "Native boundary", findings CKO-N001..N008).
#
# Symbolic tokens (resolved via _CTYPES):
#   ptr    opaque handle / void*                  -> c_void_p
#   buf    byte buffer that may arrive as a bytearray or any other
#          buffer-protocol object (routed through _buf_arg) -> c_void_p.
#          NEVER c_char_p: ctypes rejects a bytearray for c_char_p with
#          an ArgumentError — the silent-fallback bug class that demoted
#          every blob_over_limit window to the host path (CKO-N004).
#   arr    numpy array data pointer (input or output) -> c_void_p
#   i32p   POINTER(c_int32) out-array
#   size   size_t -> c_size_t;  int -> c_int;  u32 -> c_uint32
#
# Per-entry flags:
#   "ret":      return token (omit/None for void). Pointer-returning
#               exports MUST set a pointer token — ctypes defaults to C
#               int and truncates 64-bit handles (CKO-N003).
#   "rc":       returns 0 on success / NEGATIVE error codes; the restype
#               must stay signed c_int or the sentinel inverts (CKO-N007).
#   "optional": symbol tolerated missing in an older .so.
#   "group":    all-or-nothing feature set; "plan" gates the tiered
#               window pipeline (lib._cko_has_plan).
_ABI: dict = {
    "cko_ctx_new": {"args": ["buf", "size"], "ret": "ptr"},
    "cko_ctx_free": {"args": ["ptr"], "ret": None},
    "cko_sqli": {"args": ["ptr", "buf", "size"], "ret": "int"},
    "cko_xss": {"args": ["ptr", "buf", "size"], "ret": "int"},
    "cko_tensorize": {"args": ["ptr", "buf", "size", "int"], "ret": "ptr"},
    "cko_result_rows": {"args": ["ptr"], "ret": "int"},
    "cko_result_maxlen": {"args": ["ptr"], "ret": "int"},
    "cko_result_export": {
        # res + 9 output planes (data, lengths, k1, k2, k3, req_id,
        # vdata, vlengths, numvals) + T, L, H, B, NV, n_req_pad.
        "args": [
            "ptr",
            "arr", "arr", "arr", "arr", "arr", "arr", "arr", "arr", "arr",
            "int", "int", "int", "int", "int", "int",
        ],
        "ret": "int",
        "rc": True,
    },
    "cko_result_free": {"args": ["ptr"], "ret": None},
    "cko_json_to_blob": {"args": ["buf", "size"], "ret": "ptr"},
    "cko_blob_data": {"args": ["ptr"], "ret": "ptr"},
    "cko_blob_len": {"args": ["ptr"], "ret": "size"},
    "cko_blob_nreq": {"args": ["ptr"], "ret": "int"},
    "cko_blob_free": {"args": ["ptr"], "ret": None},
    "cko_blob_overlimit": {
        "args": ["buf", "size", "u32", "i32p", "int"],
        "ret": "int",
        "optional": True,
    },
    # Window-plan ABI (tiered export): blob -> tier-bucketed plan in one
    # GIL-released call, then one export call scattering every tier into
    # the staging arena. Older .so -> NativeTensorizer.tiered is False
    # and the per-window _export path serves.
    "cko_plan_new": {
        # ctx, blob, len, n_req, tier bounds (int64[]), n_bounds,
        # min_tier_rows, kind lut (int64[]) or NULL, lut_len, max_parts,
        # min_part_rows, min_len.
        "args": [
            "ptr", "buf", "size", "int", "arr", "int", "int", "arr",
            "int", "int", "int", "int",
        ],
        "ret": "ptr",
        "group": "plan",
    },
    "cko_plan_ntiers": {"args": ["ptr"], "ret": "int", "group": "plan"},
    "cko_plan_tiers": {"args": ["ptr", "arr"], "ret": "int", "group": "plan"},
    "cko_plan_keys": {
        "args": ["ptr", "int", "arr"],
        "ret": "int",
        "rc": True,
        "group": "plan",
    },
    "cko_plan_export": {
        # plan, ptrs (uint64[9*n_tiers]), dims (int64[4*n_tiers]),
        # miss_all (int32[]) or NULL, miss_off (int64[]) or NULL,
        # numvals, B, NV, n_req_pad.
        "args": [
            "ptr", "arr", "arr", "arr", "arr", "arr", "int", "int", "int",
        ],
        "ret": "int",
        "rc": True,
        "group": "plan",
    },
    "cko_plan_free": {"args": ["ptr"], "ret": None, "group": "plan"},
}

# Token -> ctypes type. nativelint cross-checks the TOKEN against the C
# declarator's width/class; this mapping is the one place a token gains
# a concrete ctypes meaning.
_CTYPES: dict = {
    "ptr": ctypes.c_void_p,
    "buf": ctypes.c_void_p,
    "arr": ctypes.c_void_p,
    "charp": ctypes.c_char_p,
    "i32p": ctypes.POINTER(ctypes.c_int32),
    "size": ctypes.c_size_t,
    "int": ctypes.c_int,
    "u32": ctypes.c_uint32,
}


def _bind(lib) -> None:
    """Apply the ``_ABI`` spec to a freshly loaded CDLL: argtypes and
    restype for every exported symbol, optional symbols tolerated,
    feature groups all-or-nothing (a partial plan ABI never half-loads)."""
    missing_groups: set[str] = set()
    for name, spec in _ABI.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            group = spec.get("group")
            if group is not None:
                missing_groups.add(group)
                continue
            if spec.get("optional"):
                continue
            raise
        fn.argtypes = [_CTYPES[t] for t in spec["args"]]
        ret = spec.get("ret")
        fn.restype = _CTYPES[ret] if ret is not None else None
    lib._cko_has_plan = "plan" not in missing_groups


_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "src" / "cko_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
# native/Makefile's CXXFLAGS; the build adds -shared.
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Wconversion", "-Werror")


def build_library() -> Path:
    """Compile ``native/src/cko_native.cpp`` into ``build/native/`` unless
    a library for this source and these flags is there already; returns
    its path. Concurrent first users (test workers) take a file lock, so
    one process builds and the others load its result. ``g++`` writes its
    errors to stderr and a failed build raises."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libcko_native-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".so.tmp{os.getpid()}")
            subprocess.run(["g++", *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)], check=True)
            os.replace(tmp, out)
    return out


def _lib_path() -> Path | None:
    env = os.environ.get("CKO_NATIVE_LIB")
    if env:
        return Path(env) if Path(env).exists() else None
    return build_library()


_lib = None


def load_library():
    """Load (once) and return the native library, building it at first
    use; None under ``CKO_NATIVE=0`` or when ``CKO_NATIVE_LIB`` names a
    missing file."""
    global _lib
    if os.environ.get("CKO_NATIVE", "1") == "0":
        return None
    if _lib is not None:
        return _lib
    path = _lib_path()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    _bind(lib)
    _lib = lib
    return _lib


def _buf_arg(blob):
    """Zero-copy c_void_p argument for a request blob: bytes pass through
    ctypes directly; any writable buffer-protocol object (the ingest
    frontend's window bytearray, a numpy view) is wrapped via
    from_buffer — no copy either way. Read-only non-bytes views are the
    one (cold) case that degrades to a copy."""
    if isinstance(blob, bytes):
        return blob
    try:
        return (ctypes.c_ubyte * len(blob)).from_buffer(blob)
    except (TypeError, BufferError):
        return memoryview(blob).tobytes()


def _pack_str(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def serialize_config(crs) -> bytes | None:
    """Build the context blob for cko_ctx_new. None when the ruleset uses
    features the native tier does not support (exotic host transforms)."""
    out = [struct.pack("<II", int(crs.program.request_body_access),
                       crs.program.request_body_limit)]
    out.append(struct.pack("<I", crs.vocab.n_kinds))

    entries = []
    for (coll, sel), kind in crs.vocab.kinds.items():
        cid = _COLLECTION_IDS.get(coll)
        if cid is None:
            continue  # scalars handled below; unextracted collections unused
        sel_b = (sel or "").encode("latin-1", "replace")
        entries.append(struct.pack("<BH", cid, len(sel_b)) + sel_b
                       + struct.pack("<I", kind))
    out.append(struct.pack("<I", len(entries)))
    out.extend(entries)

    regex = []
    for coll, _pat, kid in crs.vocab.regex_kinds:
        cid = _COLLECTION_IDS.get(coll)
        if cid is None:
            continue
        dfa = crs.vocab._regex_dfas[kid]
        s, c = dfa.n_states, dfa.n_classes
        blob = struct.pack("<BIIIB", cid, kid, s, c, int(dfa.always_match))
        blob += np.asarray(dfa.classmap, dtype=np.uint16).tobytes()
        blob += np.ascontiguousarray(dfa.trans, dtype=np.uint32).tobytes()
        blob += np.ascontiguousarray(dfa.emit, dtype=np.uint8).tobytes()
        blob += np.ascontiguousarray(dfa.match_end, dtype=np.uint8).tobytes()
        regex.append(blob)
    out.append(struct.pack("<I", len(regex)))
    out.extend(regex)

    for name in _SCALAR_ORDER:
        out.append(struct.pack("<I", crs.vocab.lookup(name, None) or 0))
    for name in _NUMERIC_ORDER:
        out.append(struct.pack("<I", crs.vocab.lookup(name, None) or 0))

    # Host pipelines in slot order, with their member-kind sets (the kinds
    # some rule under that pipeline can see — engine/waf.py logic).
    host_pipelines = crs.host_pipelines()
    pipes = []
    for pid, names in host_pipelines:
        ops = []
        for n in names:
            op = _OPCODES.get(n)
            if op is None:
                return None  # unsupported transform -> python fallback
            ops.append(op)
        kinds: set[int] = set()
        for link in crs.links:
            if link.group >= 0 and crs.group_pipeline[link.group] == pid:
                kinds.update(link.include_kinds)
        blob = struct.pack("<I", len(ops)) + bytes(ops)
        blob += struct.pack("<I", len(kinds))
        blob += b"".join(struct.pack("<I", k) for k in sorted(kinds))
        pipes.append(blob)
    out.append(struct.pack("<I", len(pipes)))
    out.extend(pipes)

    nv_specs = sorted(crs.numvars.vars.items(), key=lambda kv: kv[1])
    nv_blobs = []
    has_hostops = False
    for key, _slot in nv_specs:
        if key[0] == "hostop":
            # Host-evaluated operator bits: the native tier ships the
            # libinjection-architecture SQLi machine (tokenize → fold →
            # fingerprint, cko_native.cpp:sq_is_sqli) with the tables
            # generated by compiler/sqli.py (below) so they cannot skew.
            _, opname, pipeline, include, exclude = key
            op_ids = {"sqli": 0, "xss": 1}
            if opname not in op_ids:
                return None  # unknown host op → python fallback
            ops = []
            for n in pipeline:
                op = _OPCODES.get(n)
                if op is None:
                    return None
                ops.append(op)
            blob = struct.pack("<BB", 2, op_ids[opname])
            blob += struct.pack("<I", len(ops)) + bytes(ops)
            blob += struct.pack("<I", len(include))
            blob += b"".join(struct.pack("<I", k) for k in include)
            blob += struct.pack("<I", len(exclude))
            blob += b"".join(struct.pack("<I", k) for k in exclude)
            nv_blobs.append(blob)
            has_hostops = True
            continue
        if key[0] == "scalar":
            try:
                sid = _NUMERIC_ORDER.index(key[1])
            except ValueError:
                sid = 0xFF  # unknown scalar evaluates to 0
            nv_blobs.append(struct.pack("<BB", 0, sid))
        else:
            _, coll, sel = key
            cid = _COLLECTION_IDS.get(coll)
            if cid is None:
                return None  # counting an unextracted collection
            sel_b = (sel or "").encode("latin-1", "replace")
            nv_blobs.append(
                struct.pack("<BBBH", 1, cid, int(sel is not None), len(sel_b))
                + sel_b
            )
    out.append(struct.pack("<I", len(nv_blobs)))
    out.extend(nv_blobs)

    if has_hostops:
        # SQLi tables, generated by compiler/sqli.py at import time.
        from ..compiler import sqli as _sqli

        word_classes: dict[bytes, bytes] = {}
        for words, cls in (
            (_sqli._KEYWORDS_U, b"U"), (_sqli._KEYWORDS_E, b"E"),
            (_sqli._KEYWORDS_B, b"B"), (_sqli._KEYWORDS_K, b"k"),
            (_sqli._LOGIC, b"&"), (_sqli._SQLTYPES, b"t"),
            (_sqli._FUNCTIONS, b"f"), (_sqli._EVASION_WORDS, b"x"),
        ):
            for w in words:
                wb = w.encode("latin-1")
                word_classes.setdefault(wb, cls)
        out.append(struct.pack("<I", len(word_classes)))
        for wb, cls in sorted(word_classes.items()):
            out.append(struct.pack("<H", len(wb)) + wb + cls)
        fps = sorted(_sqli._FINGERPRINTS)
        out.append(struct.pack("<I", len(fps)))
        for fp in fps:
            fb = fp.encode("latin-1")
            out.append(struct.pack("<B", len(fb)) + fb)

        # XSS tables, generated by compiler/xss.py.
        from ..compiler import xss as _xss

        for names in (sorted(_xss.BLACK_TAGS), sorted(_xss.BLACK_ATTRS)):
            out.append(struct.pack("<I", len(names)))
            for nm in names:
                nb = nm.encode("latin-1")
                out.append(struct.pack("<H", len(nb)) + nb)
        out.append(struct.pack("<I", len(_xss.BLACK_SCHEMES)))
        for sc in _xss.BLACK_SCHEMES:
            sb = sc.encode("latin-1")
            out.append(struct.pack("<H", len(sb)) + sb)
    return b"".join(out)


def serialize_requests(requests: list[HttpRequest]) -> bytes:
    parts = []
    for r in requests:
        parts.append(_pack_str(r.method.encode("latin-1", "replace")))
        parts.append(_pack_str(r.uri.encode("latin-1", "replace")))
        parts.append(_pack_str(r.version.encode("latin-1", "replace")))
        parts.append(struct.pack("<I", len(r.headers)))
        for k, v in r.headers:
            parts.append(_pack_str(str(k).encode("latin-1", "replace")))
            parts.append(_pack_str(str(v).encode("latin-1", "replace")))
        body = r.body if isinstance(r.body, bytes) else str(r.body).encode()
        parts.append(_pack_str(body))
        parts.append(_pack_str(r.remote_addr.encode("latin-1", "replace")))
    return b"".join(parts)


# Shape bucketing + tier policy knobs must stay bit-for-bit identical to
# the Python path (engine/waf.py::tier_tensors is the reference).
from ..engine.waf import (  # noqa: E402
    _MIN_LEN,
    _MIN_PART_ROWS,
    _MIN_TIER_ROWS,
    _TIER_BOUNDS,
    _TIER_PARTS,
    _bucket,
    _bucket_rows,
    part_rows,
)

_BOUNDS_ARR = np.asarray(_TIER_BOUNDS, dtype=np.int64)


class NativeTensorizer:
    """Holds a native context for one compiled ruleset; produces the same
    tensor tuple as ``WafEngine._tensorize`` directly from requests."""

    def __init__(self, crs):
        self._lib = load_library()
        self._ctx = None
        # Tiered-export state: the staging arena is per-tensorizer (hence
        # per-engine — a hot swap gets a fresh arena, old buffers can
        # never serve the new engine) and the window timings feed
        # cko_native_window_s / the stats native block.
        self._arena = StagingArena()
        self._stats_lock = threading.Lock()
        self.windows_total = 0
        self.window_s_total = 0.0
        self._window_recent: deque[float] = deque(maxlen=512)
        if self._lib is None:
            return
        blob = serialize_config(crs)
        if blob is None:
            return
        ctx = self._lib.cko_ctx_new(blob, len(blob))
        if not ctx:
            return
        self._ctx = ctx
        self._n_host = len(crs.host_pipelines())
        self._nv = crs.numvars.n_vars

    @property
    def available(self) -> bool:
        return self._ctx is not None

    @property
    def tiered(self) -> bool:
        """True when the one-call tiered window pipeline serves blob
        windows. Requires the plan ABI in the loaded .so; CKO_NATIVE_TIERED=0
        forces the legacy per-window _export + Python tiering path (read
        per call, so a smoke can A/B the two on one engine)."""
        return (
            self._ctx is not None
            and getattr(self._lib, "_cko_has_plan", False)
            and os.environ.get("CKO_NATIVE_TIERED", "1") != "0"
        )

    def tensorize_json(self, body: bytes):
        """Bulk-evaluate JSON body → (tensors, n_requests, request_blob).
        The whole ingest (JSON parse, extraction, transforms, host ops,
        row packing) runs in C++; Python never materializes per-request
        objects. Returns None when the JSON doesn't parse (caller falls
        back to the schema-error-reporting Python path). The returned
        request blob lets the caller recover (method, uri, version,
        remote) for audit records without re-parsing the JSON."""
        assert self._ctx is not None
        h = self._lib.cko_json_to_blob(_buf_arg(body), len(body))
        if not h:
            return None
        try:
            n_req = self._lib.cko_blob_nreq(h)
            data_ptr = self._lib.cko_blob_data(h)
            blob_len = self._lib.cko_blob_len(h)
            blob = ctypes.string_at(data_ptr, blob_len)
        finally:
            self._lib.cko_blob_free(h)
        if n_req == 0:
            return (), 0, b""
        res = self._lib.cko_tensorize(self._ctx, blob, len(blob), n_req)
        if not res:
            return None
        return self._export(res, n_req), n_req, blob

    def tensorize(self, requests: list[HttpRequest]):
        return self.tensorize_blob(serialize_requests(requests), len(requests))

    def tensorize_blob(self, blob: bytes, n_req: int):
        """Tensorize a pre-assembled request blob (the exact
        ``serialize_requests`` wire format). The async ingest frontend
        packs parsed request bytes straight into this layout, so a full
        ingest window reaches C++ as one contiguous buffer with zero
        per-request Python object materialization. Accepts bytes or any
        buffer-protocol object — the blob is handed to C++ without a
        copy (the old ``bytes(blob)`` defensive copy re-paid the whole
        window's bytes per call)."""
        assert self._ctx is not None
        buf = _buf_arg(blob)
        res = self._lib.cko_tensorize(self._ctx, buf, len(blob), n_req)
        if not res:
            raise RuntimeError("native tensorize failed (malformed batch blob)")
        return self._export(res, n_req)

    def tier_blob(self, blob, n_req: int, kind_lut, cache=None,
                  narrow: tuple[int, int] = (0, 0)):
        """The one-call window pipeline: raw request blob -> tier-bucketed,
        value-dedup'd, dispatch-ready tensors written into staging-arena
        buffers. Parse, extraction, transforms, tier assignment, kind
        partitioning, and the dedup all run in ONE GIL-released C++ call
        (cko_plan_new); Python keeps only the value-cache probe; a second
        GIL-released call (cko_plan_export) scatters every tier straight
        into reusable page-aligned buffers, zeroing only pad regions.

        Returns ``(tiers, numvals, masks, cached, miss_keys, lease)`` —
        the first five bit-identical to ``WafEngine.tier_cached(
        tensorize_blob(blob, n_req))``, plus the arena lease the caller
        releases once the window's device step has consumed the host
        buffers (``WafEngine.collect``). ``narrow`` is ``tier_tensors``'s."""
        assert self.tiered
        lib = self._lib
        t0 = time.perf_counter()
        buf = _buf_arg(blob)
        if kind_lut is None or _TIER_PARTS <= 1:
            lut_ptr, lut_len, max_parts = None, 0, 1
        else:
            kind_lut = np.ascontiguousarray(kind_lut, dtype=np.int64)
            lut_ptr = kind_lut.ctypes.data_as(ctypes.c_void_p)
            lut_len = kind_lut.shape[0]
            max_parts = _TIER_PARTS
        plan = lib.cko_plan_new(
            self._ctx,
            buf,
            len(blob),
            n_req,
            _BOUNDS_ARR.ctypes.data_as(ctypes.c_void_p),
            len(_TIER_BOUNDS),
            _MIN_TIER_ROWS,
            lut_ptr,
            lut_len,
            max_parts,
            1 if narrow[0] else _MIN_PART_ROWS,
            _MIN_LEN,
        )
        if not plan:
            raise RuntimeError("native tensorize failed (malformed batch blob)")
        lease = None
        try:
            nt = lib.cko_plan_ntiers(plan)
            meta = np.zeros(nt * 6, dtype=np.int64)
            lib.cko_plan_tiers(plan, meta.ctypes.data_as(ctypes.c_void_p))
            meta = meta.reshape(nt, 6)
            masks = tuple(
                int(m[5]) if m[4] else None for m in meta.tolist()
            )

            # Value-cache probe — the ONLY per-window Python between the
            # two native calls. Keys and their sorted-unique order come
            # from C++; the probe decides which unique rows the matcher
            # must run (miss) vs which replay packed hit rows (found).
            miss_lists: list[list[int]] = [None] * nt  # type: ignore[list-item]
            if cache is None:
                cached = None
                miss_keys = None
            else:
                cached_l = []
                miss_keys = []
                for ti in range(nt):
                    n_uniq = int(meta[ti, 2])
                    key_len = int(meta[ti, 3])
                    kb = np.empty(n_uniq * key_len, dtype=np.uint8)
                    lib.cko_plan_keys(
                        plan, ti, kb.ctypes.data_as(ctypes.c_void_p)
                    )
                    prefix = int(
                        -1 if masks[ti] is None else masks[ti]
                    ).to_bytes(8, "little", signed=True)
                    kbytes = kb.tobytes()
                    ukeys = [
                        prefix + kbytes[i * key_len : (i + 1) * key_len]
                        for i in range(n_uniq)
                    ]
                    found, miss = cache.lookup(ukeys)
                    miss_lists[ti] = miss
                    miss_keys.append([ukeys[j] for j in miss])
                    cpk = np.zeros(
                        (part_rows(len(found), masks[ti], narrow), cache.packed_len),
                        dtype=np.uint8,
                    )
                    for r, (_j, row) in enumerate(sorted(found.items())):
                        cpk[r] = row
                    cached_l.append(cpk)
                cached = tuple(cached_l)

            h = max(1, self._n_host)
            b = _bucket(max(1, n_req))
            dims = np.zeros(nt * 4, dtype=np.int64)
            shapes = []
            for ti in range(nt):
                length, n_pairs, n_uniq = (
                    int(meta[ti, 0]), int(meta[ti, 1]), int(meta[ti, 2])
                )
                n_miss = (
                    n_uniq if cache is None else len(miss_lists[ti])
                )
                u = part_rows(n_miss, masks[ti], narrow)
                p = part_rows(n_pairs, masks[ti], narrow)
                # u_pad (found-row uid base) == the bucketed miss count.
                dims[ti * 4 : ti * 4 + 4] = (u, p, u, n_miss)
                shapes.append((u, length, p))

            lease = self._arena.checkout((tuple(shapes), h, b, self._nv))
            ptrs = np.zeros(nt * 9, dtype=np.uint64)
            for ti, bufs in enumerate(lease.tiers):
                for k in range(9):
                    ptrs[ti * 9 + k] = bufs[k].ctypes.data
            if cache is None:
                miss_ptr = None
                off_ptr = None
            else:
                flat = [j for m in miss_lists for j in m]
                miss_all = np.zeros(max(1, len(flat)), dtype=np.int32)
                miss_all[: len(flat)] = flat
                offs = np.zeros(nt, dtype=np.int64)
                o = 0
                for ti in range(nt):
                    offs[ti] = o
                    o += len(miss_lists[ti])
                miss_ptr = miss_all.ctypes.data_as(ctypes.c_void_p)
                off_ptr = offs.ctypes.data_as(ctypes.c_void_p)
            rc = lib.cko_plan_export(
                plan,
                ptrs.ctypes.data_as(ctypes.c_void_p),
                dims.ctypes.data_as(ctypes.c_void_p),
                miss_ptr,
                off_ptr,
                lease.numvals.ctypes.data_as(ctypes.c_void_p),
                b,
                self._nv,
                b,
            )
            if rc != 0:
                raise RuntimeError(f"native tiered export failed rc={rc}")
        except BaseException:
            if lease is not None:
                lease.release()
            raise
        finally:
            lib.cko_plan_free(plan)
        tiers = tuple(lease.tiers[: nt])
        numvals = lease.numvals
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.windows_total += 1
            self.window_s_total += dt
            self._window_recent.append(dt)
        return tiers, numvals, masks, cached, miss_keys, lease

    def stats(self) -> dict:
        """Native-pipeline counters for /waf/v1/stats and the metrics
        gauges: window totals/latency plus the staging-arena pool."""
        with self._stats_lock:
            recent = sorted(self._window_recent)
            out = {
                "windows_total": self.windows_total,
                "window_s_total": self.window_s_total,
                "p50_window_ms": (
                    recent[len(recent) // 2] * 1e3 if recent else 0.0
                ),
            }
        out["arena"] = (
            self._arena.stats()
            if self._ctx is not None
            else {"buffers": 0, "reuses_total": 0, "allocs_total": 0}
        )
        return out

    def _export(self, res, n_requests: int):
        try:
            n_rows = self._lib.cko_result_rows(res)
            max_len = self._lib.cko_result_maxlen(res)
            n_req = _bucket(max(1, n_requests))
            t = _bucket_rows(max(1, n_rows))
            length = _bucket(max(_MIN_LEN, max_len))
            h = max(1, self._n_host)

            data = np.zeros((t, length), dtype=np.uint8)
            lengths = np.zeros(t, dtype=np.int32)
            k1 = np.zeros(t, dtype=np.int32)
            k2 = np.zeros(t, dtype=np.int32)
            k3 = np.zeros(t, dtype=np.int32)
            req_id = np.zeros(t, dtype=np.int32)
            vdata = np.zeros((h, t, length), dtype=np.uint8)
            vlengths = np.zeros((h, t), dtype=np.int32)
            numvals = np.zeros((n_req, self._nv), dtype=np.int32)

            rc = self._lib.cko_result_export(
                res,
                data.ctypes.data_as(ctypes.c_void_p),
                lengths.ctypes.data_as(ctypes.c_void_p),
                k1.ctypes.data_as(ctypes.c_void_p),
                k2.ctypes.data_as(ctypes.c_void_p),
                k3.ctypes.data_as(ctypes.c_void_p),
                req_id.ctypes.data_as(ctypes.c_void_p),
                vdata.ctypes.data_as(ctypes.c_void_p),
                vlengths.ctypes.data_as(ctypes.c_void_p),
                numvals.ctypes.data_as(ctypes.c_void_p),
                t, length, self._n_host, n_req, self._nv, n_req,
            )
            if rc != 0:
                raise RuntimeError(f"native export failed rc={rc}")
        finally:
            self._lib.cko_result_free(res)
        return (data, lengths, k1, k2, k3, req_id, numvals, vdata, vlengths)

    def __del__(self):
        if self._ctx is not None and self._lib is not None:
            self._lib.cko_ctx_free(self._ctx)
            self._ctx = None


def blob_over_limit(blob: bytes, limit: int) -> list[int]:
    """Request indexes in a bulk blob whose (untruncated) body exceeds
    ``limit`` — the SecRequestBodyLimitAction Reject set for the fast
    path. Uses the C scanner when loaded; pure-Python walk otherwise."""
    lib = load_library()
    if lib is not None and getattr(lib, "cko_blob_overlimit", None) is not None:
        # _buf_arg, not the raw blob: the ingest frontend hands its
        # window bytearray through here zero-copy, and c_void_p only
        # accepts bytes (a raw bytearray would ArgumentError and kick
        # the whole window to the host fallback).
        buf = _buf_arg(blob)
        cap = 4096
        out = (ctypes.c_int32 * cap)()
        n = lib.cko_blob_overlimit(buf, len(blob), limit, out, cap)
        if n <= cap:
            return list(out[:n])
        out = (ctypes.c_int32 * n)()
        n = lib.cko_blob_overlimit(buf, len(blob), limit, out, n)
        return list(out[:n])
    res: list[int] = []
    pos = 0
    idx = 0
    n = len(blob)

    def skip() -> int:
        nonlocal pos
        (l,) = struct.unpack_from("<I", blob, pos)
        pos += 4 + l
        return l

    while pos < n:
        skip()  # method
        skip()  # uri
        skip()  # version
        (nh,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        for _ in range(2 * nh):
            skip()
        if skip() > limit:  # body
            res.append(idx)
        skip()  # remote
        idx += 1
    return res


def blob_requests(
    blob: bytes, n_req: int | None = None, wanted: set[int] | None = None
) -> list[HttpRequest]:
    """Materialize ``HttpRequest`` objects from a request blob — the
    slow-path escape hatch for blob windows (Python tensorizer fallback,
    degraded-mode host evaluation, shadow mirroring, and the over-limit
    phase-1 pre-pass). Decoding is latin-1, the exact inverse of
    ``serialize_requests`` / the ingest frontend's byte slicing, so a
    materialized request round-trips bit-identically. ``wanted`` limits
    the result to those indexes (in ascending order)."""
    out: list[HttpRequest] = []
    pos = 0
    idx = 0
    n = len(blob)

    def rd() -> bytes:
        nonlocal pos
        (l,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        val = blob[pos : pos + l]
        pos += l
        return val

    while pos < n and (n_req is None or idx < n_req):
        if wanted is not None and idx not in wanted:
            # Skip without decoding.
            for _ in range(3):
                rd()
            (nh,) = struct.unpack_from("<I", blob, pos)
            pos += 4
            for _ in range(2 * nh + 2):
                rd()
            idx += 1
            continue
        method = rd().decode("latin-1", "replace")
        uri = rd().decode("latin-1", "replace")
        version = rd().decode("latin-1", "replace")
        (nh,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        headers = []
        for _ in range(nh):
            k = rd().decode("latin-1", "replace")
            v = rd().decode("latin-1", "replace")
            headers.append((k, v))
        body = bytes(rd())
        remote = rd().decode("latin-1", "replace")
        out.append(
            HttpRequest(
                method=method,
                uri=uri,
                version=version,
                headers=headers,
                body=body,
                remote_addr=remote,
            )
        )
        idx += 1
    return out


def blob_request_lines(blob: bytes, wanted: set[int]) -> dict[int, tuple]:
    """Walk a request blob and recover (method, uri, version, remote) for
    the requested indexes — audit records for blocked requests on the
    bulk fast path, without re-parsing the JSON."""
    out: dict[int, tuple] = {}
    pos = 0
    idx = 0
    n = len(blob)

    def rd() -> bytes:
        nonlocal pos
        (l,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        val = blob[pos : pos + l]
        pos += l
        return val

    while pos < n and (wanted is None or idx <= max(wanted)):
        method = rd()
        uri = rd()
        version = rd()
        (nh,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        for _ in range(nh):
            rd()
            rd()
        rd()  # body
        remote = rd()
        if wanted is None or idx in wanted:
            out[idx] = (
                method.decode("latin-1", "replace"),
                uri.decode("latin-1", "replace"),
                version.decode("latin-1", "replace"),
                remote.decode("latin-1", "replace"),
            )
        idx += 1
    return out
