"""WafEngine (PyTorch): compile once, evaluate request windows on the card.

Port of ``coraza_kubernetes_operator_tpu/engine/waf.py``. One window is
``collect(prepare(requests))`` or, for a pre-assembled request blob (the
``native.serialize_requests`` wire format the sidecar's ingest builds),
``collect(prepare_blob(blob, n))``:

1. ``prepare`` / ``prepare_blob``: extract targets, tensorize and split
   rows into (length x kind-partition) tiers with value dedup and the
   cross-window value cache. With the native host runtime (built at
   first use, ``native/``) the blob goes to tier tensors in two
   GIL-released C++ calls writing into staging-arena buffers; without it
   ``_tensorize`` and ``tier_tensors`` do the same in Python. Then each
   tier's matcher stage (``match_tier_packed``) runs, approximate
   prefilter hits are confirmed on the host (``_confirm_prefilter``) and
   the post stage runs (``eval_post_tiered``). Every stage runs on the
   engine's device through ``EXEC_CACHE.call`` (``engine/compile_cache.py``),
   as in the reference: a stage's first run at a signature (its tier
   shape, mask, finals flag, cached-row layout) is eager, its second
   captures a CUDA graph on the model, and later windows of that
   signature replay the graph instead of issuing the stage's ops from
   the host. ``prewarm`` captures a batch's graphs without serving it.
   The reference's lazy mode, which answers not-yet-compiled stages
   through the host twins, has no counterpart here.
2. ``collect``: read the packed verdict array back with ``.cpu()`` (the
   window's sync point), fill the value cache, decode the verdicts and
   release the window's arena lease.

Each window carries its stage spans on the host's monotonic clock
(``InFlightBatch.spans``) and, on the card, a pair of CUDA events around
each stage, read in ``collect`` once the read-back has waited and put on
the same clock (``InFlightBatch.device``). The batcher commits both to the
window log (``observability/tracing.py``).

The host twins (``host_fallback``, ``_host_tier_hits``, ``_host_post``)
give the same verdicts without the device. Shapes are bucketed exactly
as the reference buckets them, so a window tiers into the same rows and
widths on both.
"""

from __future__ import annotations

import os as _os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.ruleset import CompiledRuleSet, compile_program
from ..compiler.transforms_host import apply_pipeline
from ..models.waf_model import (
    WafModel,
    build_model,
    matched_id_lists,
    plan_layout,
    seg_columns,
    table_bytes,
    unpack_compact,
)
from ..observability.tracing import COMPILES
from ..ops.segment import conv_n2_cols
from ..seclang.parser import parse
from ..utils import get_logger
from ..utils.device import STAGE_EVENTS, resolve_device
from .request import Extraction, HttpRequest, TargetExtractor

log = get_logger("engine.waf")

_MIN_LEN = 32


def _bucket(n: int, lo: int = 1) -> int:
    size = lo
    while size < n:
        size *= 2
    return size


def _bucket_rows(n: int) -> int:
    """Row-count bucket: power of two up to 2048, then two sizes per
    octave (3072, 4096, 6144, 8192, …)."""
    if n <= 2048:
        return _bucket(n)
    size = 2048
    while True:
        if n <= size * 3 // 2:
            return size * 3 // 2
        size *= 2
        if n <= size:
            return size


# Row-level length-tier bounds (buffer widths); tiers with fewer than
# _MIN_TIER_ROWS rows merge into the next wider tier.
_TIER_BOUNDS = (64, 256, 1024, 4096, 16384)
_MIN_TIER_ROWS = 256

# Kind-partitioned matching: rows within a length tier split into at most
# CKO_TIER_PARTS partitions by which matcher blocks their kinds can reach;
# partitions below _MIN_PART_ROWS merge into the largest one.
_TIER_PARTS = int(_os.environ.get("CKO_TIER_PARTS", "3"))
_MIN_PART_ROWS = int(_os.environ.get("CKO_MIN_PART_ROWS", "1024"))


def part_rows(n: int, mask: int | None, narrow: tuple[int, int]) -> int:
    """The row bucket of ``n`` rows in a partition with ``mask``; ``narrow``
    is ``(narrow block mask, row floor)`` (``WafEngine._narrow_rows``), and
    a partition that reaches a narrow block buckets at the floor or more."""
    if mask is not None and mask & narrow[0]:
        n = max(n, narrow[1])
    return _bucket_rows(max(1, n))


def _mask_cost(mask: int, block_cost) -> float:
    c = 0.0
    for i, bc in enumerate(block_cost):
        if i >= 62:
            break
        if (mask >> i) & 1:
            c += bc
    return c


def _cluster_masks(values_counts, block_cost, max_parts: int):
    """Greedy cost clustering of block masks into <= max_parts clusters.
    ``values_counts`` is an iterable of (mask, weight); returns a list of
    (member_mask_values, union_mask)."""
    clusters = [([int(v)], int(v), int(c)) for v, c in values_counts]
    if len(clusters) > 16:  # cap the O(n^3) greedy; rare kind combos merge first
        clusters.sort(key=lambda cl: -cl[2])
        head, tail = clusters[:15], clusters[15:]
        members, um, rows = [], 0, 0
        for mem, m, r in tail:
            members += mem
            um |= m
            rows += r
        head.append((members, um, rows))
        clusters = head
    while len(clusters) > max_parts:
        best, bi, bj = None, 0, 1
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                _mi, ui, ri = clusters[i]
                _mj, uj, rj = clusters[j]
                delta = (
                    (ri + rj) * _mask_cost(ui | uj, block_cost)
                    - ri * _mask_cost(ui, block_cost)
                    - rj * _mask_cost(uj, block_cost)
                )
                if best is None or delta < best:
                    best, bi, bj = delta, i, j
        mi, ui, ri = clusters[bi]
        mj, uj, rj = clusters.pop(bj)
        clusters[bi] = (mi + mj, ui | uj, ri + rj)
    return [(mem, um) for mem, um, _rows in clusters]


def tier_tensors(tensors, kind_lut=None, cache=None, narrow: tuple[int, int] = (0, 0)):
    """Split one wide tensorized batch into row-level (length x kind
    partition) tiers of unique rows (numpy, host side).

    Input is the 9-tuple from ``WafEngine._tensorize``; output is
    ``(tiers, numvals, masks)`` where tiers is a tuple of per-tier
    ``(data, lengths, kind1, kind2, kind3, req_id, vdata, vlengths, uid)``
    and masks the aligned block bitmasks (None when ``kind_lut`` is
    absent). ``narrow`` is the model's narrow segment blocks as a mask and
    a row floor (``WafEngine._narrow_rows``): with none, a partition under
    ``_MIN_PART_ROWS`` rows merges into the largest; with some, no partition
    merges, and one that reaches them buckets its rows at the floor or more
    (``part_rows``). With
    ``cache`` (a ``ValueHitCache``) the return grows to
    ``(tiers, numvals, masks, cached, miss_keys)``: unique rows matched in
    an earlier window skip the matcher, and tier uid indexes the
    concatenation [matcher rows (bucketed) | cached rows]."""
    data, lengths, k1, k2, k3, req_id, numvals, vdata, vlengths = tensors
    n_req = numvals.shape[0]
    h = vdata.shape[0]
    real = np.flatnonzero(req_id < n_req)
    if real.size == 0:
        real = np.array([0], dtype=np.int64)  # keep one padding row
    row_max = lengths.astype(np.int64)
    if h and vlengths.size:
        row_max = np.maximum(row_max, vlengths.max(axis=0))
    cap = data.shape[1]
    bounds = [b for b in _TIER_BOUNDS if b < cap] + [cap]

    raw: list[tuple[int, np.ndarray]] = []
    remaining = real
    for b in bounds:
        fit = row_max[remaining] <= b
        sel = remaining[fit]
        remaining = remaining[~fit]
        if sel.size:
            raw.append((b, sel))
    tiers = []
    masks: list[int | None] = []
    cached: list[np.ndarray | None] = []
    miss_keys: list[list[bytes]] = []

    def emit(sel: np.ndarray, length: int, mask: int | None):
        # Value dedup: the matcher's output depends only on (bytes, length,
        # variant bytes), so matchers run on unique rows and post_match
        # keeps one row per original (target, kinds) pair via uid.
        parts = [np.ascontiguousarray(data[sel, :length])]
        parts.append(lengths[sel, None].astype(np.int32).view(np.uint8))
        for hi in range(h):
            parts.append(np.ascontiguousarray(vdata[hi][sel, :length]))
            parts.append(vlengths[hi][sel, None].astype(np.int32).view(np.uint8))
        keys = np.concatenate(parts, axis=1)
        _, first_idx, inverse = np.unique(
            keys.view([("", np.void, keys.shape[1])]).ravel(),
            return_index=True,
            return_inverse=True,
        )

        if cache is None:
            usel = sel[first_idx]
            remap = None
            cpk = None
            mkeys: list[bytes] = []
        else:
            # Cross-window value cache. Key = partition mask (it decides
            # which hit columns are live) + the dedup key bytes.
            prefix = int(-1 if mask is None else mask).to_bytes(8, "little", signed=True)
            ukeys = [prefix + keys[i].tobytes() for i in first_idx]
            found, miss = cache.lookup(ukeys)
            usel = sel[first_idx[miss]] if miss else sel[:0]
            mkeys = [ukeys[j] for j in miss]
            u_pad = part_rows(usel.size, mask, narrow)
            cpk = np.zeros(
                (part_rows(len(found), mask, narrow), cache.packed_len), dtype=np.uint8
            )
            remap = np.zeros(len(ukeys), dtype=np.int32)
            for r, j in enumerate(miss):
                remap[j] = r
            for r, (j, row) in enumerate(sorted(found.items())):
                cpk[r] = row
                remap[j] = u_pad + r

        u = part_rows(usel.size, mask, narrow)
        d = np.zeros((u, length), dtype=np.uint8)
        d[: usel.size] = data[usel, :length]
        lg = np.zeros(u, dtype=np.int32)
        lg[: usel.size] = lengths[usel]
        vd = np.zeros((max(h, 1), u, length), dtype=np.uint8)
        vl = np.zeros((max(h, 1), u), dtype=np.int32)
        if h and usel.size:
            vd[:, : usel.size] = vdata[:, usel, :length]
            vl[:, : usel.size] = vlengths[:, usel]

        p = part_rows(sel.size, mask, narrow)
        kk = []
        for src in (k1, k2, k3):
            a = np.zeros(p, dtype=np.int32)
            a[: sel.size] = src[sel]
            kk.append(a)
        rid = np.full(p, n_req, dtype=np.int32)
        rid[: sel.size] = req_id[sel]
        uid = np.zeros(p, dtype=np.int32)  # pad pairs read unique row 0
        uid[: sel.size] = inverse if remap is None else remap[inverse]
        tiers.append((d, lg, kk[0], kk[1], kk[2], rid, vd, vl, uid))
        masks.append(mask)
        cached.append(cpk)
        miss_keys.append(mkeys)

    # Forward merge: absorb sub-minimum tiers into the next wider bound.
    merged: list[tuple[int, np.ndarray]] = []
    i = 0
    while i < len(raw):
        b, sel = raw[i]
        while sel.size < _MIN_TIER_ROWS and i + 1 < len(raw):
            i += 1
            b = raw[i][0]
            sel = np.concatenate([sel, raw[i][1]])
        merged.append((b, sel))
        i += 1
    # A trailing tier still under the minimum merges backward.
    if len(merged) > 1 and merged[-1][1].size < _MIN_TIER_ROWS:
        b_last, sel_last = merged.pop()
        b_prev, sel_prev = merged[-1]
        merged[-1] = (max(b_prev, b_last), np.concatenate([sel_prev, sel_last]))

    for b, sel in merged:
        length = _bucket(max(_MIN_LEN, b))

        if kind_lut is None or _TIER_PARTS <= 1:
            emit(sel, length, None)
            continue
        pmask = kind_lut[k1[sel]] | kind_lut[k2[sel]] | kind_lut[k3[sel]]
        values = np.unique(pmask)
        parts = [(sel[pmask == v], int(v)) for v in values.tolist()]
        parts = [(s, um) for s, um in parts if s.size]
        parts.sort(key=lambda su: -su[0].size)
        while len(parts) > 1 and not narrow[0] and parts[-1][0].size < _MIN_PART_ROWS:
            s_small, m_small = parts.pop()
            s_big, m_big = parts[0]
            parts[0] = (np.concatenate([s_big, s_small]), m_big | m_small)
        if len(parts) == 1:
            emit(sel, length, None)
        else:
            for s, um in parts:
                emit(s, length, int(um))
    if cache is None:
        return tuple(tiers), numvals, tuple(masks)
    return tuple(tiers), numvals, tuple(masks), tuple(cached), miss_keys


def _compile_counters(crs: CompiledRuleSet, model: WafModel) -> dict:
    """A compile record's counters: groups per matcher tier, the segment
    blocks, and the model's table bytes."""
    tiers = {"segment": sum(s.n_groups for s in model.segs),
             "dfa": sum(b.n_groups for b in model.banks),
             "dfa-hot": sum(b.n_groups for b in model.gather_banks),
             "prefiltered": sum(b.n_groups for b in model.pre_banks)}
    blocks = [{"pipeline": pid, "columns": conv_n2_cols(seg.spec), "groups": seg.n_groups,
               "narrow": i in model.narrow_blocks}
              for i, (seg, pid) in enumerate(zip(model.segs, model.seg_pipelines))]
    return {"groups": len(crs.groups), "groups_per_tier": tiers, "segment_blocks": blocks,
            "device_table_bytes": table_bytes(model)}


def warmup_request() -> HttpRequest:
    """The canonical warmup/canary request (``WafEngine.prewarm``'s
    default batch)."""
    return HttpRequest(
        method="GET",
        uri="/__cko_warmup__",
        headers=[("host", "cko-warmup.local"), ("user-agent", "cko-promote/1")],
        body=b"",
    )


@dataclass
class Verdict:
    """Per-request evaluation outcome."""

    interrupted: bool
    status: int
    rule_id: int | None
    matched_ids: list[int] = field(default_factory=list)
    scores: dict[str, int] = field(default_factory=dict)

    @property
    def allowed(self) -> bool:
        return not self.interrupted


@dataclass
class InFlightBatch:
    """A prepared window: its device outputs are enqueued on the card's
    stream and not yet read back. ``WafEngine.collect`` reads and decodes
    them; it must run on the engine whose ``prepare`` built the window."""

    out: object  # packed verdict tensor, (packed, tier_hits), or None
    n_live: int
    n_requests: int
    rejected: dict[int, Verdict]
    miss_keys: list | None
    cache_pop: bool  # out carries tier hit rows for value-cache population
    # Index -> Verdict replacements applied after decode (blob windows:
    # over-limit rows stay in the batch and their verdicts are displaced
    # by the 413 / phase-1 outcome, as prepare's row exclusion gives).
    overrides: dict[int, Verdict] | None = None
    # host_s: prepare's wall seconds. spans: (name, t0, t1) on
    # time.monotonic(), in order: assemble (blob -> dispatch-ready tensors)
    # by prepare; copy_in, match_dispatch, confirm_wait / confirm_search
    # (one pair per device tier: the read-back of its match rows, then the
    # exact search), post_dispatch by _dispatch_tiers; readback_wait and
    # decode by collect. events: (stage, start, end, host time the start
    # was recorded) CUDA events on the card, read by collect into device:
    # (stage, t0, t1) on the same clock, slack_s the distance between the
    # two bounds that placed them (_device_intervals).
    host_s: float = 0.0
    spans: list = field(default_factory=list)
    events: list | None = None
    device: list = field(default_factory=list)
    slack_s: float | None = None
    # Matcher rows and segment column x row work (WafEngine._seg_work).
    seg_rows: int = 0
    seg_col_rows: int = 0
    # Staging-arena lease behind the window's tier arrays (tiered native
    # path), released by collect. Nothing reads the arena buffers after
    # prepare returns: on the card the host-to-device copies are
    # synchronous (pageable numpy through torch.as_tensor), and on the CPU
    # every stage has run by then.
    arena_lease: object = None

    def span_s(self, *names: str) -> float:
        """Seconds in the spans named ``names``."""
        return sum(t1 - t0 for name, t0, t1 in self.spans if name in names)

    @property
    def assemble_s(self) -> float:
        return self.span_s("assemble")

    @property
    def stage_s(self) -> dict:
        """Host seconds of _dispatch_tiers's steps: the confirm holds the
        read-back of the match stages' rows (their device time) and the
        exact search."""
        return {"copy_in": self.span_s("copy_in"), "match": self.span_s("match_dispatch"),
                "confirm": self.span_s("confirm_wait", "confirm_search"),
                "post": self.span_s("post_dispatch")}

    @property
    def readback_s(self) -> float:
        """The host's wait in the final read-back."""
        return self.span_s("readback_wait")

    @property
    def decode_s(self) -> float:
        return self.span_s("decode")

    @property
    def device_s(self) -> float | None:
        """Event-measured device seconds over the window's stages; None
        off the card."""
        return sum(t1 - t0 for _s, t0, t1 in self.device) if self.device else None


class RequestTensorizer:
    """The host half of an engine: a compiled ruleset's target extractor,
    rule ids and host-pipeline variants, and the window arrays they give
    (``tensorize``). It holds nothing on a device."""

    def __init__(self, compiled: CompiledRuleSet):
        self.compiled = compiled
        self.extractor = TargetExtractor(compiled)
        self.rule_ids = np.asarray([r.rule_id for r in compiled.rules] or [0], dtype=np.int64)
        self.host_pipelines = compiled.host_pipelines()
        # Kinds visible to each host pipeline — rows outside the set skip
        # the (sequential, Python) transform.
        self.host_pipeline_kinds: list[set[int]] = []
        for pid, _names in self.host_pipelines:
            kinds: set[int] = set()
            for link in compiled.links:
                if link.group >= 0 and compiled.group_pipeline[link.group] == pid:
                    kinds.update(link.include_kinds)
            self.host_pipeline_kinds.append(kinds)

    def tensorize(self, extractions: list[Extraction]):
        """The window's nine host arrays: target rows and their kinds, the
        host-pipeline variants, and the numeric variables per request."""
        body_cap = max(_MIN_LEN, self.compiled.program.request_body_limit)
        rows: list[tuple[int, bytes, tuple[int, int, int]]] = []
        for i, ex in enumerate(extractions):
            for t in ex.targets:
                kinds = self.extractor.kind_ids(t)
                if not kinds:
                    continue  # no rule looks at this target
                # Three kind slots per row; extra kinds get duplicate rows.
                for off in range(0, len(kinds), 3):
                    chunk = kinds[off : off + 3]
                    chunk += [0] * (3 - len(chunk))
                    rows.append((i, t.value[:body_cap], tuple(chunk)))

        n_req = _bucket(max(1, len(extractions)))
        n_targets = _bucket_rows(max(1, len(rows)))
        h = len(self.host_pipelines)

        # Host-pipeline variants, only for rows some rule under that
        # pipeline can see.
        variants: list[list[bytes]] = [
            [
                apply_pipeline(value, list(names))[:body_cap]
                if any(k in self.host_pipeline_kinds[hi] for k in kinds if k)
                else b""
                for hi, (_, names) in enumerate(self.host_pipelines)
            ]
            for _, value, kinds in rows
        ]
        max_len = max(
            [len(v) for _, v, _ in rows] + [len(x) for vs in variants for x in vs] + [1]
        )
        length = _bucket(max(_MIN_LEN, max_len))

        data = np.zeros((n_targets, length), dtype=np.uint8)
        lengths = np.zeros(n_targets, dtype=np.int32)
        kind1 = np.zeros(n_targets, dtype=np.int32)
        kind2 = np.zeros(n_targets, dtype=np.int32)
        kind3 = np.zeros(n_targets, dtype=np.int32)
        req_id = np.full(n_targets, n_req, dtype=np.int32)  # padding bucket
        vdata = np.zeros((max(h, 1), n_targets, length), dtype=np.uint8)
        vlengths = np.zeros((max(h, 1), n_targets), dtype=np.int32)

        for row, (ri, value, kinds) in enumerate(rows):
            data[row, : len(value)] = np.frombuffer(value, dtype=np.uint8)
            lengths[row] = len(value)
            kind1[row], kind2[row], kind3[row] = kinds
            req_id[row] = ri
            for hi in range(h):
                hv = variants[row][hi]
                vdata[hi, row, : len(hv)] = np.frombuffer(hv, dtype=np.uint8)
                vlengths[hi, row] = len(hv)

        nv = self.compiled.numvars.n_vars
        numvals = np.zeros((n_req, nv), dtype=np.int32)
        for i, ex in enumerate(extractions):
            for key, value in ex.numerics.items():
                numvals[i, self.compiled.numvars.vars[key]] = value

        return data, lengths, kind1, kind2, kind3, req_id, numvals, vdata, vlengths


class WafEngine:
    """A compiled ruleset plus its batch evaluator on one device
    (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, rules: str | CompiledRuleSet, device=None):
        self.device = resolve_device(device)
        # The compile's stages go to the process's compile log
        # (observability/tracing.py::COMPILES), one record per engine.
        rec = COMPILES.open()
        t = rec.t0

        def stage(name: str, inner_s: float = 0.0) -> None:
            nonlocal t
            t1 = time.monotonic()
            rec.spans.append((name, t1 - t - inner_s))
            t = t1

        timings = {"automata": 0.0}
        if isinstance(rules, CompiledRuleSet):
            self.compiled = rules
            rec.spans += [("parse", 0.0), ("lowering", 0.0)]
        else:
            program = parse(rules)
            stage("parse")
            self.compiled = compile_program(program, timings)
            stage("lowering", timings["automata"])
        rec.spans.append(("automata", timings["automata"]))
        # Two-level automata plan (CKO_AUTOMATA* knobs): hot groups go to
        # joint-byte-class gather banks, prefiltered groups to
        # over-approximating banks whose positives _confirm_prefilter
        # re-checks against the exact DFAs, so verdicts never change.
        from ..compiler.automata_plan import plan_automata

        self.automata_plan = plan_automata(self.compiled)
        layout = plan_layout(self.compiled, self.automata_plan)
        stage("planning")
        timings["upload"] = 0.0
        model = build_model(self.compiled, automata=self.automata_plan, device=self.device,
                            plan=layout, timings=timings)
        stage("build_model", timings["upload"])
        rec.spans.append(("upload", timings["upload"]))
        self.model: WafModel = model
        rec.counters = _compile_counters(self.compiled, model)
        rec.t1 = t
        COMPILES.commit(rec)
        self.compile_record = rec
        self._rows = RequestTensorizer(self.compiled)
        self.extractor = self._rows.extractor
        self._n_real_rules = len(self.compiled.rules)  # model pads to ≥1 row
        self._rule_ids = self._rows.rule_ids
        # rule_id -> phase (the bulk path's body-limit override must not
        # displace a phase-1 interruption, which precedes body ingest).
        self._rule_phase: dict[int, int] = {r.rule_id: r.phase for r in self.compiled.rules}
        self.rule_meta: dict[int, dict] = {
            r.rule_id: {"id": r.rule_id, "msg": r.msg, "severity": r.severity,
                        "tags": list(r.tags)}
            for r in self.compiled.rules
        }
        # Internal synthetic counters (ctl gating) stay out of verdicts.
        self._public_counters: list[tuple[int, str]] = [
            (c, name) for c, name in enumerate(self.compiled.counters)
            if not name.startswith("__")
        ]
        # Kind -> matcher-block bitmask table, collapsed into at most
        # CKO_TIER_PARTS kind classes (cost-greedy, once per engine).
        n_kinds = self.compiled.vocab.n_kinds
        raw = np.zeros(n_kinds + 1, dtype=np.int64)
        for bi, ks in enumerate(self.model.block_kinds):
            if bi >= 62:
                break
            for k in ks:
                if 0 <= k <= n_kinds:
                    raw[k] |= np.int64(1 << bi)
        mask_kinds: dict[int, int] = {}
        for v in raw.tolist():
            if v:
                mask_kinds[int(v)] = mask_kinds.get(int(v), 0) + 1
        distinct = sorted(mask_kinds)
        lut = np.zeros(n_kinds + 1, dtype=np.int64)
        narrow = self._narrow = sum(1 << bi for bi in self.model.narrow_blocks)
        # Rows of a request that can reach a narrow block: at most one per
        # kind, those kinds being single-valued (_narrow_rows).
        self._narrow_kinds = len({k for bi in self.model.narrow_blocks
                                  for k in self.model.block_kinds[bi]})
        self._peak_requests = 0
        if narrow:
            # Narrow segment blocks (plan_segment_blocks): a row reaches one
            # only through its kinds, and a window holds few such rows, so
            # the partition splits rows by that reach alone and keeps even
            # a one-row partition apart; every other block stays on.
            n_blocks = min(62, len(self.model.block_kinds))
            wide = ((1 << n_blocks) - 1) & ~narrow
            lut = wide | (raw & narrow)
        elif distinct:
            clusters = _cluster_masks(
                [(v, mask_kinds[v]) for v in distinct], self.model.block_cost, _TIER_PARTS
            )
            to_class = {}
            for mem, um in clusters:
                for v in mem:
                    to_class[v] = um
            for k in range(n_kinds + 1):
                lut[k] = to_class.get(int(raw[k]), 0)
        self._kind_block_lut = lut
        # Partition mask -> segment columns its rows meet (_seg_work).
        self._seg_cols: dict = {}
        # Cross-window value-hit cache (CKO_VALUE_CACHE_MB, 0 disables).
        from .value_cache import ValueHitCache

        g_total = (
            sum(s.n_groups for s in self.model.segs)
            + sum(b.n_groups for b in self.model.banks)
            + sum(b.n_groups for b in self.model.gather_banks)
            + sum(b.n_groups for b in self.model.pre_banks)
        )
        cache_mb = int(_os.environ.get("CKO_VALUE_CACHE_MB", "256"))
        self.value_cache = (
            ValueHitCache((max(1, g_total) + 7) // 8, cache_mb * 2**20)
            if cache_mb > 0
            else None
        )
        # Prefilter confirmation counters: hits = device prefilter
        # positives, confirms = positives the exact DFA upheld.
        self.prefilter_stats = {"rows": 0, "hits": 0, "confirms": 0, "false_positives": 0}
        self._prefilter_lock = threading.Lock()
        # False until a window has been collected (and after reinit_device).
        self.warmed = False
        # Native host runtime (C++ extraction + tensorization, built at
        # first use); the Python path serves when it is off (CKO_NATIVE=0)
        # or the ruleset needs a transform it lacks.
        from ..native import NativeTensorizer

        self._native = NativeTensorizer(self.compiled)
        # Recent per-window host-assemble walls (blob -> dispatch-ready
        # tensors) for native_stats.
        self.blob_assemble_s: deque[float] = deque(maxlen=4096)
        # Host-twin helpers: _dev_col_of[orig_gid] = device hit column
        # (inverse of model.group_order), and per matcher block (segs,
        # banks, gather banks, prefilter banks: match_tier's column order)
        # its group count, for mask-off zeroing in _host_tier_hits.
        order = self.model.group_order
        self._dev_col_of = np.zeros(max(1, len(order)), dtype=np.int64)
        self._dev_col_of[list(order)] = np.arange(len(order), dtype=np.int64)
        self._block_group_counts = tuple(
            [s.n_groups for s in self.model.segs]
            + [b.n_groups for b in self.model.banks]
            + [b.n_groups for b in self.model.gather_banks]
            + [b.n_groups for b in self.model.pre_banks]
        )
        # Host fallback evaluator, built on first use.
        self._host_fallback = None
        self._host_fallback_lock = threading.Lock()
        # Distinct stage keys (EXEC_CACHE) this engine has dispatched
        # (cko_exec_signatures / CompileReport.exec_signatures).
        self._exec_signatures: set = set()
        # Stage label -> event-measured device seconds of its last 512
        # windows (on the card; _device_intervals), for automata_summary's
        # tier_p50_ms.
        self._stage_device_s: dict[str, deque] = {}
        self._finals_logged = False
        if self.compiled.report.skipped:
            log.info(
                "compiled with skipped rules",
                skipped=len(self.compiled.report.skipped),
                rules=self.compiled.n_rules,
                groups=self.compiled.n_groups,
            )

    # -- batching -----------------------------------------------------------

    def _tensorize(self, extractions: list[Extraction]):
        return self._rows.tensorize(extractions)

    @property
    def native_enabled(self) -> bool:
        return self._native.available

    def reinit_device(self) -> None:
        """Rebuild the model's tensors on ``self.device`` (after a device
        loss): the compiled ruleset is host state and survives; the old
        model's stage graphs go with it. ``warmed`` drops until a device
        window completes again."""
        from .compile_cache import EXEC_CACHE

        EXEC_CACHE.release(self.model)  # its graphs read the old tensors
        self.model = build_model(self.compiled, automata=self.automata_plan, device=self.device)
        self.warmed = False

    @property
    def host_fallback(self):
        """The device-free evaluator over this engine's compiled ruleset
        (``engine/host_fallback.py``); verdicts equal ``evaluate``'s. Built
        once on first access."""
        if self._host_fallback is None:
            with self._host_fallback_lock:
                if self._host_fallback is None:
                    from .host_fallback import HostFallbackEvaluator

                    self._host_fallback = HostFallbackEvaluator(
                        self.compiled, extractor=self.extractor
                    )
        return self._host_fallback

    def tier(self, tensors):
        """Row-level (length x kind-partition) tiering with this engine's
        kind->class-mask table: returns (tiers, numvals, masks)."""
        return tier_tensors(tensors, self._kind_block_lut,
                            narrow=self._narrow_rows(tensors[6].shape[0]))

    def tier_cached(self, tensors):
        """Row-level tiering consulting the value cache: returns (tiers,
        numvals, masks, cached, miss_keys); cached and miss_keys are None
        when the cache is disabled."""
        if self.value_cache is None:
            tiers, numvals, masks = self.tier(tensors)
            return tiers, numvals, masks, None, None
        return tier_tensors(tensors, self._kind_block_lut, cache=self.value_cache,
                            narrow=self._narrow_rows(tensors[6].shape[0]))

    def _narrow_rows(self, n_req: int) -> tuple[int, int]:
        """``(narrow block mask, row floor)`` for a window of ``n_req``
        requests (``tier_tensors``). A partition that reaches a narrow block
        holds at most one row per request for each of its kinds; its rows
        bucket at that bound for the largest window this engine has tiered,
        so that after the first large windows every window up to that size
        gives the partition one shape, however many of its rows the value
        cache serves."""
        if not self._narrow:
            return (0, 0)
        self._peak_requests = max(self._peak_requests, n_req)
        return self._narrow, self._narrow_kinds * self._peak_requests

    def _batch_tensors(self, requests: list[HttpRequest]):
        """Tensorize + tier one request window: (tiers, numvals, masks,
        cached, miss_keys, lease). ``lease`` is the staging-arena lease on
        the tiered native path (the caller releases it once the device
        step has consumed the buffers) and None elsewhere."""
        if self._native.tiered:
            from ..native import serialize_requests

            return self._native.tier_blob(
                serialize_requests(requests), len(requests), self._kind_block_lut,
                self.value_cache, narrow=self._narrow_rows(len(requests)),
            )
        if self._native.available:
            tensors = self._native.tensorize(requests)
        else:
            tensors = self._tensorize([self.extractor.extract(r) for r in requests])
        return self.tier_cached(tensors) + (None,)

    # -- public API ---------------------------------------------------------

    def evaluate(self, requests: list[HttpRequest]) -> list[Verdict]:
        """Evaluate a request window; returns one Verdict per request.
        Exactly ``collect(prepare(requests))``."""
        if not requests:
            return []
        return self.collect(self.prepare(requests))

    def evaluate_one(self, request: HttpRequest) -> Verdict:
        return self.evaluate([request])[0]

    def prepare(self, requests: list[HttpRequest]) -> InFlightBatch:
        """Stage 1: extract + tensorize + tier on the host, then enqueue
        the matcher and post stages on the device."""
        t0 = time.monotonic()
        prog = self.compiled.program
        rejected: dict[int, Verdict] = {}
        if prog.request_body_access and prog.request_body_limit_action == "Reject":
            # SecRequestBodyLimitAction Reject: the 413 happens at body
            # ingest, after phase 1 ran on the headers, so a phase-1 deny
            # wins. Over-limit requests ride one phase-1 window.
            over = [i for i, r in enumerate(requests) if len(r.body) > prog.request_body_limit]
            if over:
                exs = [self.extractor.extract(requests[i], phase1_only=True) for i in over]
                # Reads the pre-pass verdicts back before the window
                # dispatches (Reject windows only), as the reference does.
                early = self._evaluate_extractions(exs, max_phase=1)  # torchlint: ignore[CKO-J004]
                for i, v in zip(over, early):
                    rejected[i] = (
                        v if v.interrupted else Verdict(interrupted=True, status=413, rule_id=None)
                    )
        live = [r for i, r in enumerate(requests) if i not in rejected]
        from ..testing.faults import DeviceFault, poison_marker

        marker = poison_marker()
        if marker is not None and any(marker in r.body for r in live):
            raise DeviceFault("injected poison request (CKO_FAULT_POISON_MARKER)")
        if not live:
            return InFlightBatch(
                out=None, n_live=0, n_requests=len(requests), rejected=rejected,
                miss_keys=None, cache_pop=False, host_s=time.monotonic() - t0,
            )
        tiers, numvals, masks, cached, mkeys, lease = self._batch_tensors(live)
        t_assemble = time.monotonic()
        inflight = self._dispatch_leased(
            lease, tiers, numvals, len(live), masks=masks, cached=cached, miss_keys=mkeys
        )
        inflight.spans.insert(0, ("assemble", t0, t_assemble))
        inflight.n_requests = len(requests)
        inflight.rejected = rejected
        inflight.host_s = time.monotonic() - t0
        return inflight

    def prepare_blob(self, blob, n_req: int) -> InFlightBatch:
        """``prepare`` for a pre-assembled request blob (the
        ``native.serialize_requests`` wire format): with the native library
        the whole window tensorizes in C++ with no per-request Python
        object; without it the blob materializes into requests and
        ``prepare`` runs.

        SecRequestBodyLimitAction Reject parity with ``prepare``: the C++
        tensorizer truncates over-limit bodies at the limit, only those
        requests materialize for the batched phase-1 pre-pass, and their
        413 / phase-1 verdicts land as collect overrides."""
        if not self._native.available:
            from ..native import blob_requests

            return self.prepare(blob_requests(blob, n_req))
        from ..testing.faults import DeviceFault, poison_marker

        marker = poison_marker()
        if marker is not None and marker in blob:
            raise DeviceFault("injected poison request (CKO_FAULT_POISON_MARKER)")
        t0 = time.monotonic()
        prog = self.compiled.program
        overrides: dict[int, Verdict] = {}
        if prog.request_body_access and prog.request_body_limit_action == "Reject":
            from ..native import blob_over_limit, blob_requests

            over = [i for i in blob_over_limit(blob, prog.request_body_limit) if i < n_req]
            if over:
                over_reqs = blob_requests(blob, n_req, wanted=set(over))
                exs = [self.extractor.extract(r, phase1_only=True) for r in over_reqs]
                # As in prepare: the pre-pass verdicts are read back here.
                early = self._evaluate_extractions(exs, max_phase=1)  # torchlint: ignore[CKO-J004]
                for i, v in zip(over, early):
                    overrides[i] = (
                        v if v.interrupted else Verdict(interrupted=True, status=413, rule_id=None)
                    )
        lease = None
        if self._native.tiered:
            # Tiered window pipeline: blob -> tier-bucketed tensors in arena
            # staging buffers, two GIL-released native calls with only the
            # value-cache probe in Python between them.
            tiers, numvals, masks, cached, mkeys, lease = self._native.tier_blob(
                blob, n_req, self._kind_block_lut, self.value_cache,
                narrow=self._narrow_rows(n_req),
            )
        else:
            tensors = self._native.tensorize_blob(blob, n_req)
            tiers, numvals, masks, cached, mkeys = self.tier_cached(tensors)
        t_assemble = time.monotonic()
        self._record_assemble(t_assemble - t0)
        inflight = self._dispatch_leased(
            lease, tiers, numvals, n_req, masks=masks, cached=cached, miss_keys=mkeys
        )
        inflight.spans.insert(0, ("assemble", t0, t_assemble))
        inflight.overrides = overrides or None
        inflight.host_s = time.monotonic() - t0
        return inflight

    def _dispatch_leased(self, lease, *args, **kwargs) -> InFlightBatch:
        """``_dispatch_tiers`` over arena buffers: the window carries the
        lease to ``collect``; a failed dispatch releases it at once."""
        try:
            inflight = self._dispatch_tiers(*args, **kwargs)
        except BaseException:
            if lease is not None:
                lease.release()
            raise
        inflight.arena_lease = lease
        return inflight

    def collect(self, inflight: InFlightBatch) -> list[Verdict]:
        """Stage 2: read the window's outputs back (``.cpu()``, the sync
        point), populate the value cache from its miss rows, decode, then
        release the window's arena lease (in ``finally``: a failed collect
        must not strand the buffers)."""
        try:
            return self._collect(inflight)
        finally:
            if inflight.arena_lease is not None:
                inflight.arena_lease.release()

    def _collect(self, inflight: InFlightBatch) -> list[Verdict]:
        if inflight.out is None:
            return [inflight.rejected[i] for i in range(inflight.n_requests)]
        from ..testing.faults import injected_device_hang_s

        hang = injected_device_hang_s()
        if hang > 0:
            time.sleep(hang)
        t0 = time.monotonic()
        if inflight.cache_pop:
            packed_t, tier_hits = inflight.out
            packed = _numpy(packed_t)
            t_rb = time.monotonic()
            if self.value_cache is not None and inflight.miss_keys is not None:
                for keys, hp in zip(inflight.miss_keys, tier_hits):
                    if keys:
                        self.value_cache.insert(keys, _numpy(hp)[: len(keys)])
        else:
            packed = _numpy(inflight.out)
            t_rb = time.monotonic()
        self.warmed = True
        verdicts = self._decode_packed(packed, inflight.n_live)
        inflight.spans += [("readback_wait", t0, t_rb), ("decode", t_rb, time.monotonic())]
        if inflight.events:
            self._device_intervals(inflight, t_rb)
        if inflight.overrides:
            for i, v in inflight.overrides.items():
                if 0 <= i < len(verdicts):
                    verdicts[i] = v
        if not inflight.rejected:
            return verdicts
        out: list[Verdict] = []
        it = iter(verdicts)
        for i in range(inflight.n_requests):
            out.append(inflight.rejected[i] if i in inflight.rejected else next(it))
        return out

    def _record_assemble(self, dt: float) -> None:
        self.blob_assemble_s.append(dt)

    def native_stats(self) -> dict:
        """Native window-pipeline counters: tiered-path availability,
        window totals and p50, host-assemble p50, and the staging-arena
        pool counters."""
        out = self._native.stats()
        out["available"] = self._native.available
        out["tiered"] = self._native.tiered
        recent = sorted(self.blob_assemble_s)
        out["p50_assemble_ms"] = recent[len(recent) // 2] * 1e3 if recent else 0.0
        return out

    def _dispatch_tiers(
        self, tiers, numvals, n_requests: int, max_phase: int = 2, masks=None,
        cached=None, miss_keys=None,
    ) -> InFlightBatch:
        """Run one tiered window's device stages: one matcher call per
        tier, the prefilter confirm, then the post stage, each stage
        through ``EXEC_CACHE.call`` (eager, captured or replayed). The one
        dispatch site of the synchronous and the pipelined paths. Nothing
        here waits for the device except the prefilter confirm's read of
        the hit rows."""
        from ..ops.segment import finals_cols, finals_tier_requested
        from ..testing.faults import on_device_dispatch
        from .compile_cache import stage_specs

        on_device_dispatch(warmed=self.warmed)
        if masks is None:
            masks = (None,) * len(tiers)
        if not self._finals_logged and finals_tier_requested():
            self._finals_logged = True
            cols = [finals_cols(s.spec) for s in self.model.segs]
            log.info(
                "conv-segment finals tier on",
                blocks=[i for i, n in enumerate(cols) if n],
                finals_columns=sum(cols),
            )
        *match, post = stage_specs(self.model, tiers, numvals, masks, cached, max_phase)
        seg_rows, seg_col_rows = self._seg_work(tiers, masks, n_requests)
        # On the card each stage's device work is bracketed by two CUDA
        # events on the stream it runs on, outside its graph; collect reads
        # them after its read-back (_device_intervals).
        events = [] if self.device.type == "cuda" else None
        stream = torch.cuda.current_stream(self.device).cuda_stream if events is not None else 0
        t0 = time.monotonic()
        match = [(label, fn, _put(args, self.device), st) for label, fn, args, st, _dyn in match]
        _label, post_fn, (_m, _hits, pairs, numvals_t), post_st, post_dyn = _put(post, self.device)
        t1 = time.monotonic()
        tier_hits = tuple(
            self._stage(label, fn, args, st, {}, events, stream) for label, fn, args, st in match
        )
        spans = [("copy_in", t0, t1), ("match_dispatch", t1, time.monotonic())]
        if self.model.prefilter_cols:
            tier_hits = self._confirm_prefilter(tier_hits, tiers, (True,) * len(tiers), spans)
        t3 = spans[-1][2]
        packed = self._stage(
            "post", post_fn, (self.model, tier_hits, pairs, numvals_t), post_st, post_dyn,
            events, stream,
        )
        spans.append(("post_dispatch", t3, time.monotonic()))
        return InFlightBatch(
            out=(packed, tier_hits) if cached is not None else packed,
            n_live=n_requests,
            n_requests=n_requests,
            rejected={},
            miss_keys=miss_keys,
            cache_pop=cached is not None,
            spans=spans,
            events=events,
            seg_rows=seg_rows,
            seg_col_rows=seg_col_rows,
        )

    def _seg_work(self, tiers, masks, n_requests: int) -> tuple[int, int]:
        """(matcher rows, the sum over segment blocks of rows convolved x
        columns) of a window's tiers: a tier's real unique rows (those its
        live pairs read; padding and value-cache rows apart) meet every
        segment block its partition mask scans."""
        rows = col_rows = 0
        for t, m in zip(tiers, masks):
            uid, rid = t[8], t[5]
            n = np.unique(uid[(rid < n_requests) & (uid < t[0].shape[0])]).size
            cols = self._seg_cols.get(m)
            if cols is None:
                cols = self._seg_cols[m] = seg_columns(self.model, m)
            rows += n
            col_rows += n * cols
        return rows, col_rows

    def _stage(self, label: str, fn, args: tuple, statics: dict, dyn: dict, events=None,
               stream: int = 0):
        """``EXEC_CACHE.call(fn, args, statics, dyn)``; with ``events`` (on
        the card) the stage's device work, as the host issues it in one go
        (a replay's graph launch, an eager run), is bracketed by two events
        on ``stream`` (``_StageTimer``). Recording waits for nothing."""
        from .compile_cache import EXEC_CACHE

        key = EXEC_CACHE.key_for(fn, args, statics, dyn)
        with self._prefilter_lock:
            self._exec_signatures.add(key)
            self.compiled.report.exec_signatures = len(self._exec_signatures)
        if events is None:
            return EXEC_CACHE.call(fn, args, statics, dyn)
        return EXEC_CACHE.call(fn, args, statics, dyn, _StageTimer(label, events, stream))

    def _device_intervals(self, inflight: InFlightBatch, t_rb: float) -> None:
        """Put the window's stage events on the host clock, into
        ``inflight.device``. Runs after the final read-back returned (at
        ``t_rb``): every event is complete, so reading them waits for
        nothing. The events give each interval relative to the first; one
        offset per window places them. No event ran before the host
        recorded it (a lower bound on the offset) and the last ran before
        the read-back returned (an upper bound). The offset is the lower
        bound, exact to the launch latency whenever the card was idle when
        some stage's start was recorded, as it mostly is; where the bounds
        cross (clock noise) it is the upper. ``slack_s`` keeps upper -
        lower. Each stage's device seconds also feed ``tier_p50_ms``."""
        events, inflight.events = inflight.events, None
        try:
            ref = events[0][1]
            rel = [(label, STAGE_EVENTS.elapsed_s(ref, e0), STAGE_EVENTS.elapsed_s(ref, e1), t_rec)
                   for label, e0, e1, t_rec in events]
        except (OSError, RuntimeError) as err:  # an event never ran: no intervals
            log.error("stage events unreadable", err)
            return
        finally:
            STAGE_EVENTS.release([e for _label, e0, e1, _t in events for e in (e0, e1)])
        lower = max(t_rec - r0 for _label, r0, _r1, t_rec in rel)
        upper = t_rb - max(r1 for _label, _r0, r1, _t in rel)
        off = min(lower, upper)
        inflight.slack_s = upper - lower
        inflight.device = [(label, off + r0, off + r1) for label, r0, r1, _t in rel]
        with self._prefilter_lock:
            for label, r0, r1, _t in rel:
                self._stage_device_s.setdefault(label, deque(maxlen=512)).append(r1 - r0)

    def _confirm_prefilter(self, tier_hits, tiers, from_device, spans=None):
        """Confirm device prefilter positives against the exact DFAs.

        The pre-bank columns (``model.prefilter_cols``: (device column,
        gid) pairs) carry verdicts of APPROXIMATE automata — a 0 is final,
        a 1 may be spurious. For every positive row, run the exact
        ``DFA.search`` on the same transformed bytes the device saw and
        clear the bit unless it confirms. Patched tiers go back to the
        device re-packed; the value cache then stores exact bits. Entries
        whose ``from_device`` is False (host-twin rows) are exact already
        and pass through. With ``spans`` (ending where the confirm starts)
        each device tier appends its ``confirm_wait`` (the read of its rows)
        and ``confirm_search`` (the exact re-check), end to end."""
        g = int(self.model.e_lg.shape[0])
        cols = self.model.prefilter_cols
        n_rows = n_hits = n_confirms = 0
        out = list(tier_hits)
        t = spans[-1][2] if spans else 0.0
        for ti, (hp, tier, on_dev) in enumerate(zip(tier_hits, tiers, from_device)):
            if not on_dev:
                continue
            # The confirm's one read: the exact re-check runs on the host, as
            # in the reference (its engine/waf.py:1143-1166).
            hits = np.unpackbits(_numpy(hp), axis=1, count=g).astype(bool)  # torchlint: ignore[CKO-J004]
            t_read = time.monotonic()
            n_rows += hits.shape[0] * len(cols)
            d, lg, vd, vl = tier[0], tier[1], tier[6], tier[7]
            val_cache: dict[tuple[int, int], bytes] = {}
            changed = False
            for col, gid in cols:
                rows = np.flatnonzero(hits[:, col])
                if rows.size == 0:
                    continue
                n_hits += int(rows.size)
                pid = self.compiled.group_pipeline[gid]
                slot = int(self.model.host_variant_index[pid])
                dfa = self.compiled.groups[gid].dfa
                for i in rows:
                    i = int(i)
                    val = val_cache.get((pid, i))
                    if val is None:
                        if slot >= 0:
                            val = vd[slot, i, : vl[slot, i]].tobytes()
                        else:
                            names = list(self.compiled.pipelines[pid])
                            val = apply_pipeline(d[i, : lg[i]].tobytes(), names)
                        val_cache[(pid, i)] = val
                    if dfa.search(val):
                        n_confirms += 1
                    else:
                        hits[i, col] = False
                        changed = True
            if changed:
                out[ti] = torch.as_tensor(np.packbits(hits, axis=1), device=self.device)
            if spans is not None:
                t_end = time.monotonic()
                spans += [("confirm_wait", t, t_read), ("confirm_search", t_read, t_end)]
                t = t_end
        if n_rows:
            with self._prefilter_lock:
                self.prefilter_stats["rows"] += n_rows
                self.prefilter_stats["hits"] += n_hits
                self.prefilter_stats["confirms"] += n_confirms
                self.prefilter_stats["false_positives"] += n_hits - n_confirms
        return tuple(out)

    def automata_summary(self) -> dict:
        """Automata-tier composition and prefilter counters for stats and
        metrics: which groups run where (the plan's verdict), how many
        device banks each tier produced, how the prefilter's
        over-approximation pays off, and on the card each stage's p50
        event-measured device time over its last 512 windows."""
        plan = self.automata_plan
        counts = plan.counts()
        with self._prefilter_lock:
            pstats = dict(self.prefilter_stats)
            timing = {
                label: sorted(buf)[len(buf) // 2] * 1000.0
                for label, buf in self._stage_device_s.items()
                if buf
            }
        summary = {
            "enabled": plan.enabled,
            "tiers": counts,
            "gather_banks": len(self.model.gather_banks),
            "pre_banks": len(self.model.pre_banks),
            "prefilter": pstats,
        }
        if timing:
            summary["tier_p50_ms"] = timing
        return summary

    # -- host twins of the device stages --------------------------------------

    def _host_tier_hits(self, tier, mask) -> np.ndarray:
        """Host twin of ``match_tier_packed`` for one tier: walk the host
        fallback's scalar DFAs over the tier's unique rows and return the
        bit-packed hit matrix [U, PB] uint8 in device column order,
        byte-identical to the device matcher's output."""
        d, lg, vd, vl = (np.asarray(tier[i]) for i in (0, 1, 6, 7))
        u = d.shape[0]
        g = int(self.model.e_lg.shape[0])
        hits = np.zeros((u, g), dtype=bool)
        for pid, gids, matcher in self.host_fallback._pipe_groups:
            slot = int(self.model.host_variant_index[pid])
            if slot >= 0:
                # Host-pipeline variant rows were transformed (and re-capped)
                # at tensorize time: reuse them verbatim.
                vals = [vd[slot, i, : vl[slot, i]].tobytes() for i in range(u)]
            else:
                names = list(self.compiled.pipelines[pid])
                vals = [apply_pipeline(d[i, : lg[i]].tobytes(), names) for i in range(u)]
            hits[:, self._dev_col_of[np.asarray(gids)]] = matcher.search_values(vals)
        if mask is not None:
            # Kind-partition parity: the device matcher emits all-False for
            # mask-off blocks (bits 0-61; >= 62 always scanned).
            start = 0
            for bi, n_g in enumerate(self._block_group_counts):
                if bi < 62 and not (mask >> bi) & 1:
                    hits[:, start : start + n_g] = False
                start += n_g
        return np.packbits(hits, axis=1)

    def _host_post(self, tier_hits, pairs, numvals, max_phase, cached) -> np.ndarray:
        """Host twin of ``eval_post_tiered``: unpack each tier's packed hit
        rows (device or host provenance), append cached rows, expand to
        pair rows by uid, drop the padding pair rows, permute columns back
        to original group order for the fallback's link tables, and run
        its NumPy post-match. The packed verdict layout matches
        ``_pack_verdicts`` bit for bit."""
        g = int(self.model.e_lg.shape[0])
        rows, k1s, k2s, k3s, rids = [], [], [], [], []
        for ti, (hp, (k1, k2, k3, rid, uid)) in enumerate(zip(tier_hits, pairs)):
            hu = np.unpackbits(_numpy(hp), axis=1, count=g).astype(bool)
            if cached is not None and cached[ti] is not None:
                cu = np.unpackbits(_numpy(cached[ti]), axis=1, count=g).astype(bool)
                hu = np.concatenate([hu, cu], axis=0)
            rows.append(hu[_numpy(uid)])
            k1s.append(_numpy(k1))
            k2s.append(_numpy(k2))
            k3s.append(_numpy(k3))
            rids.append(_numpy(rid))
        hits = np.concatenate(rows, axis=0)
        rid = np.concatenate(rids)
        real = rid < numvals.shape[0]
        out = self.host_fallback._post_match(
            hits[real][:, self._dev_col_of],
            np.concatenate(k1s)[real],
            np.concatenate(k2s)[real],
            np.concatenate(k3s)[real],
            rid[real],
            _numpy(numvals),
            max_phase,
        )
        return self._pack_verdicts_np(out)

    @staticmethod
    def _pack_verdicts_np(out) -> np.ndarray:
        """NumPy mirror of ``models/waf_model._pack_verdicts``: the same
        [B, 3 + nw + C] int32 layout, so ``unpack_compact`` decodes host-
        and device-packed arrays identically."""
        head = np.stack(
            [
                out["interrupted"].astype(np.int32),
                out["status"].astype(np.int32),
                out["rule_index"].astype(np.int32),
            ],
            axis=1,
        )
        bits = np.packbits(out["matched"].astype(np.uint8), axis=1)
        pad = (-bits.shape[1]) % 4
        if pad:
            bits = np.pad(bits, ((0, 0), (0, pad)))
        words = np.ascontiguousarray(bits).view(np.int32)
        return np.concatenate([head, words, out["scores"].astype(np.int32)], axis=1)

    def _verdicts_from_tiers(
        self, tiers, numvals, n_requests: int, max_phase: int = 2, masks=None,
        cached=None, miss_keys=None,
    ) -> list[Verdict]:
        return self.collect(
            self._dispatch_tiers(
                tiers, numvals, n_requests, max_phase=max_phase, masks=masks,
                cached=cached, miss_keys=miss_keys,
            )
        )

    def _decode_packed(self, packed: np.ndarray, n_requests: int) -> list[Verdict]:
        """Batch numpy decode of the packed verdict array."""
        head, matched, scores = unpack_compact(
            packed, self.model.n_rules, self.model.n_counters
        )
        id_lists = matched_id_lists(matched, self._rule_ids, self._n_real_rules, n_requests)
        head_rows = head[:n_requests].tolist()
        score_rows = scores[:n_requests].tolist()
        counters = self._public_counters
        verdicts: list[Verdict] = []
        for i in range(n_requests):
            interrupted, status, ridx = head_rows[i]
            row = score_rows[i]
            verdicts.append(
                Verdict(
                    interrupted=bool(interrupted),
                    status=int(status),
                    rule_id=int(self._rule_ids[ridx]) if ridx >= 0 else None,
                    matched_ids=id_lists[i],
                    scores={name: row[c] for c, name in counters},
                )
            )
        return verdicts

    # -- warm-up -----------------------------------------------------------

    def batch_signature(self, requests: list[HttpRequest], max_phase: int = 2) -> tuple:
        """The keys the given batch's stages would run under in
        ``EXEC_CACHE``: one per tier's matcher, then the post stage's."""
        from .compile_cache import batch_signature

        tiers, numvals, masks, cached, _mkeys, lease = self._batch_tensors(requests)
        if lease is not None:
            lease.release()  # shapes only; nothing dispatched
        if masks is None:
            masks = (None,) * len(tiers)
        return batch_signature(self.model, tiers, numvals, masks, cached, max_phase)

    def prewarm(self, requests: list[HttpRequest] | None = None) -> dict:
        """Capture the stage graphs of the given batch's signature (default:
        the canonical warmup request), plus those of a synthetic
        ``CKO_PREWARM_BATCH``-request window when that is set, WITHOUT
        serving a window (``EXEC_CACHE.warm``: one eager run of each stage
        on a side stream, then its capture), so first-use costs (kernel
        builds, the allocator, cuDNN's algorithm choice, the captures) are
        paid off the serving path. Stages already captured cost nothing.
        Returns ``{"compiled": a graph was minted, "wall_s": seconds}``."""
        from .compile_cache import EXEC_CACHE, stage_specs

        if requests is None:
            requests = [warmup_request()]
        t0 = time.perf_counter()
        batches = [requests]
        warm_n = int(_os.environ.get("CKO_PREWARM_BATCH", "0"))
        if warm_n > 1:
            from ..corpus import synthetic_requests

            batches.append(synthetic_requests(warm_n, attack_ratio=0.1, seed=7))
        compiled = False
        for batch in batches:
            tiers, numvals, masks, cached, _mkeys, lease = self._batch_tensors(batch)
            try:
                if masks is None:
                    masks = (None,) * len(tiers)
                specs = stage_specs(self.model, tiers, numvals, masks, cached, 2)
                for _label, fn, args, statics, dyn in _put(specs, self.device):
                    compiled = EXEC_CACHE.warm(fn, args, statics, dyn) or compiled
            finally:
                if lease is not None:
                    lease.release()
        return {"compiled": compiled, "wall_s": time.perf_counter() - t0}

    # -- phase-split serving -------------------------------------------------

    def _evaluate_extractions(self, extractions: list, max_phase: int) -> list[Verdict]:
        tiers, numvals, masks, cached, mkeys = self.tier_cached(self._tensorize(extractions))
        return self._verdicts_from_tiers(
            tiers, numvals, len(extractions), max_phase=max_phase, masks=masks,
            cached=cached, miss_keys=mkeys,
        )

    def evaluate_phased(self, requests: list[HttpRequest]) -> list[Verdict]:
        """Two-pass phase-split evaluation: phase-1 rules decide on headers
        before the body is read (pass 1 never touches ``req.body``); only
        requests that survive run the full request phases."""
        if not requests:
            return []
        pass1 = [self.extractor.extract(r, phase1_only=True) for r in requests]
        early = self._evaluate_extractions(pass1, max_phase=1)
        survivors = [i for i, v in enumerate(early) if not v.interrupted]
        if survivors:
            full = self.evaluate([requests[i] for i in survivors])
            for i, verdict in zip(survivors, full):
                early[i] = verdict
        return early

    def evaluate_response(self, request: HttpRequest, response) -> Verdict:
        """Phases 3/4: evaluate the upstream response (plus the request
        context) — RESPONSE_STATUS/HEADERS/STATUS_LINE and, when
        ``SecResponseBodyAccess On``, RESPONSE_BODY up to
        ``SecResponseBodyLimit``."""
        ex = self.extractor.extract(request, response=response)
        return self._evaluate_extractions([ex], max_phase=4)[0]

    def evaluate_bulk_json(self, body: bytes):
        """Evaluate a bulk JSON payload entirely through the native ingest:
        C++ parses the JSON, extracts targets, applies host transforms and
        host ops, and packs rows; Python tiers, dispatches and decodes.
        Returns (verdicts, request_blob), or None when the native path is
        unavailable or the JSON is malformed (the caller then takes the
        schema-error-reporting object path)."""
        if not self._native.available:
            return None
        parsed = self._native.tensorize_json(body)
        if parsed is None:
            return None
        tensors, n_req, blob = parsed
        if n_req == 0:
            return [], blob
        tiers, numvals, masks, cached, mkeys = self.tier_cached(tensors)
        verdicts = self._verdicts_from_tiers(
            tiers, numvals, n_req, masks=masks, cached=cached, miss_keys=mkeys
        )
        prog = self.compiled.program
        if prog.request_body_access and prog.request_body_limit_action == "Reject":
            # Parity with the object path: over-limit bodies are interrupted
            # with 413 (the C++ tensorizer truncates at the limit; the blob
            # keeps full lengths), unless phase 1 already interrupted.
            from ..native import blob_over_limit

            for i in blob_over_limit(blob, prog.request_body_limit):
                if i < n_req and not (
                    verdicts[i].interrupted and self._rule_phase.get(verdicts[i].rule_id, 2) <= 1
                ):
                    verdicts[i] = Verdict(interrupted=True, status=413, rule_id=None)
        return verdicts, blob


def _numpy(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class _StageTimer:
    """``EXEC_CACHE.call``'s timer for one stage on the card: a pooled
    driver-API event (``utils/device.py::STAGE_EVENTS``, which keeps the
    GIL) recorded on ``stream`` just before the stage's device work (an
    eager run, or a replay's graph launch) and one just after; then
    ``(label, start, end, host time the start was recorded)`` goes to
    ``events``. A failing event call raises, as a failing stage does."""

    __slots__ = ("label", "events", "stream", "t_rec", "start")

    def __init__(self, label: str, events: list, stream: int):
        self.label, self.events, self.stream = label, events, stream
        self.t_rec, self.start = 0.0, None

    def __enter__(self):
        self.t_rec = time.monotonic()
        self.start = STAGE_EVENTS.record(self.stream)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            STAGE_EVENTS.release([self.start])
            return False
        self.events.append((self.label, self.start, STAGE_EVENTS.record(self.stream), self.t_rec))
        return False


def _put(x, dev):
    """``x`` (nested tuples, lists and dicts) with each numpy array copied
    to a tensor on ``dev``."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_put(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _put(v, dev) for k, v in x.items()}
    return x
