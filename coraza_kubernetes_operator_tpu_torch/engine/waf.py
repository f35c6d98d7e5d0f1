"""WafEngine (PyTorch): compile once, evaluate request windows on the card.

Port of ``coraza_kubernetes_operator_tpu/engine/waf.py`` on its Python
tensorize path. One window is ``collect(prepare(requests))``:

1. ``prepare``: extract targets, tensorize (``_tensorize``), split rows
   into (length x kind-partition) tiers with value dedup and the
   cross-window value cache (``tier_tensors``), then run each tier's
   matcher stage (``match_tier_packed``), confirm approximate prefilter
   hits on the host (``_confirm_prefilter``) and run the post stage
   (``eval_post_tiered``). PyTorch runs eagerly, so the stages are plain
   calls: there is no executable to compile or cache.
2. ``collect``: read the packed verdict array back with ``.cpu()`` (the
   window's sync point), fill the value cache and decode the verdicts.

Shapes are bucketed exactly as the reference buckets them, so a window
tiers into the same rows and widths on both.
"""

from __future__ import annotations

import os as _os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.ruleset import CompiledRuleSet, compile_rules
from ..compiler.transforms_host import apply_pipeline
from ..models.waf_model import (
    WafModel,
    build_model,
    eval_post_tiered,
    match_tier_packed,
    matched_id_lists,
    unpack_compact,
)
from ..utils import get_logger
from ..utils.device import resolve_device
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


def tier_tensors(tensors, kind_lut=None, cache=None):
    """Split one wide tensorized batch into row-level (length x kind
    partition) tiers of unique rows (numpy, host side).

    Input is the 9-tuple from ``WafEngine._tensorize``; output is
    ``(tiers, numvals, masks)`` where tiers is a tuple of per-tier
    ``(data, lengths, kind1, kind2, kind3, req_id, vdata, vlengths, uid)``
    and masks the aligned block bitmasks (None when ``kind_lut`` is
    absent). With ``cache`` (a ``ValueHitCache``) the return grows to
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
            u_pad = _bucket_rows(max(1, usel.size))
            cpk = np.zeros(
                (_bucket_rows(max(1, len(found))), cache.packed_len), dtype=np.uint8
            )
            remap = np.zeros(len(ukeys), dtype=np.int32)
            for r, j in enumerate(miss):
                remap[j] = r
            for r, (j, row) in enumerate(sorted(found.items())):
                cpk[r] = row
                remap[j] = u_pad + r

        u = _bucket_rows(max(1, usel.size))
        d = np.zeros((u, length), dtype=np.uint8)
        d[: usel.size] = data[usel, :length]
        lg = np.zeros(u, dtype=np.int32)
        lg[: usel.size] = lengths[usel]
        vd = np.zeros((max(h, 1), u, length), dtype=np.uint8)
        vl = np.zeros((max(h, 1), u), dtype=np.int32)
        if h and usel.size:
            vd[:, : usel.size] = vdata[:, usel, :length]
            vl[:, : usel.size] = vlengths[:, usel]

        p = _bucket_rows(max(1, sel.size))
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
        while len(parts) > 1 and parts[-1][0].size < _MIN_PART_ROWS:
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
    # Stage timings: host_s by prepare; device_s / decode_s by collect.
    host_s: float = 0.0
    device_s: float = 0.0
    decode_s: float = 0.0


class WafEngine:
    """A compiled ruleset plus its batch evaluator on one device
    (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, rules: str | CompiledRuleSet, device=None):
        self.device = resolve_device(device)
        self.compiled = rules if isinstance(rules, CompiledRuleSet) else compile_rules(rules)
        # Two-level automata plan (CKO_AUTOMATA* knobs): hot groups go to
        # joint-byte-class gather banks, prefiltered groups to
        # over-approximating banks whose positives _confirm_prefilter
        # re-checks against the exact DFAs, so verdicts never change.
        from ..compiler.automata_plan import plan_automata

        self.automata_plan = plan_automata(self.compiled)
        self.model: WafModel = build_model(
            self.compiled, automata=self.automata_plan, device=self.device
        )
        self.extractor = TargetExtractor(self.compiled)
        self._n_real_rules = len(self.compiled.rules)  # model pads to ≥1 row
        self._rule_ids = np.asarray(
            [r.rule_id for r in self.compiled.rules] or [0], dtype=np.int64
        )
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
        self._host_pipelines = self.compiled.host_pipelines()
        # Kinds visible to each host pipeline — rows outside the set skip
        # the (sequential, Python) transform.
        self._host_pipeline_kinds: list[set[int]] = []
        for pid, _names in self._host_pipelines:
            kinds: set[int] = set()
            for link in self.compiled.links:
                if link.group >= 0 and self.compiled.group_pipeline[link.group] == pid:
                    kinds.update(link.include_kinds)
            self._host_pipeline_kinds.append(kinds)
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
        if distinct:
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
        if self.compiled.report.skipped:
            log.info(
                "compiled with skipped rules",
                skipped=len(self.compiled.report.skipped),
                rules=self.compiled.n_rules,
                groups=self.compiled.n_groups,
            )

    # -- batching -----------------------------------------------------------

    def _tensorize(self, extractions: list[Extraction]):
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
        h = len(self._host_pipelines)

        # Host-pipeline variants, only for rows some rule under that
        # pipeline can see.
        variants: list[list[bytes]] = [
            [
                apply_pipeline(value, list(names))[:body_cap]
                if any(k in self._host_pipeline_kinds[hi] for k in kinds if k)
                else b""
                for hi, (_, names) in enumerate(self._host_pipelines)
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

    def tier_cached(self, tensors):
        """Row-level tiering consulting the value cache: returns (tiers,
        numvals, masks, cached, miss_keys); cached and miss_keys are None
        when the cache is disabled."""
        if self.value_cache is None:
            tiers, numvals, masks = tier_tensors(tensors, self._kind_block_lut)
            return tiers, numvals, masks, None, None
        return tier_tensors(tensors, self._kind_block_lut, cache=self.value_cache)

    def _batch_tensors(self, requests: list[HttpRequest]):
        """Tensorize + tier one request window: (tiers, numvals, masks,
        cached, miss_keys)."""
        extractions = [self.extractor.extract(r) for r in requests]
        return self.tier_cached(self._tensorize(extractions))

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
        t0 = time.perf_counter()
        prog = self.compiled.program
        rejected: dict[int, Verdict] = {}
        if prog.request_body_access and prog.request_body_limit_action == "Reject":
            # SecRequestBodyLimitAction Reject: the 413 happens at body
            # ingest, after phase 1 ran on the headers, so a phase-1 deny
            # wins. Over-limit requests ride one phase-1 window.
            over = [i for i, r in enumerate(requests) if len(r.body) > prog.request_body_limit]
            if over:
                exs = [self.extractor.extract(requests[i], phase1_only=True) for i in over]
                early = self._evaluate_extractions(exs, max_phase=1)
                for i, v in zip(over, early):
                    rejected[i] = (
                        v if v.interrupted else Verdict(interrupted=True, status=413, rule_id=None)
                    )
        live = [r for i, r in enumerate(requests) if i not in rejected]
        if not live:
            return InFlightBatch(
                out=None, n_live=0, n_requests=len(requests), rejected=rejected,
                miss_keys=None, cache_pop=False, host_s=time.perf_counter() - t0,
            )
        tiers, numvals, masks, cached, mkeys = self._batch_tensors(live)
        inflight = self._dispatch_tiers(
            tiers, numvals, len(live), masks=masks, cached=cached, miss_keys=mkeys
        )
        inflight.n_requests = len(requests)
        inflight.rejected = rejected
        inflight.host_s = time.perf_counter() - t0
        return inflight

    def collect(self, inflight: InFlightBatch) -> list[Verdict]:
        """Stage 2: read the window's outputs back (``.cpu()``, the sync
        point), populate the value cache from its miss rows, decode."""
        if inflight.out is None:
            return [inflight.rejected[i] for i in range(inflight.n_requests)]
        t0 = time.perf_counter()
        if inflight.cache_pop:
            packed_t, tier_hits = inflight.out
            packed = packed_t.cpu().numpy()
            if self.value_cache is not None and inflight.miss_keys is not None:
                for keys, hp in zip(inflight.miss_keys, tier_hits):
                    if keys:
                        self.value_cache.insert(keys, _numpy(hp)[: len(keys)])
        else:
            packed = inflight.out.cpu().numpy()
        t1 = time.perf_counter()
        inflight.device_s = t1 - t0
        verdicts = self._decode_packed(packed, inflight.n_live)
        inflight.decode_s = time.perf_counter() - t1
        if not inflight.rejected:
            return verdicts
        out: list[Verdict] = []
        it = iter(verdicts)
        for i in range(inflight.n_requests):
            out.append(inflight.rejected[i] if i in inflight.rejected else next(it))
        return out

    def _dispatch_tiers(
        self, tiers, numvals, n_requests: int, max_phase: int = 2, masks=None,
        cached=None, miss_keys=None,
    ) -> InFlightBatch:
        """Run one tiered window's device stages: one matcher call per
        tier, the prefilter confirm, then the post stage."""
        dev = self.device

        def put(a):
            return torch.as_tensor(a, device=dev)

        if masks is None:
            masks = (None,) * len(tiers)
        tier_hits = tuple(
            match_tier_packed(self.model, put(t[0]), put(t[1]), put(t[6]), put(t[7]), mask=mask)
            for t, mask in zip(tiers, masks)
        )
        if self.model.prefilter_cols:
            tier_hits = self._confirm_prefilter(tier_hits, tiers)
        pairs = tuple(tuple(put(t[i]) for i in (2, 3, 4, 5, 8)) for t in tiers)
        cached_t = (
            None if cached is None else tuple(None if c is None else put(c) for c in cached)
        )
        packed = eval_post_tiered(
            self.model, tier_hits, pairs, put(numvals), max_phase=max_phase, cached=cached_t
        )
        return InFlightBatch(
            out=(packed, tier_hits) if cached is not None else packed,
            n_live=n_requests,
            n_requests=n_requests,
            rejected={},
            miss_keys=miss_keys,
            cache_pop=cached is not None,
        )

    def _confirm_prefilter(self, tier_hits, tiers):
        """Confirm device prefilter positives against the exact DFAs.

        The pre-bank columns (``model.prefilter_cols``: (device column,
        gid) pairs) carry verdicts of APPROXIMATE automata — a 0 is final,
        a 1 may be spurious. For every positive row, run the exact
        ``DFA.search`` on the same transformed bytes the device saw and
        clear the bit unless it confirms. Patched tiers go back to the
        device re-packed; the value cache then stores exact bits."""
        g = int(self.model.e_lg.shape[0])
        cols = self.model.prefilter_cols
        n_rows = n_hits = n_confirms = 0
        out = list(tier_hits)
        for ti, (hp, tier) in enumerate(zip(tier_hits, tiers)):
            hits = np.unpackbits(_numpy(hp), axis=1, count=g).astype(bool)
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
        if n_rows:
            with self._prefilter_lock:
                self.prefilter_stats["rows"] += n_rows
                self.prefilter_stats["hits"] += n_hits
                self.prefilter_stats["confirms"] += n_confirms
                self.prefilter_stats["false_positives"] += n_hits - n_confirms
        return tuple(out)

    def _evaluate_extractions(self, extractions: list, max_phase: int) -> list[Verdict]:
        tiers, numvals, masks, cached, mkeys = self.tier_cached(self._tensorize(extractions))
        return self.collect(
            self._dispatch_tiers(
                tiers, numvals, len(extractions), max_phase=max_phase, masks=masks,
                cached=cached, miss_keys=mkeys,
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


def _numpy(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
