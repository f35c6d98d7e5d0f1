"""Device WAF model (PyTorch): CompiledRuleSet → dataclass of tensors +
batch evaluation.

Port of ``coraza_kubernetes_operator_tpu/models/waf_model.py``. The
evaluation pipeline is the reference's:

1. transform: apply each distinct device transform pipeline to the target
   buffer (host-only pipelines arrive pre-transformed as variant buffers);
2. match: conv-segment blocks, fused flat bins, per-bank scans, hot-tier
   gather banks and prefilter banks → per-target, per-group hits;
3. incidence: which rules see which targets (variable include/exclude);
4. reduce: targets → requests, AND chain links, anomaly-score counters,
   threshold links;
5. verdict: first-match-wins disruptive decision honoring phases and
   SecRuleEngine mode.

The tables keep the reference's layout and dtypes field by field (so a
model built here is array-equal to the JAX package's, and
``models/convert.py`` can carry one across). Where the reference spelled
a selection as a one-hot matmul (the TPU's gather workaround), the port
indexes: every selection is an exact integer gather, and every integer
sum is taken in float64 or integers, so no result depends on the card's
TF32 setting.
"""

from __future__ import annotations

import dataclasses
import os as _os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.ruleset import (
    CompiledRuleSet,
    DEC_DENY,
    DEC_DROP,
    DEC_REDIRECT,
    LINK_ALWAYS,
    LINK_COUNTER,
    LINK_NEVER,
    LINK_NUMERIC,
    LINK_STRING,
    SCALARS,
)
from ..compiler.segments import Seg, plan_segments
from ..ops.dfa import (
    _DENSE_MAX_STATES,
    DenseTier,
    DFABank,
    _dense_dtype,
    build_dense_tier,
    scan_dense_tier,
    scan_dfa_bank,
    stack_dfas,
)
from ..ops.dfa_flat import build_flat_bank, plan_flat_bins, scan_flat_bank
from ..ops.dfa_gather import (
    GatherBank,
    GatherTier,
    build_gather_tier,
    plan_gather_bins,
    scan_gather_tier,
    stack_gather_bank,
)
from ..ops.segment import SegmentBlock, build_segment_block, conv_n2_cols, match_segment_block
from ..ops.transforms import apply_device_pipeline
from ..utils.device import resolve_device

_BIG = 2**31 - 1

# Conv-tier match-bitmap element budgets (T * (L+2) * N2), as in the
# reference: a tier whose bitmap exceeds the per-chunk budget runs the
# conv matchers over row chunks sized to the budget; only when a SINGLE
# row's bitmap exceeds it does the tier stream through the long-bank DFA
# scans. CKO_SEG_BITMAP_ELEMENTS=0 builds no long banks.
_SEG_BITMAP_ELEMS = int(_os.environ.get("CKO_SEG_BITMAP_ELEMENTS", str(2**30)))
# The per-chunk budget is the reference's (sized for a TPU's HBM) on the
# CPU and 8x larger on the card (80 GB): every chunk re-issues each
# block's whole chain program from the host, so fewer chunks are fewer
# launches. chip_smoke.py reports a window's peak device memory and time;
# CKO_SEG_CHUNK_ELEMENTS sets both budgets, so running it with
# CKO_SEG_CHUNK_ELEMENTS=134217728 times the card at the reference's.
_SEG_CHUNK_ELEMS = int(_os.environ.get("CKO_SEG_CHUNK_ELEMENTS", str(2**27)))
_SEG_CHUNK_ELEMS_CUDA = int(_os.environ.get("CKO_SEG_CHUNK_ELEMENTS", str(2**30)))

# Size buckets for DFA banks (n_states ceiling).
_STATE_BUCKETS = (32, 256, 2048, 16384, 65536)

# Reference planning constants for the block cost ranking (the TPU
# kernel's VMEM budget at block_b = 128); kept so tier partitioning — and
# with it every row's tier — matches the reference.
_PALLAS_VMEM_BUDGET = 11 * 2**20
_PALLAS_BLOCK_B = 128

def _state_bucket(n_states: int) -> int:
    return next(b for b in _STATE_BUCKETS if n_states <= b)


def _pallas_vmem_bytes(s: int, g: int, itemsize: int, length: int) -> int:
    gp = (g + 127) // 128 * 128
    table = 256 * s * gp * itemsize
    work = _PALLAS_BLOCK_B * s * gp * 4 * 2
    data_tile = length * _PALLAS_BLOCK_B * 4 * 2
    return table + work + data_tile


@dataclass
class WafModel:
    """Tensors of one compiled ruleset on one device, plus static metadata."""

    banks: list[DFABank]
    segs: list[SegmentBlock]
    # link arrays [Rl]
    ltype: torch.Tensor
    lneg: torch.Tensor
    lgroup: torch.Tensor
    lnumvar: torch.Tensor
    lcmp: torch.Tensor
    lcmparg: torch.Tensor
    lcounter: torch.Tensor
    # incidence [K, Rl]
    inc: torch.Tensor
    exc: torch.Tensor
    # The reference's matmul operands, kept array-equal; the port selects
    # by index (lgroup, and the argmax rows of e_numvar / e_counter).
    e_lg: torch.Tensor  # [G, Rl] int8 one-hot of lgroup
    m_count: torch.Tensor  # [Rl, Rr] int8: multiplicity of link l in rule r
    link_count: torch.Tensor  # [Rr] int32
    e_numvar: torch.Tensor  # [NV, Rl] f32 one-hot of the numvar column
    e_counter: torch.Tensor  # [C, Rl] f32 one-hot of the counter column
    removal: torch.Tensor  # [Rr, Rr] int8
    # rule arrays [Rr]
    link_matrix: torch.Tensor  # [Rr, MX]
    link_mask: torch.Tensor  # [Rr, MX]
    decision: torch.Tensor
    status: torch.Tensor
    order_key: torch.Tensor
    phase: torch.Tensor
    # counters
    weights: torch.Tensor  # [Rr, C]
    counter_base: torch.Tensor  # [C]
    # Long-buffer fallback banks (every segment-routed group's DFA).
    long_banks: list = field(default_factory=list)
    seg_perm: torch.Tensor | None = None  # [Gs, Gs] one-hot: long order → seg order
    flat_banks: list = field(default_factory=list)
    gather_banks: list = field(default_factory=list)
    # Approximate prefilter banks: their columns may over-match by design;
    # the engine confirms positives on the host before the post stage.
    pre_banks: list = field(default_factory=list)
    # static metadata
    bank_pipelines: tuple = field(default_factory=tuple)
    seg_pipelines: tuple = field(default_factory=tuple)
    long_bank_pipelines: tuple = field(default_factory=tuple)
    pipelines: tuple = field(default_factory=tuple)
    pipeline_device: tuple = field(default_factory=tuple)
    host_variant_index: tuple = field(default_factory=tuple)
    engine_on: bool = True
    detection_only: bool = False
    has_removals: bool = False
    removal_rows: tuple = ()
    block_kinds: tuple = ()
    block_cost: tuple = ()
    two_pass_counters: bool = False
    flat_covered: tuple = ()
    group_order: tuple = ()
    gather_bank_pipelines: tuple = field(default_factory=tuple)
    pre_bank_pipelines: tuple = field(default_factory=tuple)
    prefilter_cols: tuple = ()
    # Derived index forms of the one-hot operands (built in __post_init__).
    numvar_col: torch.Tensor | None = field(default=None, init=False, repr=False)
    counter_col: torch.Tensor | None = field(default=None, init=False, repr=False)
    long_col: torch.Tensor | None = field(default=None, init=False, repr=False)
    # Every gather bank, and every prefilter bank, laid out for one fused
    # launch per tier.
    gather_tier: GatherTier | None = field(default=None, init=False, repr=False, compare=False)
    pre_tier: DenseTier | None = field(default=None, init=False, repr=False, compare=False)
    # Segment blocks split off for single-valued kinds (plan_segment_blocks):
    # the second block of a pipeline, among the first 62 blocks (those a
    # partition mask names). The engine keeps the rows that cannot reach
    # them in a partition of their own.
    narrow_blocks: tuple = field(default=(), init=False)

    def __post_init__(self):
        self.numvar_col = self.e_numvar.argmax(dim=0)
        self.counter_col = self.e_counter.argmax(dim=0)
        sp = self.seg_pipelines
        self.narrow_blocks = tuple(i for i in range(1, min(62, len(sp))) if sp[i] == sp[i - 1])
        if self.seg_perm is not None:
            # seg column c reads long column long_col[c]
            self.long_col = self.seg_perm.to(torch.int32).argmax(dim=0)
        if self.gather_banks:
            self.gather_tier = build_gather_tier(self.gather_banks, self.gather_bank_pipelines)
        if self.pre_banks:
            self.pre_tier = build_dense_tier(self.pre_banks, self.pre_bank_pipelines)

    @property
    def device(self) -> torch.device:
        return self.ltype.device

    @property
    def n_rules(self) -> int:
        return int(self.decision.shape[0])

    @property
    def n_counters(self) -> int:
        return int(self.counter_base.shape[0])


def lgroup_onehot(lgroup: np.ndarray, n_groups: int) -> np.ndarray:
    """[G, Rl] int8 one-hot of each link's group id."""
    e_lg = np.zeros((n_groups, len(lgroup)), dtype=np.int8)
    for i, g in enumerate(lgroup):
        e_lg[g, i] = 1
    return e_lg


@dataclass
class LayoutPlan:
    """Where ``build_model`` puts each group (``plan_layout``)."""

    seg_groups: dict  # pipeline -> [(gid, SegmentPlan)]
    buckets: dict  # (pipeline, state bucket) -> [gid]: generic DFA banks
    hot_buckets: dict  # the same for dfa-hot gather banks
    pre_buckets: dict  # the same for prefilter banks (approximate DFAs)
    approx_of: dict  # gid -> its approximate DFA
    gkind_sets: list  # gid -> the kinds its string links include
    scalar_kinds: frozenset  # kinds of single-valued variables


def plan_layout(crs: CompiledRuleSet, automata=None) -> LayoutPlan:
    """Route every group to its matcher tier (``build_model`` then splits
    the segment groups into blocks, ``plan_segment_blocks``)."""
    seg_groups: dict[int, list[tuple[int, object]]] = {}
    buckets: dict[tuple[int, int], list[int]] = {}
    hot_buckets: dict[tuple[int, int], list[int]] = {}
    pre_buckets: dict[tuple[int, int], list[int]] = {}
    approx_of: dict[int, object] = {}
    tier_of = {t.gid: t for t in automata.tiers} if automata is not None else {}
    for gid, grp in enumerate(crs.groups):
        pid = crs.group_pipeline[gid]
        plan = plan_segments(grp.dfa.ast)
        if plan is not None:
            seg_groups.setdefault(pid, []).append((gid, plan))
            continue
        entry = tier_of.get(gid)
        if entry is not None and entry.kind == "dfa-hot":
            hot_buckets.setdefault((pid, _state_bucket(grp.dfa.n_states)), []).append(gid)
            continue
        if entry is not None and entry.kind == "prefiltered" and entry.approx is not None:
            approx_of[gid] = entry.approx
            pre_buckets.setdefault(
                (pid, _state_bucket(entry.approx.n_states)), []
            ).append(gid)
            continue
        buckets.setdefault((pid, _state_bucket(grp.dfa.n_states)), []).append(gid)
    gkind_sets: list[set[int]] = [set() for _ in range(max(1, len(crs.groups)))]
    for link in crs.links:
        if link.link_type == LINK_STRING and link.group >= 0:
            gkind_sets[link.group].update(link.include_kinds)
    scalar = frozenset(kid for (coll, sel), kid in crs.vocab.kinds.items()
                       if coll in SCALARS and sel is None)
    return LayoutPlan(seg_groups, buckets, hot_buckets, pre_buckets, approx_of, gkind_sets,
                      scalar)


def _plan_cols(items) -> int:
    """Conv columns of segment groups, counted from their plans: one per
    segment of each branch."""
    return sum(max(1, sum(isinstance(el, Seg) for br in plan.branches for el in br.elements))
               for _gid, plan in items)


def plan_segment_blocks(seg_groups: dict, gkind_sets: list, scalar_kinds: frozenset,
                        row_cost: float) -> list:
    """Segment blocks as ``(pipeline, items)``, in pipeline order: one per
    pipeline, or two where a narrow block pays (the second).

    Every row whose kinds reach a block is convolved against all of its
    columns, and at serving windows every row reaches every block (small
    partitions merge, ``engine/waf.py::tier_tensors``). A pipeline's
    largest set of groups whose kinds are one set of single-valued kinds
    (scalar variables: at most one row each per request) can form a narrow
    block of its own, after the pipeline's other groups; the engine then
    keeps every row that cannot reach it in a partition apart. Per request,
    counting one row for each of the block's other kinds, that takes the
    set's columns off those rows. It costs a second partition, which holds
    at most one row per request for each of the set's kinds, is bucketed at
    that bound, and scans every block: ``row_cost`` (the model's
    ``block_cost`` summed, the segment blocks' columns counted from their
    plans) for each of them. The set is split off only when the first
    outweighs the second. (crs-lite's largest candidate, RESPONSE_BODY's
    176 columns in ``t:none`` beside 23 other kinds, saves 4,048 against a
    row cost of ~10,700, so crs-lite keeps one block per pipeline.)"""
    out = []
    for pid in sorted(seg_groups):
        items = seg_groups[pid]
        kinds: set[int] = set()
        by_kinds: dict[frozenset, list] = {}
        for gid, plan in items:
            ks = frozenset(gkind_sets[gid])
            kinds |= ks
            if ks and ks <= scalar_kinds:
                by_kinds.setdefault(ks, []).append((gid, plan))
        narrow_kinds, narrow = max(by_kinds.items(), key=lambda kv: _plan_cols(kv[1]),
                                   default=(frozenset(), []))
        picked = {gid for gid, _plan in narrow}
        rest = [(gid, plan) for gid, plan in items if gid not in picked]
        saving = _plan_cols(narrow) * len(kinds - narrow_kinds)
        if rest and narrow and saving > len(narrow_kinds) * row_cost:
            out += [(pid, rest), (pid, narrow)]
        else:
            out.append((pid, items))
    return out


def _bank_costs(bank_dfas, covered, gather_banks, pre_banks) -> list[float]:
    """The reference's per-row cost of each non-segment block, in block
    order: generic DFA banks, given as the DFAs ``stack_dfas`` stacks
    (``covered`` holds the indexes of those a flat bin scans), gather banks,
    prefilter banks."""
    costs: list[float] = []
    for bi, dfas in enumerate(bank_dfas):
        s, g = max(d.n_states for d in dfas), len(dfas)
        if bi in covered:
            costs.append(0.5 * s * g)
        elif s > _DENSE_MAX_STATES:  # no dense table
            costs.append(1000.0 * g)
        elif (
            _pallas_vmem_bytes(s, g, np.dtype(_dense_dtype(s)).itemsize, 64)
            <= _PALLAS_VMEM_BUDGET
        ):
            costs.append(0.5 * s * max(g, 128))
        else:
            costs.append(8.0 * s * g)
    for gb in gather_banks:
        factor = max(0.1, gb.n_classes / 256.0)
        costs.append(0.5 * factor * gb.n_states * max(gb.n_groups, 128))
    for pb in pre_banks:
        s, g = pb.n_states, pb.n_groups
        costs.append(0.5 * s * max(g, 128))
    return costs


def build_model(
    crs: CompiledRuleSet, automata=None, device=None, dfa_banks: bool = True,
    plan: LayoutPlan | None = None, timings: dict | None = None,
) -> WafModel:
    """Lay out a CompiledRuleSet as tensors on the host, then move them to
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``) in one
    pass; ``timings``, when given, receives that move's seconds as
    ``upload``. Groups are re-ordered exactly as the reference orders them:
    segment blocks by pipeline (a pipeline's narrow block after its other
    one, ``plan_segment_blocks``), then DFA buckets by (pipeline, bucket),
    then gather banks, then prefilter banks. ``automata`` (an
    ``AutomataPlan`` or None) turns on the two-level automata layout
    (hot-tier gather banks and approximate prefilter banks); ``plan`` is
    ``plan_layout(crs, automata)``'s, made here when None.
    ``dfa_banks=False`` routes the DFA buckets' groups but keeps neither
    their banks nor the flat bins over them (the sharded model builds its
    own slices of those buckets)."""
    device = resolve_device(device)
    host = torch.device("cpu")
    if plan is None:
        plan = plan_layout(crs, automata)
    seg_groups, buckets, hot_buckets = plan.seg_groups, plan.buckets, plan.hot_buckets
    pre_buckets, approx_of, gkind_sets = plan.pre_buckets, plan.approx_of, plan.gkind_sets

    # The other tiers' blocks first: their groups' columns follow every
    # segment group's, and the segment blocks' split weighs their costs.
    remap = np.zeros(max(1, len(crs.groups)), dtype=np.int64)
    n_seg_groups = sum(len(v) for v in seg_groups.values())
    next_new = n_seg_groups

    bank_pipelines: list[int] = []
    bank_gids: list[list[int]] = []
    for (pid, _bucket), gids in sorted(buckets.items()):
        bank_pipelines.append(pid)
        bank_gids.append(list(gids))
        for g in gids:
            remap[g] = next_new
            next_new += 1
    bank_dfas = [[crs.groups[g].dfa for g in gids] for gids in bank_gids]

    gather_banks: list[GatherBank] = []
    gather_bank_pipelines: list[int] = []
    gather_bank_gids: list[list[int]] = []
    for (pid, _bucket), gids in sorted(hot_buckets.items()):
        dfas = [crs.groups[g].dfa for g in gids]
        for bin_ in plan_gather_bins(dfas):
            members = [gids[i] for i in bin_]
            gather_banks.append(
                stack_gather_bank([crs.groups[g].dfa for g in members], device=host)
            )
            gather_bank_pipelines.append(pid)
            gather_bank_gids.append(members)
            for g in members:
                remap[g] = next_new
                next_new += 1

    pre_banks: list[DFABank] = []
    pre_bank_pipelines: list[int] = []
    pre_bank_gids: list[list[int]] = []
    prefilter_cols: list[tuple[int, int]] = []
    for (pid, _bucket), gids in sorted(pre_buckets.items()):
        pre_banks.append(stack_dfas([approx_of[g] for g in gids], device=host))
        pre_bank_pipelines.append(pid)
        pre_bank_gids.append(list(gids))
        for g in gids:
            prefilter_cols.append((next_new, g))
            remap[g] = next_new
            next_new += 1

    # Flat-slot fused bins (CKO_FLAT=0 keeps every generic bank on its own
    # scan), planned over bank indexes. The planner keeps the reference's
    # budgets, so the bins — and the column order match_tier stitches —
    # equal the reference's.
    bins: list = []
    if _os.environ.get("CKO_FLAT", "1") != "0" and bank_dfas:
        bins, _rejected = plan_flat_bins([
            (bi, bank_pipelines[bi], dfas) for bi, dfas in enumerate(bank_dfas)
        ])
    covered = {piece[0] for bn in bins for piece in bn}
    row_cost = sum(_plan_cols(v) for v in seg_groups.values()) + sum(
        _bank_costs(bank_dfas, covered, gather_banks, pre_banks))
    if not dfa_banks:
        bank_pipelines, bank_gids, bank_dfas, bins, covered = [], [], [], [], set()
    banks: list[DFABank] = [stack_dfas(dfas, device=host) for dfas in bank_dfas]

    seg_blocks = plan_segment_blocks(seg_groups, gkind_sets, plan.scalar_kinds, row_cost)
    next_new = 0
    segs: list[SegmentBlock] = []
    seg_pipelines: list[int] = []
    for pid, items in seg_blocks:
        segs.append(build_segment_block([p for _, p in items], device=host))
        seg_pipelines.append(pid)
        for g, _ in items:
            remap[g] = next_new
            next_new += 1
    n_segs_blocks = len(segs)
    flat_banks_built = [
        build_flat_bank([(n_segs_blocks + bi, *rest) for bi, *rest in bn], device=host)
        for bn in bins
    ]
    flat_covered = {n_segs_blocks + bi for bi in covered}

    long_banks: list[DFABank] = []
    long_bank_pipelines: list[int] = []
    long_order: list[int] = []
    if _SEG_BITMAP_ELEMS > 0:
        long_buckets: dict[tuple[int, int], list[int]] = {}
        for pid in sorted(seg_groups):
            for gid, _plan in seg_groups[pid]:
                key = (pid, _state_bucket(crs.groups[gid].dfa.n_states))
                long_buckets.setdefault(key, []).append(gid)
        for (pid, _bucket), gids in sorted(long_buckets.items()):
            long_banks.append(stack_dfas([crs.groups[g].dfa for g in gids], device=host))
            long_bank_pipelines.append(pid)
            long_order.extend(gids)
    n_seg_groups = sum(len(v) for v in seg_groups.values())
    seg_perm = None
    if long_order:
        perm = np.zeros((len(long_order), n_seg_groups), dtype=np.int8)
        for j, gid in enumerate(long_order):
            perm[j, remap[gid]] = 1
        seg_perm = perm

    host_variant_index = []
    slot = 0
    for dev in crs.pipeline_device:
        if dev:
            host_variant_index.append(-1)
        else:
            host_variant_index.append(slot)
            slot += 1

    rl = max(1, len(crs.links))
    ltype = np.full(rl, LINK_NEVER, dtype=np.int32)
    lneg = np.zeros(rl, dtype=bool)
    lgroup = np.zeros(rl, dtype=np.int32)
    lnumvar = np.zeros(rl, dtype=np.int32)
    lcmp = np.zeros(rl, dtype=np.int32)
    lcmparg = np.zeros(rl, dtype=np.int32)
    lcounter = np.zeros(rl, dtype=np.int32)
    k = crs.vocab.n_kinds
    inc = np.zeros((k, rl), dtype=bool)
    exc = np.zeros((k, rl), dtype=bool)
    for i, link in enumerate(crs.links):
        ltype[i] = link.link_type
        lneg[i] = link.negated
        if link.link_type == LINK_STRING:
            lgroup[i] = remap[link.group]
            for kid in link.include_kinds:
                inc[kid, i] = True
            for kid in link.exclude_kinds:
                exc[kid, i] = True
        lnumvar[i] = max(0, link.numvar)
        lcmp[i] = link.cmp
        lcmparg[i] = link.cmp_arg
        lcounter[i] = max(0, link.counter)

    rr = max(1, len(crs.rules))
    mx = max([len(r.link_ids) for r in crs.rules] or [1])
    link_matrix = np.zeros((rr, mx), dtype=np.int32)
    link_mask = np.zeros((rr, mx), dtype=bool)
    decision = np.zeros(rr, dtype=np.int32)
    status = np.zeros(rr, dtype=np.int32)
    order_key = np.full(rr, 2**31 - 1, dtype=np.int32)
    phase = np.full(rr, 99, dtype=np.int32)
    for i, rule in enumerate(crs.rules):
        for j, lid in enumerate(rule.link_ids):
            link_matrix[i, j] = lid
            link_mask[i, j] = True
        decision[i] = rule.decision
        status[i] = rule.status
        order_key[i] = rule.order_key
        phase[i] = rule.phase

    weights = crs.weights if crs.weights.size else np.zeros((rr, 1), dtype=np.int32)
    if weights.shape[0] != rr:
        padded = np.zeros((rr, weights.shape[1]), dtype=np.int32)
        padded[: weights.shape[0]] = weights
        weights = padded

    e_lg = lgroup_onehot(lgroup, max(1, len(crs.groups)))
    m_count = np.zeros((rl, rr), dtype=np.int8)
    link_count = np.zeros(rr, dtype=np.int32)
    for i, rule in enumerate(crs.rules):
        link_count[i] = len(rule.link_ids)
        for lid in rule.link_ids:
            m_count[lid, i] += 1
    nv = max(1, crs.numvars.n_vars if hasattr(crs, "numvars") else 1)
    n_counters = weights.shape[1]
    e_numvar = np.zeros((nv, rl), dtype=np.float32)
    e_counter = np.zeros((n_counters, rl), dtype=np.float32)
    for i in range(rl):
        e_numvar[min(lnumvar[i], nv - 1), i] = 1.0
        e_counter[min(lcounter[i], n_counters - 1), i] = 1.0

    # ctl:ruleRemoveById/ByTag: a match of rule i disables every LATER rule
    # j whose id/tag it names.
    removal = np.zeros((rr, rr), dtype=np.int8)
    has_removals = False
    for i, r in enumerate(crs.rules):
        if not r.ctl_remove_ranges and not r.ctl_remove_tags:
            continue
        for j, r2 in enumerate(crs.rules):
            if j == i or r2.order_key <= r.order_key:
                continue
            hit = any(lo <= r2.rule_id <= hi for lo, hi in r.ctl_remove_ranges)
            if not hit and r.ctl_remove_tags:
                hit = any(t in r2.tags for t in r.ctl_remove_tags)
            if hit:
                removal[i, j] = 1
                has_removals = True
    removal_rows = tuple(
        sorted(
            (i for i in range(rr) if i < len(crs.rules) and removal[i].any()),
            key=lambda i: crs.rules[i].order_key,
        )
    )

    # Kind-partitioned matching constants, computed as the reference does
    # (the costs only rank blocks for tier_tensors' clustering).
    block_kinds: list[tuple[int, ...]] = []
    for _pid, items in seg_blocks:
        ks: set[int] = set()
        for gid, _plan in items:
            ks |= gkind_sets[gid]
        block_kinds.append(tuple(sorted(ks)))
    for gids in bank_gids + gather_bank_gids + pre_bank_gids:
        ks = set()
        for gid in gids:
            ks |= gkind_sets[gid]
        block_kinds.append(tuple(sorted(ks)))
    block_cost = [float(conv_n2_cols(seg.spec)) for seg in segs]
    block_cost += _bank_costs(bank_dfas, covered, gather_banks, pre_banks)
    n_g = len(crs.groups)
    order_arr = np.zeros(n_g, dtype=np.int64)
    order_arr[remap[:n_g]] = np.arange(n_g, dtype=np.int64)
    group_order = tuple(int(x) for x in order_arr)

    w_np = np.asarray(weights)
    two_pass_counters = any(
        any(crs.links[l].link_type == LINK_COUNTER for l in r.link_ids) and w_np[i].any()
        for i, r in enumerate(crs.rules)
    )

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=host)

    model = WafModel(
        banks=banks,
        segs=segs,
        ltype=put(ltype),
        lneg=put(lneg),
        lgroup=put(lgroup),
        lnumvar=put(lnumvar),
        lcmp=put(lcmp),
        lcmparg=put(lcmparg),
        lcounter=put(lcounter),
        inc=put(inc),
        exc=put(exc),
        e_lg=put(e_lg),
        m_count=put(m_count),
        link_count=put(link_count),
        e_numvar=put(e_numvar),
        e_counter=put(e_counter),
        removal=put(removal),
        link_matrix=put(link_matrix),
        link_mask=put(link_mask),
        decision=put(decision),
        status=put(status),
        order_key=put(order_key),
        phase=put(phase),
        weights=put(weights.astype(np.int32)),
        counter_base=put(
            crs.counter_base if crs.counter_base.size else np.zeros(1, np.int32)
        ),
        long_banks=long_banks,
        seg_perm=None if seg_perm is None else put(seg_perm),
        flat_banks=flat_banks_built,
        gather_banks=gather_banks,
        pre_banks=pre_banks,
        bank_pipelines=tuple(bank_pipelines),
        seg_pipelines=tuple(seg_pipelines),
        long_bank_pipelines=tuple(long_bank_pipelines),
        pipelines=tuple(tuple(p) for p in crs.pipelines),
        pipeline_device=tuple(crs.pipeline_device),
        host_variant_index=tuple(host_variant_index),
        engine_on=crs.engine_mode != "Off",
        detection_only=crs.engine_mode == "DetectionOnly",
        has_removals=has_removals,
        removal_rows=removal_rows,
        block_kinds=tuple(block_kinds),
        block_cost=tuple(block_cost),
        two_pass_counters=two_pass_counters,
        flat_covered=tuple(sorted(flat_covered)),
        group_order=group_order,
        gather_bank_pipelines=tuple(gather_bank_pipelines),
        pre_bank_pipelines=tuple(pre_bank_pipelines),
        prefilter_cols=tuple(prefilter_cols),
    )
    if device != host:
        t0 = time.monotonic()
        model = _to_device(model, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if timings is not None:
            timings["upload"] = time.monotonic() - t0
    stray = [t.device for t in _tensors(model)
             if t.device.type != device.type or device.index not in (None, t.device.index)]
    if stray:
        raise AssertionError(f"build_model left tensors on {stray[0]}, not {device}")
    return model


def _to_device(v, device):
    """``v`` with every tensor it holds moved to ``device``: dataclasses
    (rebuilt from their init fields, so derived fields are made there and
    caches start empty), tuples, lists and dicts are walked."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{f.name: _to_device(getattr(v, f.name), device)
                                         for f in dataclasses.fields(v) if f.init})
    if isinstance(v, (tuple, list)):
        return type(v)(_to_device(x, device) for x in v)
    if isinstance(v, dict):
        return {k: _to_device(x, device) for k, x in v.items()}
    return v


def _tensors(v):
    """Every tensor ``v`` holds, walked as ``_to_device`` walks it."""
    if isinstance(v, torch.Tensor):
        yield v
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            if f.init:
                yield from _tensors(getattr(v, f.name))
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _tensors(x)
    elif isinstance(v, dict):
        for x in v.values():
            yield from _tensors(x)


def table_bytes(model) -> int:
    """Bytes of the tensors ``model`` holds, its banks' included."""
    return sum(t.numel() * t.element_size() for t in _tensors(model))


def seg_columns(model: WafModel, mask: int | None) -> int:
    """Conv columns a row of a tier with kind-partition ``mask`` is
    convolved against: those of every segment block the mask scans."""
    return sum(conv_n2_cols(seg.spec) for i, seg in enumerate(model.segs)
               if mask is None or i >= 62 or (mask >> i) & 1)


def segment_tier_hits(
    segs,
    seg_pipelines,
    long_banks,
    long_bank_pipelines,
    long_col,
    data: torch.Tensor,
    transformed_for,
    keep: tuple[int, ...] | None = None,
) -> list:
    """Hit blocks for the segment-routed groups. The conv tier
    materializes ~[T, L+2, N2] match-bitmap elements, so beyond the
    per-chunk budget the rows run in chunks (a Python loop over the same
    convs, bounded peak memory); only when a SINGLE row's bitmap exceeds
    the budget does the tier stream through the long-bank DFA scans (same
    groups, seg-column order restored through ``long_col``).

    ``keep`` lists the seg-block indexes the caller's rows can reach;
    skipped blocks contribute all-False hit columns. The long-bank path
    scans everything."""
    if not segs:
        return []
    if keep is None:
        keep = tuple(range(len(segs)))
    t = data.shape[0]

    def zeros_for(i):
        return torch.zeros((t, segs[i].n_groups), dtype=torch.bool, device=data.device)

    def direct(rows=slice(None)):
        out = []
        for i in range(len(segs)):
            if i not in keep:
                out.append(zeros_for(i)[rows])
                continue
            td, tl = transformed_for(seg_pipelines[i])
            out.append(match_segment_block(segs[i].kernel, segs[i].spec, td[rows], tl[rows],
                                           cache=segs[i].finals, consts=segs[i].consts))
        return out

    n_seg_cols = sum(conv_n2_cols(segs[i].spec) for i in keep)
    per_row = (data.shape[1] + 2) * max(1, n_seg_cols)
    bitmap_elems = t * per_row
    budget = _SEG_CHUNK_ELEMS_CUDA if data.device.type == "cuda" else _SEG_CHUNK_ELEMS
    rows_fit = max(0, budget // max(1, per_row)) // 8 * 8
    if bitmap_elems <= budget or not keep:
        return direct()
    if rows_fit >= 8:
        # Row-chunked conv tier: rows are independent, so each chunk runs
        # every kept block and the chunks concatenate in row order.
        chunks = [direct(slice(r0, r0 + rows_fit)) for r0 in range(0, t, rows_fit)]
        return [torch.cat([c[i] for c in chunks], dim=0) for i in range(len(segs))]
    if bool(long_banks) and _SEG_BITMAP_ELEMS > 0:
        long_cols = [
            scan_dfa_bank(bank, *transformed_for(pid))
            for bank, pid in zip(long_banks, long_bank_pipelines)
        ]
        lh = torch.cat(long_cols, dim=1)  # [T, Gs] in long order
        return [lh[:, long_col]]  # [T, Gs] in seg-column order
    return direct()


def _compare(cmp: torch.Tensor, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Vectorized six-way comparison (codes from operators.CMP_CODES)."""
    out = torch.zeros(torch.broadcast_shapes(cmp.shape, left.shape), dtype=torch.bool,
                      device=left.device)
    for code, res in enumerate(
        (left == right, left != right, left >= right, left > right, left <= right, left < right)
    ):
        out = torch.where(cmp == code, res, out)
    return out


def match_tier(
    model: WafModel,
    data: torch.Tensor,  # [T, L] uint8
    lengths: torch.Tensor,  # [T] int32
    variant_data: torch.Tensor,  # [H, T, L]
    variant_lengths: torch.Tensor,  # [H, T]
    mask: int | None = None,
) -> torch.Tensor:
    """Stages 1+2 for ONE length tier: transforms + matchers → per-target
    group hits [T, G], in build_model's global column order.

    ``mask`` is the kind-partition block bitmask: bit i set = scan block i
    (segs, then banks, then gather banks, then prefilter banks). Blocks at
    index >= 62 are always scanned. A skipped block contributes all-False
    hits, which is exact for rows whose kinds cannot reach it."""
    per_block: list[torch.Tensor] = []
    transformed: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
    t = data.shape[0]
    n_segs = len(model.segs)

    def block_on(i: int) -> bool:
        return mask is None or i >= 62 or (mask >> i) & 1 == 1

    def zeros(g: int) -> torch.Tensor:
        return torch.zeros((t, g), dtype=torch.bool, device=data.device)

    def transformed_for(pid: int) -> tuple[torch.Tensor, torch.Tensor]:
        if pid not in transformed:
            slot = model.host_variant_index[pid]
            if slot >= 0:
                transformed[pid] = (variant_data[slot], variant_lengths[slot])
            else:
                transformed[pid] = apply_device_pipeline(data, lengths, model.pipelines[pid])
        return transformed[pid]

    per_block.extend(
        segment_tier_hits(
            model.segs,
            model.seg_pipelines,
            model.long_banks,
            model.long_bank_pipelines,
            model.long_col,
            data,
            transformed_for,
            keep=tuple(i for i in range(n_segs) if block_on(i)),
        )
    )
    # Flat bins: a bin runs when ANY of its blocks is mask-on.
    flat_cols: dict[int, dict[int, torch.Tensor]] = {}
    for fb in model.flat_banks:
        if not any(block_on(p[0]) for p in fb.pieces):
            continue
        out = scan_flat_bank(fb, {p: transformed_for(p) for p in fb.pipeline_ids})
        col = 0
        for blk, g_lo, g_hi in fb.pieces:
            w = g_hi - g_lo
            flat_cols.setdefault(blk, {})[g_lo] = out[:, col : col + w]
            col += w
    for bi, (bank, pid) in enumerate(zip(model.banks, model.bank_pipelines)):
        blk = n_segs + bi
        if not block_on(blk):
            per_block.append(zeros(bank.n_groups))
        elif blk in model.flat_covered:
            pieces = flat_cols[blk]
            per_block.append(torch.cat([pieces[k] for k in sorted(pieces)], dim=1))
        else:
            per_block.append(scan_dfa_bank(bank, *transformed_for(pid)))
    n_banks = len(model.banks)

    def fused_tier(scan, tier, on) -> torch.Tensor:
        """``scan`` over a fused tier, transforming only the pipelines a
        mask-on bank reads."""
        if not any(on):
            return zeros(tier.n_groups)
        read = {slot for slot, flag in zip(tier.pipe_slot, on) if flag}
        inputs = [transformed_for(pid) if k in read else None for k, pid in enumerate(tier.pipelines)]
        return scan(tier, inputs, on)

    gt = model.gather_tier
    if gt is not None:
        # Every gather bank in one launch; mask-off banks give zeros.
        on = tuple(block_on(n_segs + n_banks + gi) for gi in range(len(gt.banks)))
        per_block.append(fused_tier(scan_gather_tier, gt, on))
    n_gather = len(model.gather_banks)
    pt = model.pre_tier
    if pt is not None:
        # Every prefilter bank in one launch; mask-off banks give zeros.
        on = tuple(block_on(n_segs + n_banks + n_gather + pi) for pi in range(len(pt.banks)))
        per_block.append(fused_tier(scan_dense_tier, pt, on))
    if per_block:
        return torch.cat(per_block, dim=1)  # [T, G]
    return zeros(1)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """[N, M] bool → [N, ceil(M/8)] uint8, big bit order: byte-identical to
    ``np.packbits(bits, axis=1)`` (the value cache's and the reference's
    hit-row layout). The bit weights 128 .. 1 are made on the device, so a
    call copies nothing from the host (a CUDA graph captures it)."""
    n, m = bits.shape
    nb = (m + 7) // 8
    x = torch.nn.functional.pad(bits.to(torch.int32), (0, nb * 8 - m)).reshape(n, nb, 8)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (x << shifts).sum(dim=2).to(torch.uint8)


def _unpack_hit_rows(packed: torch.Tensor, g: int) -> torch.Tensor:
    """[U, PB] uint8 (np.packbits layout) → [U, G] bool."""
    u, pb = packed.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(u, pb * 8)[:, :g].to(torch.bool)


def _kind_rows(table: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """table[kind] for a [K, Rl] bool table, all-False for kinds outside
    [0, K) (the reference's one-hot compare selects nothing there)."""
    k = table.shape[0]
    ok = (kind >= 0) & (kind < k)
    rows = table[kind.clamp(0, k - 1).to(torch.int64)]
    return rows & ok[:, None]


def post_match(
    model: WafModel,
    group_hits: torch.Tensor,  # [T, G] bool
    kind1: torch.Tensor,
    kind2: torch.Tensor,
    kind3: torch.Tensor,
    req_id: torch.Tensor,
    numvals: torch.Tensor,  # [B, NV] int32
    max_phase: int = 2,
):
    """Stages 3-5: incidence, reductions, counters, verdict. Every step is
    integer or boolean: index gathers, an integer scatter-add, and float64
    sums of integer products (exact, whatever the TF32 setting)."""
    b = numvals.shape[0]
    dev = group_hits.device

    # 3: incidence + per-target link matches.
    gm = group_hits[:, model.lgroup.to(torch.int64)]  # [T, Rl]
    rel = _kind_rows(model.inc, kind1) | _kind_rows(model.inc, kind2) | _kind_rows(model.inc, kind3)
    excl = _kind_rows(model.exc, kind1) | _kind_rows(model.exc, kind2) | _kind_rows(model.exc, kind3)
    str_t = rel & ~excl & (gm ^ model.lneg[None, :])  # [T, Rl]

    # 4a: targets → requests. Padding rows carry req_id == B and land in a
    # spare row that is cut off.
    rid = req_id.to(torch.int64).clamp(0, b)
    acc = torch.zeros((b + 1, str_t.shape[1]), dtype=torch.int32, device=dev)
    acc.index_add_(0, rid, str_t.to(torch.int32))
    m_str = acc[:b] > 0  # [B, Rl]

    # 4b: numeric links: numvals[:, numvar column], exact for all of int32.
    vals = numvals[:, model.numvar_col]  # [B, Rl]
    lneg = model.lneg[None, :]
    m_num = _compare(model.lcmp[None, :], vals, model.lcmparg[None, :]) ^ lneg
    m_always = (~lneg).expand_as(m_str)
    m_never = lneg.expand_as(m_str)

    lt = model.ltype[None, :]
    link_m = torch.zeros_like(m_str)  # counter links False in the prelim pass
    for code, val in (
        (LINK_STRING, m_str),
        (LINK_NUMERIC, m_num),
        (LINK_ALWAYS, m_always),
        (LINK_NEVER, m_never),
    ):
        link_m = torch.where(lt == code, val, link_m)

    lmat = model.link_matrix.to(torch.int64)
    lmask = model.link_mask

    def rules_from_links(lm: torch.Tensor) -> torch.Tensor:
        # AND over each rule's links (masked slots count as matched).
        return (lm[:, lmat] | ~lmask[None]).all(dim=2)  # [B, Rr]

    prelim = rules_from_links(link_m)

    removed = None
    if model.has_removals:
        removed = torch.zeros_like(prelim)
        rem = model.removal != 0
        for c in model.removal_rows:
            fires = prelim[:, c] & ~removed[:, c]
            removed = removed | (fires[:, None] & rem[c][None, :])
        prelim = prelim & ~removed

    # 4c: anomaly-score counters + threshold links. float64 sums of
    # integer products are exact (|sum| < 2^53), then cast as the
    # reference casts its float32 sum.
    w64 = model.weights.to(torch.float64)

    def add_weights(base: torch.Tensor, rules: torch.Tensor) -> torch.Tensor:
        return base + (rules.to(torch.float64) @ w64).to(torch.int32)

    counters = add_weights(model.counter_base[None, :].expand(b, -1), prelim)
    cvals = counters[:, model.counter_col]
    m_counter = _compare(model.lcmp[None, :], cvals, model.lcmparg[None, :]) ^ lneg
    link_m = torch.where(lt == LINK_COUNTER, m_counter, link_m)
    matched = rules_from_links(link_m)
    if removed is not None:
        matched = matched & ~removed

    if model.two_pass_counters:
        # Rules gated on a counter link are absent from prelim; add their
        # weights and re-resolve the counter links.
        extra = matched & ~prelim
        counters = add_weights(counters, extra)
        cvals = counters[:, model.counter_col]
        m_counter = _compare(model.lcmp[None, :], cvals, model.lcmparg[None, :]) ^ lneg
        link_m = torch.where(lt == LINK_COUNTER, m_counter, link_m)
        matched = rules_from_links(link_m)
        if removed is not None:
            matched = matched & ~removed

    # 5: verdict — first matched decision rule in phase order.
    in_scope = (model.decision[None, :] != 0) & (model.phase[None, :] <= max_phase)
    big = torch.full_like(model.order_key, _BIG)[None, :]
    keys = torch.where(matched & in_scope, model.order_key[None, :], big)
    first_key, first_idx = keys.min(dim=1)
    has_decision = first_key < _BIG
    dec = model.decision[first_idx]
    interrupts = (dec == DEC_DENY) | (dec == DEC_DROP) | (dec == DEC_REDIRECT)
    engine_active = model.engine_on and not model.detection_only
    interrupted = has_decision & interrupts & engine_active
    status = torch.where(interrupted, model.status[first_idx], torch.full_like(first_key, 200))
    rule_index = torch.where(has_decision, first_idx, torch.full_like(first_idx, -1))

    return {
        "matched": matched,  # [B, Rr]
        "interrupted": interrupted,  # [B]
        "status": status,  # [B]
        "rule_index": rule_index,  # [B]
        "scores": counters,  # [B, C]
    }


def _pack_verdicts(out) -> torch.Tensor:
    """Pack the verdict dict into ONE int32 tensor [B, 3 + nw + C]:
    (interrupted, status, rule_index), then the matched bits packed as
    ``np.packbits`` bytes read as little-endian int32 words, then the
    counters — byte-identical to the reference's layout, which
    ``unpack_compact`` reads through a raw byte view."""
    b = out["status"].shape[0]
    head = torch.stack(
        [
            out["interrupted"].to(torch.int32),
            out["status"].to(torch.int32),
            out["rule_index"].to(torch.int32),
        ],
        dim=1,
    )
    bits = packbits(out["matched"])
    nb = bits.shape[1]
    pad = (-nb) % 4
    bits = torch.nn.functional.pad(bits, (0, pad)).contiguous()
    words = bits.view(torch.int32).reshape(b, (nb + pad) // 4)
    return torch.cat([head, words, out["scores"].to(torch.int32)], dim=1)


def match_tier_packed(
    model: WafModel,
    data: torch.Tensor,  # [U, L] uint8 unique-value rows
    lengths: torch.Tensor,  # [U]
    variant_data: torch.Tensor,  # [H, U, L]
    variant_lengths: torch.Tensor,  # [H, U]
    mask: int | None = None,
) -> torch.Tensor:
    """One tier's matcher stage: transforms + matchers over the tier's
    unique rows, bit-packed to [U, PB] uint8 (np.packbits layout — the
    format the value cache stores and ``eval_post_tiered`` unpacks)."""
    return packbits(match_tier(model, data, lengths, variant_data, variant_lengths, mask=mask))


def eval_post_tiered(
    model: WafModel,
    tier_hits,  # tuple of [U, PB] uint8 per tier (packed matcher rows)
    pairs,  # tuple of (kind1, kind2, kind3, req_id, uid) per tier
    numvals: torch.Tensor,
    max_phase: int = 2,
    cached=None,  # aligned tuple of [Uc, PB] uint8 or None per tier
) -> torch.Tensor:
    """The post stage: unpack each tier's hit rows, append its cached rows,
    expand to pair rows via uid, run ONE global post_match, pack."""
    g = model.e_lg.shape[0]
    hits, k1s, k2s, k3s, rids = [], [], [], [], []
    for ti, (hp, (k1, k2, k3, rid, uid)) in enumerate(zip(tier_hits, pairs)):
        hu = _unpack_hit_rows(hp, g)
        if cached is not None and cached[ti] is not None:
            hu = torch.cat([hu, _unpack_hit_rows(cached[ti], g)], dim=0)
        hits.append(hu[uid.to(torch.int64)])  # [P, G] pair rows
        k1s.append(k1)
        k2s.append(k2)
        k3s.append(k3)
        rids.append(rid)
    out = post_match(
        model,
        torch.cat(hits, dim=0),
        torch.cat(k1s),
        torch.cat(k2s),
        torch.cat(k3s),
        torch.cat(rids),
        numvals,
        max_phase,
    )
    return _pack_verdicts(out)


def unpack_compact(packed: np.ndarray, n_rules: int, n_counters: int):
    """Host-side split of the packed verdict array (numpy)."""
    nb = (n_rules + 7) // 8
    nw = (nb + 3) // 4
    head = packed[:, :3]
    words = np.ascontiguousarray(packed[:, 3 : 3 + nw])
    bits = words.view(np.uint8).reshape(packed.shape[0], nw * 4)[:, :nb]
    matched = np.unpackbits(bits, axis=1, count=n_rules).astype(bool)
    scores = packed[:, 3 + nw : 3 + nw + n_counters]
    return head, matched, scores


def matched_id_lists(
    matched: np.ndarray,
    rule_ids: np.ndarray,
    n_real_rules: int,
    n_requests: int,
) -> list[list[int]]:
    """Per-request matched-rule-id lists from the unpacked matched matrix
    in one vectorized pass (column order preserved)."""
    m = matched[:n_requests, :n_real_rules]  # drop the >=1-row pad rule
    req_idx, rule_idx = np.nonzero(m)
    if req_idx.size == 0:
        return [[] for _ in range(n_requests)]
    ids = rule_ids[rule_idx]
    splits = np.searchsorted(req_idx, np.arange(1, n_requests))
    return [a.tolist() for a in np.split(ids, splits)]
