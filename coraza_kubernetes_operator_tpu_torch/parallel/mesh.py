"""Sharded WAF evaluation over a ('data', 'rule') device mesh.

Port of ``coraza_kubernetes_operator_tpu/parallel/mesh.py`` in
``torch.distributed``'s idiom: one process (rank) per device, each
running the same program on its own shard. A rank's coordinates in the
mesh pick its work:

- its **rule** coordinate picks the slice of every DFA bank bucket it
  scans: each bucket is split evenly across the rule axis and padded with
  never-matching DFAs (the reference's layout), and a rank builds only its
  own slice's bank;
- its **data** coordinate picks its requests: ``requests[i::d]``.

Per window each rank scans its bank slices, runs the replicated segment
tier, all-gathers its per-target hit bits [T, W] as uint8 over the mesh's
``rule`` group (the one collective on the hit path; gloo has no bool),
stitches them in the gathered layout and runs the shared post stage. The
verdicts are then gathered over the ``data`` group, so every rank returns
all of them in input order. NCCL serves a ``cuda`` mesh and gloo a ``cpu``
one; a ``cuda`` mesh without a card raises, with no fallback.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..compiler.re_dfa import DFA
from ..compiler.ruleset import CompiledRuleSet
from ..models.waf_model import (
    _STATE_BUCKETS,
    WafModel,
    build_model,
    lgroup_onehot,
    post_match,
    segment_tier_hits,
)
from ..ops.dfa import DFABank, scan_dfa_bank, stack_dfas
from ..ops.transforms import apply_device_pipeline


def make_mesh(n_data: int, n_rule: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (n_data, n_rule), dims named ("data",
    "rule"), over the initialised default process group, whose world size
    must be ``n_data * n_rule``."""
    from torch.distributed.device_mesh import init_device_mesh

    need = n_data * n_rule
    if not dist.is_initialized():
        raise ValueError(f"need {need} ranks, and no process group is initialised")
    have = dist.get_world_size()
    if have != need:
        raise ValueError(f"need {need} ranks, have {have}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device, and none is available")
    return init_device_mesh(device_type, (n_data, n_rule), mesh_dim_names=("data", "rule"))


def _never_dfa() -> DFA:
    return DFA(
        trans=np.zeros((1, 1), dtype=np.int32),
        emit=np.zeros((1, 1), dtype=bool),
        match_end=np.zeros(1, dtype=bool),
        classmap=np.zeros(256, dtype=np.int32),
        always_match=False,
    )


@dataclass
class ShardedWafModel:
    """One rank's rule shard: its slice of every bank bucket, the
    replicated segment tier, and a banks-free post-match model whose
    ``lgroup`` is remapped to the gathered layout.

    The conv-segment tier is **replicated** across rule shards (its
    kernel is tiny and its cost per target row is far below one DFA
    bank's); only the DFA banks shard over the rule axis. Global group
    order: segment blocks (sorted by pipeline) first, then sharded DFA
    buckets in gathered layout."""

    banks: list[DFABank]  # this shard's slice of each bucket
    segs: list  # SegmentBlock, replicated
    post: WafModel  # banks == [] — post-match arrays only
    bank_pipelines: tuple  # pipeline id per bucket bank
    seg_pipelines: tuple
    bucket_widths: tuple  # groups-per-shard per bucket bank
    pipelines: tuple
    host_variant_index: tuple
    n_rule_shards: int = 1


def build_sharded_model(
    crs: CompiledRuleSet, n_rule_shards: int, shard: int = 0, device=None
) -> ShardedWafModel:
    """Rule shard ``shard`` of ``n_rule_shards`` on ``device`` (the card
    unless the caller passes ``device="cpu"``)."""
    if not 0 <= shard < n_rule_shards:
        raise ValueError(f"shard {shard} outside [0, {n_rule_shards})")
    # Routing, segment blocks, long banks and post arrays as build_model
    # lays them out (segment groups route first there too), without its
    # DFA bucket banks: this rank builds only its slice of each bucket.
    base = build_model(crs, device=device, dfa_banks=False)
    device = base.device

    from ..compiler.segments import plan_segments

    seg_groups: dict[int, list[int]] = {}
    buckets: dict[tuple[int, int], list[int]] = {}
    for gid, grp in enumerate(crs.groups):
        pid = crs.group_pipeline[gid]
        if plan_segments(grp.dfa.ast) is not None:
            seg_groups.setdefault(pid, []).append(gid)
            continue
        s = grp.dfa.n_states
        bucket = next(b for b in _STATE_BUCKETS if s <= b)
        buckets.setdefault((pid, bucket), []).append(gid)

    remap = np.zeros(max(1, len(crs.groups)), dtype=np.int64)
    offset = 0
    for pid in sorted(seg_groups):
        for g in seg_groups[pid]:
            remap[g] = offset
            offset += 1
    if tuple(sorted(seg_groups)) != base.seg_pipelines:
        raise AssertionError("segment routing differs from build_model's")

    banks: list[DFABank] = []
    bank_pipelines: list[int] = []
    bucket_widths: list[int] = []
    for (pid, _bucket), gids in sorted(buckets.items()):
        width = max(1, math.ceil(len(gids) / n_rule_shards))
        for s in range(n_rule_shards):
            for j, g in enumerate(gids[s * width : (s + 1) * width]):
                # Gathered layout: bucket-major, then shard, then slot.
                remap[g] = offset + s * width + j
        # Every shard pads to the bucket's largest state count, as the
        # reference stacks its shards on one [S, C] layout.
        s_max = max(crs.groups[g].dfa.n_states for g in gids)
        dfas = [crs.groups[g].dfa for g in gids[shard * width : (shard + 1) * width]]
        dfas += [_never_dfa()] * (width - len(dfas))
        banks.append(stack_dfas(dfas, min_states=s_max, device=device))
        bank_pipelines.append(pid)
        bucket_widths.append(width)
        offset += n_rule_shards * width

    # lgroup in the ORIGINAL compiled link order, remapped to gathered ids.
    rl = int(base.lgroup.shape[0])
    lgroup = np.zeros(rl, dtype=np.int32)
    for i, link in enumerate(crs.links):
        lgroup[i] = remap[link.group] if link.group >= 0 else 0
    e_lg = lgroup_onehot(lgroup, max(1, offset))

    # The long-buffer fallback banks are replicated (like the seg tier) and
    # ride inside `post`. Their columns land in seg order via seg_perm —
    # identical leading layout in both the single-device and gathered group
    # orders (segs first).
    post = dataclasses.replace(
        base,
        banks=[],
        segs=[],
        flat_banks=[],
        gather_banks=[],
        pre_banks=[],
        lgroup=torch.as_tensor(lgroup, device=device),
        e_lg=torch.as_tensor(e_lg, device=device),
        bank_pipelines=(),
        seg_pipelines=(),
        gather_bank_pipelines=(),
        pre_bank_pipelines=(),
        prefilter_cols=(),
        flat_covered=(),
    )

    return ShardedWafModel(
        banks=banks,
        segs=base.segs,
        post=post,
        bank_pipelines=tuple(bank_pipelines),
        seg_pipelines=base.seg_pipelines,
        bucket_widths=tuple(bucket_widths),
        pipelines=base.pipelines,
        host_variant_index=base.host_variant_index,
        n_rule_shards=n_rule_shards,
    )


def eval_waf_sharded(mesh, model: ShardedWafModel, tensors: tuple) -> dict:
    """Evaluate this rank's data shard (``_tensorize``'s nine tensors on
    this rank's device) against its rule shard; returns ``post_match``'s
    outputs for the shard's requests, equal on every rank of its ``rule``
    group."""
    n_rule = model.n_rule_shards
    post = model.post
    data, lengths, k1, k2, k3, req_id, numvals, vdata, vlengths = tensors
    transformed: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def transformed_for(pid):
        if pid not in transformed:
            slot = model.host_variant_index[pid]
            if slot >= 0:
                transformed[pid] = (vdata[slot], vlengths[slot])
            else:
                transformed[pid] = apply_device_pipeline(data, lengths, model.pipelines[pid])
        return transformed[pid]

    # Segment tier: replicated (identical on every rule shard). Long shape
    # buckets take the same constant-memory DFA fallback as the
    # single-device path — the shared helper keys the budget off the
    # per-shard shape, which is the per-device bitmap that matters.
    cols = list(segment_tier_hits(
        model.segs,
        model.seg_pipelines,
        post.long_banks,
        post.long_bank_pipelines,
        post.long_col,
        data,
        transformed_for,
    ))
    per_bucket = [scan_dfa_bank(bank, *transformed_for(pid))
                  for bank, pid in zip(model.banks, model.bank_pipelines)]
    t = data.shape[0]
    if per_bucket:
        sub = torch.cat(per_bucket, dim=1).to(torch.uint8)  # [T, sum(width)]
        # The one collective: per-target hit bits across rule shards.
        gathered = [torch.empty_like(sub) for _ in range(n_rule)]
        dist.all_gather(gathered, sub, group=mesh.get_group("rule"))
        stacked = torch.stack(gathered).to(torch.bool)  # [R, T, W]
        o = 0
        for width in model.bucket_widths:
            blk = stacked[:, :, o : o + width]  # [R, T, w]
            cols.append(blk.permute(1, 0, 2).reshape(t, n_rule * width))
            o += width
    group_hits = (
        torch.cat(cols, dim=1)
        if cols
        else torch.zeros((t, 1), dtype=torch.bool, device=data.device)
    )  # [T, G_gathered]
    return post_match(post, group_hits, k1, k2, k3, req_id, numvals)


@dataclass
class ShardedWafEngine:
    """Facade: WafEngine semantics over a device mesh. Every rank builds
    one and calls ``evaluate`` with the same requests."""

    compiled: CompiledRuleSet
    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    model: ShardedWafModel = field(init=False)

    def __post_init__(self):
        from ..engine.waf import RequestTensorizer

        cuda = self.mesh.device_type == "cuda"
        self.device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
        self.n_data, n_rule = self.mesh.shape
        self.data_rank = self.mesh.get_local_rank("data")
        self.model = build_sharded_model(
            self.compiled, n_rule, shard=self.mesh.get_local_rank("rule"), device=self.device
        )
        self._rows = RequestTensorizer(self.compiled)  # host only: extractor, tensorize

    def evaluate(self, requests):
        """Evaluate this rank's data shard, gather every shard's verdicts
        over the ``data`` group, and return them all in input order."""
        from ..engine.waf import Verdict

        d = self.n_data
        shard = requests[self.data_rank :: d]
        # tensorize pads rows past the shard's targets with req_id == n_req
        # (out of range), as the reference pads its stacked shards.
        tensors = self._rows.tensorize([self._rows.extractor.extract(r) for r in shard])
        out = eval_waf_sharded(
            self.mesh, self.model, tuple(torch.as_tensor(a, device=self.device) for a in tensors)
        )
        n_max = -(-len(requests) // d)
        mine = torch.full((3, n_max), -1, dtype=torch.int32, device=self.device)
        n = len(shard)
        mine[0, :n] = out["interrupted"][:n].to(torch.int32)
        mine[1, :n] = out["status"][:n].to(torch.int32)
        mine[2, :n] = out["rule_index"][:n].to(torch.int32)
        every = [torch.empty_like(mine) for _ in range(d)]
        dist.all_gather(every, mine, group=self.mesh.get_group("data"))
        rows = [e.cpu().numpy() for e in every]

        verdicts: list[Verdict | None] = [None] * len(requests)
        for s in range(d):
            interrupted, status, rule_index = rows[s]
            for j in range(len(requests[s::d])):
                ridx = int(rule_index[j])
                verdicts[s + j * d] = Verdict(
                    interrupted=bool(interrupted[j]),
                    status=int(status[j]),
                    rule_id=int(self._rows.rule_ids[ridx]) if ridx >= 0 else None,
                )
        return verdicts
