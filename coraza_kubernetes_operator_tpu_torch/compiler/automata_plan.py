"""Per-group automata tier planning for the two-level device engine.

One planner, consumed from four places so they can never disagree:

- ``models/waf_model.build_model`` routes groups into segment blocks,
  DFA hot-tier gather banks, prefiltered banks, or exact NFA banks
  according to the plan it's handed;
- ``engine/waf.WafEngine`` computes the plan (env knobs below), passes
  it to ``build_model``, and keeps it for prefilter confirmation and
  stats;
- ``analysis/rulelint`` reports the tier assignment in the CKO-R010
  coverage summary and raises CKO-R011 advisories for
  prefilter-ineligible groups (this module is numpy-only so the
  analyzer needs no jax);
- ``bench.py`` attaches the tier breakdown to BENCH records.

Tier kinds per rule group:

- ``segment``     — conv/segment plan exists (cheapest path, unchanged);
- ``dfa-hot``     — small exact minimized DFA, evaluated through the
                    byte-class-packed gather banks (``ops/dfa_gather``);
- ``prefiltered`` — expensive group fronted by a sound over-approximate
                    automaton (``re_approx``); device clears the
                    no-match case, positive rows are confirmed exactly
                    on the host so verdicts never change;
- ``nfa``         — everything else: the existing vectorized-NFA bank
                    path.

Env knobs (CKO_* convention, all read at plan time):

- ``CKO_AUTOMATA=0``             — disable the whole two-level plan
  (every group reports ``segment``/``nfa`` exactly as before this
  feature existed);
- ``CKO_DFA_HOT=0``              — disable only the hot tier;
- ``CKO_PREFILTER=0``            — disable only the prefilter;
- ``CKO_DFA_HOT_MAX_STATES``     — hot-tier ceiling (default 64: packed
  transition values stay int8 so the gather kernel rides the int8 MXU);
- ``CKO_PREFILTER_MIN_STATES``   — minimum exact-state count before a
  group is worth prefiltering (default 129 = just past the dense-table
  ceiling, i.e. exactly the groups on the serializing scan path);
- ``CKO_APPROX_WIDTH``           — merge width for the approximation
  (default ``re_approx.DEFAULT_WIDTH``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .re_approx import DEFAULT_WIDTH, approx_dfa
from .re_dfa import DFA
from .segments import plan_segments

KINDS = ("segment", "dfa-hot", "prefiltered", "nfa")

# Hot-tier default ceiling: 2*S-1 <= 127 keeps packed next|emit values
# int8 (ops/dfa.py _dense_dtype), so the gather kernel's two matmuls run
# on the int8 MXU path.
DEFAULT_HOT_MAX_STATES = 64

# Past the dense-table ceiling (ops/dfa.py _DENSE_MAX_STATES == 128) a
# group falls onto the serializing per-byte gather scan — exactly the
# population the prefilter exists for.
DEFAULT_PREFILTER_MIN_STATES = 129


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default) not in ("0", "false", "no", "off")


@dataclass
class GroupTier:
    """Tier decision for one compiled rule group."""

    gid: int
    kind: str  # one of KINDS
    n_states: int
    pipeline: int  # pipeline id (crs.group_pipeline[gid])
    reason: str = ""  # for nfa: why not hot / not prefiltered
    approx: DFA | None = None  # prefilter automaton when kind == "prefiltered"
    approx_states: int = 0
    approx_width: int = 0


@dataclass
class AutomataPlan:
    """Whole-ruleset tier assignment. ``tiers[gid]`` is gid-indexed."""

    tiers: list[GroupTier] = field(default_factory=list)
    enabled: bool = True
    hot_enabled: bool = True
    prefilter_enabled: bool = True
    hot_max_states: int = DEFAULT_HOT_MAX_STATES
    prefilter_min_states: int = DEFAULT_PREFILTER_MIN_STATES

    def counts(self) -> dict[str, int]:
        got = {k: 0 for k in KINDS}
        for t in self.tiers:
            got[t.kind] += 1
        return got

    def kind_of(self, gid: int) -> str:
        return self.tiers[gid].kind if 0 <= gid < len(self.tiers) else "nfa"

    def ineligible(self) -> list[GroupTier]:
        """NFA groups past the prefilter threshold that could NOT be
        prefiltered — the CKO-R011 advisory population."""
        return [
            t
            for t in self.tiers
            if t.kind == "nfa" and t.n_states >= self.prefilter_min_states
        ]


def plan_automata(
    crs,
    *,
    enabled: bool | None = None,
    hot_enabled: bool | None = None,
    prefilter_enabled: bool | None = None,
    hot_max_states: int | None = None,
    prefilter_min_states: int | None = None,
    approx_width: int | None = None,
) -> AutomataPlan:
    """Classify every group of a ``CompiledRuleSet`` into an automata
    tier. Keyword overrides beat env knobs (tests use them; serving uses
    the env)."""
    enabled = _env_on("CKO_AUTOMATA") if enabled is None else enabled
    hot_on = (_env_on("CKO_DFA_HOT") if hot_enabled is None else hot_enabled) and enabled
    pre_on = (
        _env_on("CKO_PREFILTER") if prefilter_enabled is None else prefilter_enabled
    ) and enabled
    hot_max = (
        _env_int("CKO_DFA_HOT_MAX_STATES", DEFAULT_HOT_MAX_STATES)
        if hot_max_states is None
        else hot_max_states
    )
    pre_min = (
        _env_int("CKO_PREFILTER_MIN_STATES", DEFAULT_PREFILTER_MIN_STATES)
        if prefilter_min_states is None
        else prefilter_min_states
    )
    width = (
        _env_int("CKO_APPROX_WIDTH", DEFAULT_WIDTH)
        if approx_width is None
        else approx_width
    )

    plan = AutomataPlan(
        enabled=enabled,
        hot_enabled=hot_on,
        prefilter_enabled=pre_on,
        hot_max_states=hot_max,
        prefilter_min_states=pre_min,
    )
    for gid, grp in enumerate(crs.groups):
        dfa = grp.dfa
        pid = crs.group_pipeline[gid]
        n = dfa.n_states
        if plan_segments(dfa.ast) is not None:
            plan.tiers.append(
                GroupTier(gid, "segment", n, pid, reason="conv segment plan")
            )
            continue
        if dfa.always_match:
            plan.tiers.append(
                GroupTier(gid, "nfa", n, pid, reason="always-match short-circuit")
            )
            continue
        if hot_on and n <= hot_max:
            plan.tiers.append(GroupTier(gid, "dfa-hot", n, pid))
            continue
        if n < pre_min:
            plan.tiers.append(
                GroupTier(
                    gid,
                    "nfa",
                    n,
                    pid,
                    reason=f"{n} states: between hot ceiling ({hot_max}) and "
                    f"prefilter floor ({pre_min})",
                )
            )
            continue
        if not pre_on:
            plan.tiers.append(
                GroupTier(gid, "nfa", n, pid, reason="prefilter disabled")
            )
            continue
        got = approx_dfa(dfa, width=width)
        if got.dfa is None:
            plan.tiers.append(GroupTier(gid, "nfa", n, pid, reason=got.reason))
        else:
            plan.tiers.append(
                GroupTier(
                    gid,
                    "prefiltered",
                    n,
                    pid,
                    approx=got.dfa,
                    approx_states=got.dfa.n_states,
                    approx_width=got.width,
                )
            )
    return plan
