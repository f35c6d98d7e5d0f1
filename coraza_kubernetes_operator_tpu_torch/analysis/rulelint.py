"""Seclang ruleset static analyzer (prong 1 of ``cko-analyze``).

Runs over the parsed AST plus the compiled IR (``CompiledRuleSet`` with
its ``CompileReport``, per-group DFA tables, and the regex position NFAs)
and emits structured findings. Everything here is decidable at admission
time from artifacts the compiler already builds — no request traffic, no
regex-string heuristics.

Finding catalog (docs/ANALYSIS.md):

======== ======== =====================================================
code     severity meaning
======== ======== =====================================================
CKO-R001 error    duplicate rule id across the aggregated document
CKO-R002 error    catastrophic-backtracking risk (NFA EDA) on a pattern
                  the compiler routed to the host path
CKO-R003 info     ambiguous pattern that lowered to device DFA tables
                  (safe on-device; a hazard if ever host-evaluated)
CKO-R004 warn     rule shadowed by an earlier terminal rule with a
                  superset target set and superset language
CKO-R005 warn     chain/rule that can never fire (dead link or
                  empty-language pattern)
CKO-R006 warn     variable no extractor populates (matches nothing)
CKO-R007 warn     rule skipped from the device plan (runs nowhere)
CKO-R008 error    Seclang parse error
CKO-R009 error    compile error (document not lowerable)
CKO-R010 info     TPU-coverage summary (skip/approximate aggregation)
                  + per-group automata-tier assignment (segment /
                  dfa-hot / prefiltered / nfa)
CKO-R011 info     group ineligible for the approximate prefilter (stays
                  on the full-width NFA-derived tables) and why
======== ======== =====================================================
"""

from __future__ import annotations

import re
from collections import Counter

from ..compiler.ruleset import (
    COLLECTIONS,
    DEC_ALLOW,
    DEC_DENY,
    DEC_DROP,
    DEC_REDIRECT,
    LINK_ALWAYS,
    LINK_NEVER,
    LINK_STRING,
    NUMERIC_SCALARS,
    SCALARS,
    CompiledRuleSet,
    CompileError,
    compile_program,
)
from ..compiler.automata_plan import plan_automata
from ..seclang.ast import RuleSetProgram, SeclangParseError
from ..seclang.parser import parse
from .findings import SEV_ERROR, SEV_INFO, SEV_WARN, AnalysisReport, Finding
from .redos import pattern_has_eda

# Operators whose argument is a regular expression evaluated by a
# backtracking engine when the rule lives on the host path.
_REGEX_OPS = {"rx", "strmatch"}

# DFA-product language-inclusion cap: pairs above this are skipped (the
# cheap same-group check still applies to them). The group DFAs the
# analyzer walks are Hopcroft-MINIMIZED (compiler/re_dfa.py applies
# minimize() before tables are emitted), which both shrinks the product
# space — more pairs land under the cap — and makes the inclusion
# decision exact on the same automata the device actually runs.
_MAX_INCLUSION_PRODUCT = 4000

_TERMINAL_DECISIONS = {DEC_DENY, DEC_DROP, DEC_REDIRECT, DEC_ALLOW}

_EXTRACTABLE = COLLECTIONS | SCALARS | NUMERIC_SCALARS | {"TX"}

_ID_RE = re.compile(r"(?:^|[,\"'\s])id\s*:\s*(\d+)", re.IGNORECASE)


def duplicate_id_findings(text: str) -> list[Finding]:
    """Duplicate rule ids detected from the raw document. Runs before the
    parser (which refuses duplicates outright) so an aggregated multi-
    ConfigMap document reports *which* id collides, not just 'invalid'.
    Comment lines are dropped first — a commented-out old copy of a rule
    is not a collision (Seclang comments are full-line ``#`` only)."""
    live = "\n".join(
        line for line in text.splitlines() if not line.lstrip().startswith("#")
    )
    counts = Counter(int(m.group(1)) for m in _ID_RE.finditer(live))
    return [
        Finding(
            code="CKO-R001",
            severity=SEV_ERROR,
            rule_id=rid,
            message=f"rule id {rid} defined {n} times",
            detail="later definitions are unreachable under first-parse-wins",
        )
        for rid, n in sorted(counts.items())
        if n > 1
    ]


# ---------------------------------------------------------------------------
# IR checks
# ---------------------------------------------------------------------------


def _kind_names(compiled: CompiledRuleSet) -> dict[int, tuple[str, str | None]]:
    return {kid: key for key, kid in compiled.vocab.kinds.items()}


def _kinds_cover(
    earlier: tuple[int, ...],
    later: tuple[int, ...],
    names: dict[int, tuple[str, str | None]],
) -> bool:
    """True when every target the later kinds select is also selected by
    the earlier kinds: same kind id, or the earlier rule watches the whole
    collection the later rule narrows with a selector."""
    earlier_set = set(earlier)
    whole_collections = {
        names[k][0] for k in earlier if k in names and names[k][1] is None
    }
    for k in later:
        if k in earlier_set:
            continue
        coll = names.get(k, (None, None))[0]
        if coll in whole_collections:
            continue
        return False
    return True


def _dfa_matches_empty(dfa) -> bool:
    return bool(dfa.always_match or dfa.match_end[0])


def _dfa_language_empty(dfa) -> bool:
    return not (dfa.always_match or dfa.emit.any() or dfa.match_end.any())


def dfa_language_subset(small, big) -> bool | None:
    """Decide L(small) ⊆ L(big) for two search-semantics DFAs: no string
    containing a ``small`` match may lack a ``big`` match. Product BFS
    with a sticky matched-flag per automaton; ``big``-matched configs are
    pruned (any extension stays matched). Returns None above the size cap."""
    if big.always_match:
        return True
    if small.n_states * big.n_states > _MAX_INCLUSION_PRODUCT:
        return None
    if (small.always_match or _dfa_matches_empty(small)) and not _dfa_matches_empty(big):
        return False
    # Joint byte classes: distinct (small-class, big-class) pairs.
    joint: dict[tuple[int, int], None] = {}
    for b in range(256):
        joint[(int(small.classmap[b]), int(big.classmap[b]))] = None
    seen = {(0, 0, False)}
    work = [(0, 0, False)]
    while work:
        s, g, s_matched = work.pop()
        # A string may end here: small matched (sticky flag or end-state)
        # while big has not (big emits were pruned, so only its end bit).
        if (s_matched or small.match_end[s]) and not big.match_end[g]:
            return False
        for cs, cg in joint:
            if big.emit[g, cg]:
                continue  # big matched: every extension is in L(big)
            ns = int(small.trans[s, cs])
            ng = int(big.trans[g, cg])
            nm = bool(s_matched or small.emit[s, cs])
            node = (ns, ng, nm)
            if node not in seen:
                seen.add(node)
                work.append(node)
    return True


def _check_redos(program: RuleSetProgram, compiled: CompiledRuleSet, report: AnalysisReport) -> None:
    """Catastrophic-backtracking risk, decided on the compiled position
    NFA (ambiguous-loop overlap / EDA). Error when the rule was skipped
    off the device plan — its pattern is exactly what a host-path
    evaluator would hand to a backtracking engine; info when the rule
    lowered to DFA tables (bounded by construction on-device)."""
    skipped_ids = {rid for rid, _ in compiled.report.skipped if rid is not None}
    seen: set[tuple[int | None, str]] = set()
    for rule in program.rules:
        for link in rule.all_rules():
            op = link.operator
            if op is None or op.name not in _REGEX_OPS or not op.argument:
                continue
            if "%{" in op.argument:
                continue  # macro patterns resolve per-document at lowering
            key = (rule.id, op.argument)
            if key in seen:
                continue
            seen.add(key)
            verdict = pattern_has_eda(op.argument)
            if not verdict:
                continue
            pat = op.argument if len(op.argument) <= 80 else op.argument[:77] + "..."
            if rule.id in skipped_ids:
                report.add(
                    Finding(
                        code="CKO-R002",
                        severity=SEV_ERROR,
                        rule_id=rule.id,
                        message=f"catastrophic-backtracking risk in host-path pattern {pat!r}",
                        detail=(
                            "the compiled NFA has exponential ambiguity (a state "
                            "reachable from itself along two distinct paths over "
                            "the same word) and the rule is off the device plan, "
                            "so the pattern would run under a backtracking engine"
                        ),
                    )
                )
            else:
                report.add(
                    Finding(
                        code="CKO-R003",
                        severity=SEV_INFO,
                        rule_id=rule.id,
                        message=f"ambiguous pattern {pat!r} (safe as device DFA)",
                        detail="exponentially ambiguous NFA; keep off host overrides",
                    )
                )


def _check_shadowing(compiled: CompiledRuleSet, report: AnalysisReport) -> None:
    """Earlier terminal rule with superset targets + superset language ⇒
    later rule can never fire. Exact when both rules share one interned
    match group (identical expanded pattern + pipeline); extended to
    distinct groups via DFA-product language inclusion when the tables
    are small enough."""
    if compiled.engine_mode != "On":
        return  # DetectionOnly: terminal decisions do not interrupt
    names = _kind_names(compiled)
    # Earlier terminal candidates: (order, phase, kinds, group, rule_id).
    terminals: list[tuple[int, int, tuple[int, ...], int, int]] = []
    rules = sorted(compiled.rules, key=lambda r: r.order_key)
    emitted: set[int] = set()
    for r in rules:
        links = [compiled.links[i] for i in r.link_ids]
        if len(links) != 1:
            continue
        link = links[0]
        if link.link_type != LINK_STRING or link.negated or link.exclude_kinds:
            continue
        for t_order, t_phase, t_kinds, t_group, t_id in terminals:
            if t_order >= r.order_key or t_phase != r.phase or r.rule_id in emitted:
                continue
            if not _kinds_cover(t_kinds, link.include_kinds, names):
                continue
            if t_group == link.group:
                included: bool | None = True
            else:
                g_t = compiled.groups[t_group]
                g_r = compiled.groups[link.group]
                if g_t.pipeline != g_r.pipeline:
                    continue
                included = dfa_language_subset(g_r.dfa, g_t.dfa)
            if included:
                emitted.add(r.rule_id)
                report.add(
                    Finding(
                        code="CKO-R004",
                        severity=SEV_WARN,
                        rule_id=r.rule_id,
                        message=(
                            f"shadowed by earlier terminal rule {t_id}: "
                            "superset targets and superset language"
                        ),
                        detail=(
                            "every request matching this rule is interrupted "
                            f"by rule {t_id} first (first-match-wins)"
                        ),
                    )
                )
        if r.decision in _TERMINAL_DECISIONS:
            terminals.append(
                (r.order_key, r.phase, link.include_kinds, link.group, r.rule_id)
            )


def _check_dead_links(compiled: CompiledRuleSet, report: AnalysisReport) -> None:
    for r in compiled.rules:
        for pos, li in enumerate(r.link_ids):
            link = compiled.links[li]
            dead = None
            if link.link_type == LINK_NEVER and not link.negated:
                dead = "@nomatch link"
            elif link.link_type == LINK_ALWAYS and link.negated:
                dead = "negated unconditional link"
            elif link.link_type == LINK_STRING and not link.negated:
                if _dfa_language_empty(compiled.groups[link.group].dfa):
                    dead = "pattern matches no byte string"
            if dead:
                where = "rule" if len(r.link_ids) == 1 else f"chain link {pos}"
                report.add(
                    Finding(
                        code="CKO-R005",
                        severity=SEV_WARN,
                        rule_id=r.rule_id,
                        message=f"{where} can never fire ({dead})",
                        detail="the whole chain is dead weight in the device plan",
                    )
                )
                break  # one finding per rule


def _check_unpopulated_variables(program: RuleSetProgram, report: AnalysisReport) -> None:
    seen: set[tuple[int | None, str]] = set()
    for rule in program.rules:
        for link in rule.all_rules():
            if link.operator is None:
                continue
            for var in link.variables:
                if var.exclude or var.name in _EXTRACTABLE:
                    continue
                key = (rule.id, var.name)
                if key in seen:
                    continue
                seen.add(key)
                report.add(
                    Finding(
                        code="CKO-R006",
                        severity=SEV_WARN,
                        rule_id=rule.id,
                        message=f"variable {var.render()} is never populated by the extractor",
                        detail="the condition can only match through its other variables",
                    )
                )


def _normalize_reason(reason: str) -> str:
    """Collapse a skip/approximate reason to its class so the coverage
    histogram aggregates 'transform(s) [x] unsupported' style messages."""
    reason = re.sub(r"\[[^\]]*\]", "[...]", reason)
    reason = re.sub(r"'[^']*'", "'...'", reason)
    reason = re.sub(r"\"[^\"]*\"", "'...'", reason)
    reason = re.sub(r"\b\d+\b", "N", reason)
    return reason.strip()


def _coverage(program: RuleSetProgram, compiled: CompiledRuleSet, report: AnalysisReport) -> None:
    """The TPU-coverage report: one number for "how much of this document
    actually runs on-device", plus the aggregated skip/approximate reason
    histogram the compiler previously only logged."""
    crep = compiled.report
    skipped_ids = {rid for rid, _ in crep.skipped}
    approx_ids = {rid for rid, _ in crep.approximations}
    device_ids = {r.rule_id for r in compiled.rules}
    total = sum(1 for r in program.rules if r.operator is not None and r.id is not None)
    skip_hist = Counter(_normalize_reason(reason) for _, reason in crep.skipped)
    approx_hist = Counter(_normalize_reason(reason) for _, reason in crep.approximations)
    denom = max(1, len(device_ids | skipped_ids))
    pct = 100.0 * len(device_ids) / denom
    # Two-level automata tier assignment (compiler/automata_plan.py),
    # evaluated with every tier force-enabled so the lint verdict states
    # the document's INTRINSIC eligibility — not whatever CKO_AUTOMATA*
    # knobs happen to be set in the analyzer's environment.
    plan = plan_automata(
        compiled, enabled=True, hot_enabled=True, prefilter_enabled=True
    )
    tier_counts = plan.counts()
    report.coverage = {
        "total_rules": total,
        "device_rules": len(device_ids),
        "skipped_rules": len(skipped_ids),
        "approximated_rules": len(approx_ids),
        "const_eliminated": crep.const_eliminated,
        "coverage_pct": round(pct, 2),
        "skip_reasons": dict(sorted(skip_hist.items())),
        "approximate_reasons": dict(sorted(approx_hist.items())),
        "tier_assignment": tier_counts,
        "prefilter_ineligible": len(plan.ineligible()),
    }
    for rid, reason in crep.skipped:
        report.add(
            Finding(
                code="CKO-R007",
                severity=SEV_WARN,
                rule_id=rid,
                message=f"rule skipped from the device plan: {_normalize_reason(reason)}",
                detail=reason,
            )
        )
    report.add(
        Finding(
            code="CKO-R010",
            severity=SEV_INFO,
            message=(
                f"tpu coverage {pct:.1f}%: {len(device_ids)} rules on-device, "
                f"{len(skipped_ids)} skipped, {len(approx_ids)} approximated, "
                f"{crep.const_eliminated} const-eliminated; automata tiers: "
                f"{tier_counts['segment']} segment, "
                f"{tier_counts['dfa-hot']} dfa-hot, "
                f"{tier_counts['prefiltered']} prefiltered, "
                f"{tier_counts['nfa']} nfa"
            ),
        )
    )
    # CKO-R011: big groups the approximate prefilter could not cover —
    # they stay on the full-width dense tables, the slowest device tier.
    # Advisory only: verdicts are unaffected; this is a perf signal for
    # rule authors (usually a pattern whose merged automaton blows up
    # under subset construction at every width).
    gid_rules: dict[int, set] = {}
    for rule in compiled.rules:
        for lid in rule.link_ids:
            gid = compiled.links[lid].group
            if gid >= 0:
                gid_rules.setdefault(gid, set()).add(rule.rule_id)
    for tier in plan.ineligible():
        rids = sorted(gid_rules.get(tier.gid, ()))
        report.add(
            Finding(
                code="CKO-R011",
                severity=SEV_INFO,
                rule_id=rids[0] if rids else None,
                message=(
                    f"group {tier.gid} ({tier.n_states} DFA states, rules "
                    f"{rids or '[]'}) is ineligible for the approximate "
                    f"prefilter: {tier.reason or 'no approximation found'}"
                ),
                detail=tier.reason,
            )
        )


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def analyze_compiled(
    program: RuleSetProgram,
    compiled: CompiledRuleSet,
    report: AnalysisReport | None = None,
) -> AnalysisReport:
    """All IR-level checks over an already-compiled document (the
    controller and the sidecar reloader call this — no second compile)."""
    report = report or AnalysisReport()
    _check_redos(program, compiled, report)
    _check_shadowing(compiled, report)
    _check_dead_links(compiled, report)
    _check_unpopulated_variables(program, report)
    _coverage(program, compiled, report)
    return report.finalize()


def analyze_document(text: str, compiled: CompiledRuleSet) -> AnalysisReport:
    """All checks for an already-compiled document: the duplicate-id
    pre-scan over the raw text plus the IR checks. The ONE entrypoint the
    controller's admission pass and the sidecar's reload gate share, so
    the two can never drift to different findings for the same input."""
    report = AnalysisReport()
    for f in duplicate_id_findings(text):
        report.add(f)
    return analyze_compiled(parse(text), compiled, report)


def analyze_ruleset(text: str) -> AnalysisReport:
    """Parse + compile + analyze a Seclang document. Parse/compile
    failures become error findings instead of exceptions, so the CLI and
    CI gate render one uniform report for any input."""
    report = AnalysisReport()
    for f in duplicate_id_findings(text):
        report.add(f)
    try:
        program = parse(text)
    except SeclangParseError as err:
        report.add(
            Finding(
                code="CKO-R008",
                severity=SEV_ERROR,
                message=f"Seclang parse error: {err}",
            )
        )
        return report.finalize()
    try:
        compiled = compile_program(program)
    except (CompileError, ValueError) as err:
        report.add(
            Finding(
                code="CKO-R009",
                severity=SEV_ERROR,
                message=f"document does not compile for the TPU engine: {err}",
            )
        )
        return report.finalize()
    return analyze_compiled(program, compiled, report)
