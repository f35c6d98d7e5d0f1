"""Seclang program → CompiledRuleSet lowering.

This is the TPU-shaped replacement for the per-request Seclang interpreter
the reference outsources to coraza-proxy-wasm. Lowering strategy:

- **Match groups**: every (string operator, transform pipeline) pair becomes
  DFA tables, deduped across rules, bucketed by table size into banks
  (``ops/dfa.py``) so one fused scan covers many rules.
- **Target kinds**: variables (ARGS, REQUEST_HEADERS:Content-Type, ...)
  become a compile-time vocabulary of (collection, selector) ids; request
  extraction tags each byte-target with its kind ids and the model resolves
  rule↔target incidence with two bool-table gathers.
- **Partial evaluation**: rules over compile-time-constant TX variables
  (CRS paranoia-level gates, ``skipAfter`` jumps, setup SecActions) are
  evaluated during lowering and never reach the device — the TPU analog of
  CRS's setup phase.
- **Anomaly scoring**: ``setvar:tx.X=+N`` increments become a rule×counter
  weight matrix; threshold rules (``@ge %{tx...threshold}``) become linear
  comparisons on the matmul of match flags with that matrix.

Action semantics (phase ordering, SecDefaultAction resolution of ``block``,
first-match interruption, fail statuses) mirror ModSecurity as exercised by
the reference integration corpus (``test/integration/coreruleset_test.go``,
``config/samples/ruleset.yaml``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import dataclasses

import numpy as np

from ..seclang.ast import (
    Action,
    Marker,
    Rule,
    RuleSetProgram,
    SeclangParseError,
)
from ..seclang.parser import parse
from .operators import (
    CMP_CODES,
    NUMERIC_OPS,
    StringOpPlan,
    UnsupportedOperator,
    expand_macros,
    lower_string_operator,
    parse_numeric_arg,
)
from .re_dfa import DFA, DFAError, compile_regex_dfa
from .re_parser import RegexParseError
from .transforms_host import TRANSFORMS as HOST_TRANSFORMS
from ..ops.transforms import DEVICE_TRANSFORMS


class CompileError(ValueError):
    pass


# Link types
LINK_STRING = 0
LINK_NUMERIC = 1
LINK_COUNTER = 2
LINK_ALWAYS = 3
LINK_NEVER = 4

# Decision codes
DEC_NONE = 0
DEC_DENY = 1
DEC_ALLOW = 2
DEC_DROP = 3
DEC_REDIRECT = 4

# Numeric scalar variables the extractor can produce.
NUMERIC_SCALARS = {
    "REQUEST_BODY_LENGTH",
    "REQBODY_ERROR",
    "MULTIPART_STRICT_ERROR",
    "MULTIPART_UNMATCHED_BOUNDARY",
    "ARGS_COMBINED_SIZE",
    "FULL_REQUEST_LENGTH",
    "FILES_COMBINED_SIZE",
    "RESPONSE_STATUS",
    "DURATION",
}

# Collections that expand to several targets per request.
COLLECTIONS = {
    "ARGS",
    "ARGS_NAMES",
    "ARGS_GET",
    "ARGS_GET_NAMES",
    "ARGS_POST",
    "ARGS_POST_NAMES",
    "REQUEST_HEADERS",
    "REQUEST_HEADERS_NAMES",
    "REQUEST_COOKIES",
    "REQUEST_COOKIES_NAMES",
    "RESPONSE_HEADERS",
    "FILES",
    "FILES_NAMES",
    "XML",
    "JSON",
}

# Scalar byte-target variables.
SCALARS = {
    "REQUEST_URI",
    "REQUEST_URI_RAW",
    "REQUEST_BASENAME",
    "REQUEST_FILENAME",
    "REQUEST_LINE",
    "REQUEST_METHOD",
    "REQUEST_PROTOCOL",
    "REQUEST_BODY",
    "QUERY_STRING",
    "PATH_INFO",
    "REMOTE_ADDR",
    "SERVER_NAME",
    "FULL_REQUEST",
    "RESPONSE_BODY",
    "STATUS_LINE",
    "AUTH_TYPE",
    "REQBODY_PROCESSOR",
}


@dataclass
class MatchGroup:
    """One compiled DFA evaluated under one transform pipeline."""

    dfa: DFA
    pipeline: tuple[str, ...]
    key: tuple = ()


@dataclass
class CompiledLink:
    link_type: int
    negated: bool = False
    group: int = -1  # match-group id (string links)
    include_kinds: tuple[int, ...] = ()
    exclude_kinds: tuple[int, ...] = ()
    numvar: int = -1
    cmp: int = 0
    cmp_arg: int = 0
    counter: int = -1


@dataclass
class CompiledRule:
    rule_id: int
    phase: int
    decision: int
    status: int
    order_key: int
    link_ids: list[int]
    msg: str | None = None
    severity: str | None = None
    tags: list[str] = field(default_factory=list)
    logs: bool = True
    # Runtime ctl actions: when this rule matches, later rules whose id
    # falls in a range (or carries a tag) are disabled for the request.
    ctl_remove_ranges: list[tuple[int, int]] = field(default_factory=list)
    ctl_remove_tags: list[str] = field(default_factory=list)


def _report_sort_key(entry: tuple[int | None, str]) -> tuple[int, str]:
    rid, reason = entry
    return (-1 if rid is None else rid, reason)


@dataclass
class CompileReport:
    """Skip/approximate ledger. Entries are DEDUPED by ``(rule_id,
    reason)`` and SORTED at finalize time, so two compiles of the same
    document always produce byte-identical reports — the analyzer's
    coverage numbers and the ``cko_rules_skipped_total`` /
    ``cko_rules_approximated_total`` metrics must not drift between runs
    (or between the controller's compile and the sidecar's)."""

    skipped: list[tuple[int | None, str]] = field(default_factory=list)
    approximations: list[tuple[int | None, str]] = field(default_factory=list)
    const_eliminated: int = 0
    # Cold-compile footprint (cko_dfa_states_{pre,post}_min_total):
    # total DFA states across all group + kind-regex automata before and
    # after Hopcroft minimization — the direct driver of stacked-bank
    # size and XLA program size.
    dfa_states_pre_min: int = 0
    dfa_states_post_min: int = 0
    # Distinct executable shape signatures this ruleset's engine has
    # dispatched (cko_exec_signatures); written by the engine at dispatch
    # time — 0 until the first batch.
    exec_signatures: int = 0

    def skip(self, rule_id: int | None, reason: str) -> None:
        entry = (rule_id, reason)
        if entry not in self.skipped:
            self.skipped.append(entry)

    def approximate(self, rule_id: int | None, reason: str) -> None:
        entry = (rule_id, reason)
        if entry not in self.approximations:
            self.approximations.append(entry)

    @property
    def approximated(self) -> list[tuple[int | None, str]]:
        """Alias with the metric's name; same deduped, sorted entries."""
        return self.approximations

    def finalize(self) -> "CompileReport":
        self.skipped.sort(key=_report_sort_key)
        self.approximations.sort(key=_report_sort_key)
        return self


@dataclass
class TargetKindVocab:
    """(collection, selector) → kind id. Kind 0 is reserved padding."""

    kinds: dict[tuple[str, str | None], int] = field(default_factory=dict)
    regex_kinds: list[tuple[str, str, int]] = field(default_factory=list)
    _regex_dfas: dict[int, DFA] = field(default_factory=dict)

    def intern(self, collection: str, selector: str | None) -> int:
        key = (collection, selector.lower() if selector else None)
        if key not in self.kinds:
            self.kinds[key] = len(self.kinds) + 1  # 0 reserved
        return self.kinds[key]

    def intern_regex(self, collection: str, pattern: str) -> int:
        for coll, pat, kid in self.regex_kinds:
            if coll == collection and pat == pattern:
                return kid
        kid = self.intern(collection, f"/{pattern}/")
        self.regex_kinds.append((collection, pattern, kid))
        self._regex_dfas[kid] = compile_regex_dfa(pattern, case_insensitive=True)
        return kid

    def lookup(self, collection: str, selector: str | None) -> int | None:
        return self.kinds.get((collection, selector.lower() if selector else None))

    def regex_kinds_for(self, collection: str) -> list[tuple[DFA, int]]:
        return [
            (self._regex_dfas[kid], kid)
            for coll, _, kid in self.regex_kinds
            if coll == collection
        ]

    @property
    def n_kinds(self) -> int:
        return len(self.kinds) + 1


@dataclass
class NumericVarVocab:
    """Numeric request variables: ('scalar', NAME) or ('count', COLL, sel)."""

    vars: dict[tuple, int] = field(default_factory=dict)

    def intern(self, key: tuple) -> int:
        if key not in self.vars:
            self.vars[key] = len(self.vars)
        return self.vars[key]

    @property
    def n_vars(self) -> int:
        return max(1, len(self.vars))


@dataclass
class CompiledRuleSet:
    """Host-side compiled artifact. ``models/waf_model.py`` lifts the arrays
    to device; the engine pairs it with request extraction."""

    program: RuleSetProgram
    groups: list[MatchGroup]
    rules: list[CompiledRule]
    links: list[CompiledLink]
    vocab: TargetKindVocab
    numvars: NumericVarVocab
    counters: list[str]
    counter_base: np.ndarray  # [C] int32
    weights: np.ndarray  # [Rr, C] int32
    pipelines: list[tuple[str, ...]]  # distinct pipelines, index = pipeline id
    pipeline_device: list[bool]
    group_pipeline: list[int]
    report: CompileReport
    engine_mode: str = "On"
    default_status: int = 403

    @property
    def n_rules(self) -> int:
        return len(self.rules)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def host_pipelines(self) -> list[tuple[int, tuple[str, ...]]]:
        """(pipeline_id, names) pairs that must be applied host-side during
        target extraction."""
        return [
            (i, p)
            for i, (p, dev) in enumerate(zip(self.pipelines, self.pipeline_device))
            if not dev
        ]


# ---------------------------------------------------------------------------
# Compile-time TX environment / partial evaluation
# ---------------------------------------------------------------------------


def _copy_variable(v):
    return dataclasses.replace(v)


def _setvar_parse(sv: str) -> tuple[str, str, str] | None:
    """Parse a setvar body into (scope.name, op, value) where op ∈ {=, +=, -=}.
    Returns None for deletes (!tx.x) and non-tx scopes."""
    sv = sv.strip().strip("'\"")
    if sv.startswith("!"):
        return None
    name, sep, value = sv.partition("=")
    if not sep:
        name, value = sv, "1"
    name = name.strip().lower()
    op = "="
    value = value.strip()
    if value.startswith("+"):
        op, value = "+=", value[1:]
    elif value.startswith("-"):
        op, value = "-=", value[1:]
    return name, op, value


def _resolve_value(value: str, env: dict[str, str]) -> str | None:
    """Resolve a setvar RHS against the env; None if it references
    non-constant macros. (Same grammar as operator args — one impl.)"""
    try:
        return expand_macros(value, env)
    except UnsupportedOperator:
        return None


def _try_const_eval(rule: Rule, env: dict[str, str], runtime_tx: set[str]) -> bool | None:
    """Evaluate a rule entirely over compile-time TX constants. Returns the
    match result, or None if not const-evaluable (e.g. the TX var is
    incremented at runtime — an anomaly-score counter)."""
    for link in rule.all_rules():
        if link.operator is None:
            continue  # SecAction — unconditional
        if link.operator.name not in NUMERIC_OPS and link.operator.name not in (
            "streq",
            "eq",
            "unconditionalmatch",
            "nomatch",
        ):
            return None
        result = None
        for var in link.variables:
            if var.name != "TX":
                return None
            sel = (var.selector or "").lower()
            if sel in runtime_tx:
                return None
            key = f"tx.{sel}"
            if var.count:
                val: int | str = 1 if key in env else 0
            else:
                raw = env.get(key)
                if raw is None:
                    # Unset TX var: numeric value 0.
                    raw = "0"
                val = raw
            m = _const_compare(link.operator.name, val, link.operator.argument, env)
            if m is None:
                return None
            m = m != link.operator.negated
            result = m if result is None else (result or m)
        if link.operator.name == "unconditionalmatch":
            result = not link.operator.negated
        if link.operator.name == "nomatch":
            result = link.operator.negated
        if not result:
            return False
    return True


def _const_compare(op: str, val, arg: str, env: dict[str, str]) -> bool | None:
    resolved = _resolve_value(arg, env)
    if resolved is None:
        return None
    if op == "streq":
        return str(val) == resolved
    try:
        left = int(val)
        right = int(resolved)
    except (TypeError, ValueError):
        return None
    return {
        "eq": left == right,
        "ne": left != right,
        "ge": left >= right,
        "gt": left > right,
        "le": left <= right,
        "lt": left < right,
    }.get(op)


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


def _effective_pipeline(rule_link: Rule, defaults: list[Action]) -> tuple[str, ...]:
    names: list[str] = [a.argument.lower() for a in defaults if a.name == "t" and a.argument]
    for t in rule_link.transformations:
        if t == "none":
            names = []
        else:
            names.append(t)
    return tuple(names)


def _decision_of(rule: Rule, defaults: list[Action], default_status: int) -> tuple[int, int]:
    disruptive = rule.disruptive
    status = rule.status
    if disruptive == "block" or disruptive is None:
        # ModSecurity inheritance: both `block` and the absence of a
        # disruptive action resolve to SecDefaultAction's disruptive action
        # for the rule's phase (implicit default: pass).
        d_disruptive = next(
            (a.name for a in defaults if a.name in ("deny", "drop", "allow", "redirect", "pass")),
            None,
        )
        d_status = next(
            (int(a.argument) for a in defaults if a.name == "status" and a.argument), None
        )
        disruptive = d_disruptive or "pass"
        status = status or d_status
    code = {
        "deny": DEC_DENY,
        "drop": DEC_DROP,
        "redirect": DEC_REDIRECT,
        "allow": DEC_ALLOW,
        "pass": DEC_NONE,
        "proxy": DEC_NONE,
    }.get(disruptive, DEC_NONE)
    if code in (DEC_DENY, DEC_DROP):
        status = status or default_status
    elif code == DEC_REDIRECT:
        status = status or 302
    else:
        status = 0
    return code, status


class _Lowering:
    def __init__(self, program: RuleSetProgram):
        self.program = program
        self.report = CompileReport()
        self.vocab = TargetKindVocab()
        self.numvars = NumericVarVocab()
        self.groups: list[MatchGroup] = []
        self.group_index: dict[tuple, int] = {}
        self.links: list[CompiledLink] = []
        self.rules: list[CompiledRule] = []
        self.rule_setvars: list[list[tuple[str, str, str]]] = []
        self.env: dict[str, str] = {}
        # @pmFromFile resolution root: SecDataDir (ModSecurity's data-file
        # directory directive), read by operators._load_pm_file.
        if program.config.get("secdatadir"):
            self.env["__secdatadir__"] = program.config["secdatadir"]
        self.counters: list[str] = []
        # TX vars written by *conditional* rules are runtime state (anomaly
        # counters) — never compile-time constants.
        self.runtime_tx: set[str] = set()
        for rule in program.rules:
            if rule.operator is None:
                continue
            for sv in rule.setvars:
                parsed = _setvar_parse(sv)
                if parsed and parsed[0].startswith("tx."):
                    self.runtime_tx.add(parsed[0].removeprefix("tx."))

        # ctl:ruleRemoveTargetById=ID;TARGET pre-pass (Coraza runtime
        # target exclusion). Lowered STATICALLY as rule variants gated on
        # a synthetic counter the ctl rule increments: when the ctl rule
        # matches, the variant with the target excluded is active; when
        # it does not, the original variant is. No new runtime machinery
        # — the exclusion rides the existing kind-exclusion matrix and
        # LINK_COUNTER gating (two-pass counter resolution in post_match
        # keeps the gated variants' own anomaly weights exact).
        from ..seclang.parser import _parse_variables

        self.ctl_target_removals: dict[int, list[tuple[str, list]]] = {}
        self.synthetic_incs: dict[int, list[tuple[str, str, str]]] = {}
        n_ctlrt = 0
        for rule in program.rules:
            for a in rule.actions + [x for sub in rule.chain for x in sub.actions]:
                if a.name != "ctl" or not a.argument:
                    continue
                key, _, val = a.argument.partition("=")
                if key.strip().lower() != "ruleremovetargetbyid":
                    continue
                rid_s, _, target_s = val.strip().partition(";")
                if not rid_s.strip().isdigit() or not target_s.strip():
                    self.report.approximate(
                        rule.id, f"ctl:ruleRemoveTargetById malformed: {val!r}"
                    )
                    continue
                target_id = int(rid_s.strip())
                try:
                    variables = _parse_variables(target_s.strip(), rule.line)
                except Exception as err:
                    self.report.approximate(
                        rule.id, f"ctl:ruleRemoveTargetById target parse: {err}"
                    )
                    continue
                variables = [
                    dataclasses.replace(v, exclude=True) for v in variables
                ]
                cname = f"__ctlrt_{n_ctlrt}"
                n_ctlrt += 1
                self.ctl_target_removals.setdefault(target_id, []).append(
                    (cname, variables)
                )
                self.synthetic_incs.setdefault(id(rule), []).append(
                    (f"tx.{cname}", "+=", "1")
                )
                self.runtime_tx.add(cname)

    # -- groups -------------------------------------------------------------

    def _intern_group(self, plan: StringOpPlan, pipeline: tuple[str, ...], key: tuple) -> int:
        gid = self.group_index.get(key)
        if gid is None:
            gid = len(self.groups)
            self.groups.append(MatchGroup(dfa=plan.dfa, pipeline=pipeline, key=key))
            self.group_index[key] = gid
        return gid

    # -- variables ----------------------------------------------------------

    def _kinds_of_variable(self, var, string_ctx: bool) -> tuple[list[int], str | None]:
        """Kind ids a (non-excluded) variable selects. Returns (kinds, err)."""
        name = var.name
        if name in COLLECTIONS:
            if var.selector is None:
                return [self.vocab.intern(name, None)], None
            if var.selector_is_regex:
                return [self.vocab.intern_regex(name, var.selector)], None
            return [self.vocab.intern(name, var.selector)], None
        if name in SCALARS:
            return [self.vocab.intern(name, None)], None
        if name in NUMERIC_SCALARS and string_ctx:
            # Numeric scalar used with a string operator: extractor emits its
            # decimal representation as a byte target.
            return [self.vocab.intern(name, None)], None
        return [], f"variable {var.render()} unsupported here"

    # -- link lowering ------------------------------------------------------

    def _lower_link(
        self, link: Rule, pipeline: tuple[str, ...], rule_id: int | None
    ) -> int | None:
        """Lower one chain link to a CompiledLink; returns link index or None
        (reason recorded)."""
        op = link.operator
        assert op is not None
        if op.name == "unconditionalmatch":
            self.links.append(CompiledLink(LINK_ALWAYS, negated=op.negated))
            return len(self.links) - 1
        if op.name == "nomatch":
            self.links.append(CompiledLink(LINK_NEVER, negated=op.negated))
            return len(self.links) - 1

        if op.name in NUMERIC_OPS:
            return self._lower_numeric_link(link, rule_id)

        if op.name in ("detectsqli", "detectxss"):
            # Host-evaluated libinjection-architecture detectors
            # (compiler/sqli.py tokenizer+fingerprint, compiler/xss.py
            # html5 danger scan): their semantics cannot lower to a
            # regex, so the extractor computes a per-request bit over
            # the rule's (transformed) targets and the device consumes
            # it as a numeric link. Mirrors Coraza evaluating
            # libinjection-go on the host CPU (reference go.mod:24).
            include: list[int] = []
            exclude: list[int] = []
            for var in link.variables:
                kinds, err = self._kinds_of_variable(var, string_ctx=True)
                if err:
                    self.report.skip(rule_id, err)
                    continue
                (exclude if var.exclude else include).extend(kinds)
            if not include:
                return None
            opname = "sqli" if op.name == "detectsqli" else "xss"
            nv = self.numvars.intern(
                ("hostop", opname, pipeline, tuple(include), tuple(exclude))
            )
            self.links.append(
                CompiledLink(
                    LINK_NUMERIC,
                    negated=op.negated,
                    numvar=nv,
                    cmp=CMP_CODES["eq"],
                    cmp_arg=1,
                )
            )
            return len(self.links) - 1

        # String operator path. Unsupported-but-valid features are skipped
        # with a report entry (mirroring the corpus generator's
        # strip-with-warning); *invalid* patterns are hard errors — the
        # validation contract of coraza.NewWAF (reference
        # ruleset_controller.go:158-171) which marks the RuleSet Degraded.
        try:
            plan = lower_string_operator(op, self.env)
        except RegexParseError as e:
            raise CompileError(
                f"rule {rule_id}: invalid @{op.name} pattern {op.argument!r}: {e}"
            ) from e
        except (UnsupportedOperator, DFAError) as e:
            self.report.skip(rule_id, str(e))
            return None
        if plan.approximate:
            self.report.approximate(rule_id, f"@{op.name} approximated")

        include: list[int] = []
        exclude: list[int] = []
        for var in link.variables:
            if var.name == "TX" and not var.exclude:
                self.report.skip(rule_id, f"string match on TX:{var.selector} unsupported")
                continue
            kinds, err = self._kinds_of_variable(var, string_ctx=True)
            if err:
                self.report.skip(rule_id, err)
                continue
            (exclude if var.exclude else include).extend(kinds)
        if not include:
            return None
        # Dedup on the macro-EXPANDED argument: two rules sharing a macro
        # spelling but different resolved values must not share a DFA.
        key = ("str", op.name, plan.expanded_arg, pipeline)
        gid = self._intern_group(plan, pipeline, key)
        self.links.append(
            CompiledLink(
                LINK_STRING,
                negated=op.negated,
                group=gid,
                include_kinds=tuple(include),
                exclude_kinds=tuple(exclude),
            )
        )
        return len(self.links) - 1

    def _lower_numeric_link(self, link: Rule, rule_id: int | None) -> int | None:
        op = link.operator
        assert op is not None
        try:
            arg = parse_numeric_arg(op, self.env, self.runtime_tx)
        except UnsupportedOperator as e:
            self.report.skip(rule_id, str(e))
            return None

        var = link.variables[0] if link.variables else None
        if var is None:
            self.report.skip(rule_id, "numeric operator without variable")
            return None
        if len(link.variables) > 1:
            self.report.skip(
                rule_id, "numeric operator over multiple variables (first used)"
            )

        if isinstance(arg, str):
            # Runtime threshold: comparison against a TX counter.
            if var.name == "TX":
                self.report.skip(rule_id, f"TX-vs-TX comparison unsupported ({arg})")
                return None
            self.report.skip(rule_id, f"macro arg {arg!r} not a counter context")
            return None

        if var.name == "TX":
            cname = (var.selector or "").lower()
            cid = self._counter_id(cname)
            self.links.append(
                CompiledLink(
                    LINK_COUNTER,
                    negated=op.negated,
                    cmp=CMP_CODES[op.name],
                    cmp_arg=arg,
                    counter=cid,
                )
            )
            return len(self.links) - 1

        if var.count:
            sel = var.selector.lower() if var.selector else None
            nv = self.numvars.intern(("count", var.name, sel))
        elif var.name in NUMERIC_SCALARS:
            nv = self.numvars.intern(("scalar", var.name))
        else:
            self.report.skip(rule_id, f"numeric op on {var.render()} unsupported")
            return None
        self.links.append(
            CompiledLink(
                LINK_NUMERIC,
                negated=op.negated,
                cmp=CMP_CODES[op.name],
                cmp_arg=arg,
                numvar=nv,
            )
        )
        return len(self.links) - 1

    def _counter_id(self, name: str) -> int:
        if name not in self.counters:
            self.counters.append(name)
        return self.counters.index(name)

    def _counter_link(self, cname: str, cmp_name: str, arg: int) -> int:
        self.links.append(
            CompiledLink(
                LINK_COUNTER,
                cmp=CMP_CODES[cmp_name],
                cmp_arg=arg,
                counter=self._counter_id(cname),
            )
        )
        return len(self.links) - 1

    def _lower_rule_links(
        self, rule: Rule, defaults: list[Action], extra_excludes: list
    ) -> list[int] | None:
        """Re-lower a rule's chain with extra exclusion variables appended
        to the FIRST link (ctl:ruleRemoveTargetById applies to the rule's
        own target list, not chained sub-rules)."""
        link_ids: list[int] = []
        for li, link in enumerate(rule.all_rules()):
            pipeline = _effective_pipeline(link, defaults)
            mod = link
            if li == 0 and extra_excludes:
                mod = dataclasses.replace(
                    link, variables=list(link.variables) + list(extra_excludes)
                )
            lid = self._lower_link(mod, pipeline, rule.id)
            if lid is None:
                return None
            link_ids.append(lid)
        return link_ids

    # -- main walk ----------------------------------------------------------

    def run(self) -> CompiledRuleSet:
        program = self.program
        elements = program.elements
        default_status = 403
        i = 0
        seq = 0
        skip_to_marker: str | None = None
        while i < len(elements):
            el = elements[i]
            i += 1
            if isinstance(el, Marker):
                if skip_to_marker is not None and el.name == skip_to_marker:
                    skip_to_marker = None
                continue
            if skip_to_marker is not None:
                continue
            rule = el
            if program.is_removed(rule):
                self.report.const_eliminated += 1
                continue

            # SecAction (no operator): apply setvars to env at compile time
            # when constant; emit as runtime rule only if it has a decision.
            if rule.operator is None:
                self._apply_const_setvars(rule)
                if rule.skip_after:
                    skip_to_marker = rule.skip_after
                defaults = program.default_actions.get(rule.phase or 2, [])
                decision, status = _decision_of(rule, defaults, default_status)
                if decision in (DEC_DENY, DEC_DROP, DEC_REDIRECT):
                    self._emit_rule(rule, [self._emit_always()], seq)
                    seq += 1
                else:
                    self.report.const_eliminated += 1
                continue

            # Constant-foldable rule (paranoia gates etc.)?
            const = _try_const_eval(rule, self.env, self.runtime_tx)
            if const is not None:
                self.report.const_eliminated += 1
                if const:
                    self._apply_const_setvars(rule)
                    if rule.skip_after:
                        skip_to_marker = rule.skip_after
                    defaults = program.default_actions.get(rule.phase or 2, [])
                    decision, _ = _decision_of(rule, defaults, default_status)
                    if decision in (DEC_DENY, DEC_DROP):
                        # A constant deny — rare, but honor it.
                        self._emit_rule(rule, [self._emit_always()], seq)
                        seq += 1
                continue

            if rule.skip_after:
                self.report.skip(rule.id, "data-dependent skipAfter ignored")
            if rule.first_action("skip"):
                self.report.skip(rule.id, "data-dependent skip ignored")

            defaults = program.default_actions.get(rule.phase or 2, [])

            # SecRuleUpdateTargetById: extra targets (usually exclusions)
            # joined to the rule's own variable list at lowering time —
            # without mutating the parsed AST (a program lowered twice
            # must not accumulate the update twice).
            update_vars: list = []
            if rule.id is not None:
                for lo, hi, extra_vars in program.update_targets:
                    if lo <= rule.id <= hi:
                        update_vars.extend(_copy_variable(v) for v in extra_vars)

            link_ids: list[int] = []
            ok = True
            for li, link in enumerate(rule.all_rules()):
                pipeline = _effective_pipeline(link, defaults)
                bad = [t for t in pipeline if t not in HOST_TRANSFORMS]
                if bad:
                    self.report.skip(rule.id, f"transform(s) {bad} unsupported")
                    ok = False
                    break
                if li == 0 and update_vars:
                    link = dataclasses.replace(
                        link, variables=list(link.variables) + update_vars
                    )
                lid = self._lower_link(link, pipeline, rule.id)
                if lid is None:
                    ok = False
                    break
                link_ids.append(lid)
            if not ok or not link_ids:
                continue

            removals = self.ctl_target_removals.get(rule.id) if rule.id else None
            if not removals:
                self._emit_rule(rule, link_ids, seq)
                seq += 1
                continue

            # ctl:ruleRemoveTargetById variants. A: original targets,
            # active when NO removing ctl matched. B_k: target k excluded,
            # active when ctl k is the FIRST matching remover (exact for
            # a single remover; approximate — first-firing exclusion —
            # when several removers fire at once, reported below).
            a_links = link_ids + [
                self._counter_link(cn, "eq", 0) for cn, _ in removals
            ]
            self._emit_rule(rule, a_links, seq)
            seq += 1
            for k, (cname, excl_vars) in enumerate(removals):
                # update_vars ride along: variant links re-lower from the
                # pristine AST, which no longer carries the update.
                links_k = self._lower_rule_links(
                    rule, defaults, update_vars + list(excl_vars)
                )
                if links_k is None:
                    # Variant A alone is gated on the counter being 0, so
                    # a missing B variant removes the WHOLE rule whenever
                    # the ctl fires — record the over-removal.
                    self.report.approximate(
                        rule.id,
                        "ctl:ruleRemoveTargetById variant failed to lower; "
                        "rule fully disabled when the ctl rule matches",
                    )
                    continue
                gating = [self._counter_link(cname, "ge", 1)] + [
                    self._counter_link(cj, "eq", 0) for cj, _ in removals[:k]
                ]
                self._emit_rule(rule, links_k + gating, seq)
                seq += 1
            if len(removals) > 1:
                self.report.approximate(
                    rule.id,
                    "multiple ctl:ruleRemoveTargetById removers: "
                    "first-firing exclusion applied",
                )

        return self._finalize()

    def _emit_always(self) -> int:
        self.links.append(CompiledLink(LINK_ALWAYS))
        return len(self.links) - 1

    def _apply_const_setvars(self, rule: Rule) -> None:
        for sv in rule.setvars:
            parsed = _setvar_parse(sv)
            if parsed is None:
                continue
            name, op, value = parsed
            if not name.startswith("tx."):
                continue
            resolved = _resolve_value(value, self.env)
            if resolved is None:
                continue
            if op == "=":
                self.env[name] = resolved
            else:
                try:
                    cur = int(self.env.get(name, "0"))
                    delta = int(resolved)
                except ValueError:
                    continue
                self.env[name] = str(cur + delta if op == "+=" else cur - delta)

    def _emit_rule(self, rule: Rule, link_ids: list[int], seq: int) -> None:
        phase = rule.phase or 2
        defaults = self.program.default_actions.get(phase, [])
        decision, status = _decision_of(rule, defaults, 403)
        order_key = phase * 1_000_000 + seq
        # ctl runtime actions (reference: Coraza's per-transaction rule
        # removal; CRS exception rules use ctl:ruleRemoveById=lo-hi).
        ctl_ranges: list[tuple[int, int]] = []
        ctl_tags: list[str] = []
        all_actions = list(rule.actions) + [
            a for sub in rule.chain for a in sub.actions
        ]
        for a in all_actions:
            if a.name != "ctl" or not a.argument:
                continue
            key, _, val = a.argument.partition("=")
            key = key.strip().lower()
            val = val.strip()
            if key == "ruleremovebyid":
                if "-" in val and not val.startswith("-"):
                    lo, _, hi = val.partition("-")
                    if lo.isdigit() and hi.isdigit():
                        ctl_ranges.append((int(lo), int(hi)))
                elif val.isdigit():
                    ctl_ranges.append((int(val), int(val)))
            elif key == "ruleremovebytag":
                ctl_tags.append(val)
            elif key == "ruleremovetargetbyid":
                pass  # lowered as gated rule variants (see __init__ pre-pass)
            # other ctl keys (ruleEngine, auditEngine, ...) are per-
            # transaction engine switches the batch model does not carry;
            # recorded as approximations.
            elif key:
                self.report.approximate(rule.id, f"ctl:{key} ignored")
        self.rules.append(
            CompiledRule(
                rule_id=rule.id or 0,
                phase=phase,
                decision=decision,
                status=status,
                order_key=order_key,
                link_ids=link_ids,
                msg=rule.msg,
                severity=rule.severity,
                tags=rule.tags,
                logs=not any(a.name == "nolog" for a in rule.actions),
                ctl_remove_ranges=ctl_ranges,
                ctl_remove_tags=ctl_tags,
            )
        )
        # Record runtime setvar increments for the counter plan.
        incs: list[tuple[str, str, str]] = []
        for sv in rule.setvars:
            parsed = _setvar_parse(sv)
            if parsed is None or not parsed[0].startswith("tx."):
                continue
            incs.append(parsed)
        incs.extend(self.synthetic_incs.get(id(rule), ()))
        self.rule_setvars.append(incs)

    def _finalize(self) -> CompiledRuleSet:
        import re as _re

        n_rules = len(self.rules)

        # Transitively intern counters: a setvar target feeding an existing
        # counter via `dst=+%{tx.src}` makes `src` a counter too (CRS sums
        # tx.*_score_pl{n} into tx.blocking_inbound_anomaly_score this way).
        macro_pat = _re.compile(r"^%\{tx\.([a-z0-9_.-]+)\}$", _re.IGNORECASE)
        changed = True
        while changed:
            changed = False
            for incs in self.rule_setvars:
                for name, _op, value in incs:
                    dst = name.removeprefix("tx.")
                    m = macro_pat.match(value.strip())
                    if dst in self.counters and m:
                        src = m.group(1).lower()
                        if f"tx.{src}" not in self.env and src not in self.counters:
                            self.counters.append(src)
                            changed = True

        n_counters = max(1, len(self.counters))
        weights = np.zeros((n_rules, n_counters), dtype=np.int32)
        # Counter→counter linear transfer: edges[dst, src] = coefficient.
        edges = np.zeros((n_counters, n_counters), dtype=np.int32)
        for r, incs in enumerate(self.rule_setvars):
            for name, op, value in incs:
                cname = name.removeprefix("tx.")
                if cname not in self.counters:
                    continue  # not referenced by any threshold — irrelevant
                cid = self.counters.index(cname)
                sign = -1 if op == "-=" else 1
                m = macro_pat.match(value.strip())
                if m and m.group(1).lower() in self.counters:
                    # dst += tx.src — gated on the rule matching, but in the
                    # CRS pattern the gate is "src > 0" and adding a zero
                    # counter is a no-op, so the unconditional linear form is
                    # exact. ('=' assignment treated as increment.)
                    src = self.counters.index(m.group(1).lower())
                    edges[cid, src] += sign
                    continue
                resolved = _resolve_value(value, self.env)
                if resolved is None:
                    continue
                try:
                    delta = int(resolved)
                except ValueError:
                    continue
                # '=' on match approximated as increment (documented).
                weights[r, cid] += sign * delta

        # Fold the transfer chain: C = T·(base + Wᵀm) with T = Σ E^k
        # (counter DAGs are shallow; cap the series).
        transfer = np.eye(n_counters, dtype=np.int64)
        power = np.eye(n_counters, dtype=np.int64)
        for _ in range(4):
            power = power @ edges.astype(np.int64)
            if not power.any():
                break
            transfer += power
        weights = (weights.astype(np.int64) @ transfer.T).astype(np.int32)

        counter_base = np.zeros(n_counters, dtype=np.int32)
        for cid, cname in enumerate(self.counters):
            base = self.env.get(f"tx.{cname}")
            if base is not None:
                try:
                    counter_base[cid] = int(base)
                except ValueError:
                    pass
        counter_base = (transfer @ counter_base.astype(np.int64)).astype(np.int32)

        # Pipelines: distinct, device-capable flag.
        pipelines: list[tuple[str, ...]] = []
        pipeline_ids: dict[tuple[str, ...], int] = {}
        group_pipeline: list[int] = []
        for grp in self.groups:
            pid = pipeline_ids.get(grp.pipeline)
            if pid is None:
                pid = len(pipelines)
                pipeline_ids[grp.pipeline] = pid
                pipelines.append(grp.pipeline)
            group_pipeline.append(pid)
        pipeline_device = [
            all(t in DEVICE_TRANSFORMS for t in p) for p in pipelines
        ]

        # Minimization ledger: every automaton that reaches the device
        # (group DFAs + kind-regex DFAs) records its pre/post state
        # count — cko_dfa_states_{pre,post}_min_total and the CI
        # compile-time smoke ceiling read these.
        dfas = [g.dfa for g in self.groups] + list(
            self.vocab._regex_dfas.values()
        )
        self.report.dfa_states_post_min = sum(d.n_states for d in dfas)
        self.report.dfa_states_pre_min = sum(
            (d.pre_min_states or d.n_states) for d in dfas
        )

        return CompiledRuleSet(
            program=self.program,
            report=self.report.finalize(),
            groups=self.groups,
            rules=self.rules,
            links=self.links,
            vocab=self.vocab,
            numvars=self.numvars,
            counters=list(self.counters),
            counter_base=counter_base,
            weights=weights,
            pipelines=pipelines,
            pipeline_device=pipeline_device,
            group_pipeline=group_pipeline,
            engine_mode=self.program.engine_mode,
        )


def compile_program(program: RuleSetProgram) -> CompiledRuleSet:
    return _Lowering(program).run()


def compile_rules(text: str) -> CompiledRuleSet:
    """Parse + compile a Seclang document. Raises SeclangParseError /
    CompileError on invalid input (the controller's validation contract)."""
    program = parse(text)
    return compile_program(program)


# ---------------------------------------------------------------------------
# Persistent compiled-ruleset cache
# ---------------------------------------------------------------------------

def _compiler_fingerprint() -> str:
    """Hash of the compiler's own source (this package + seclang): a code
    change must invalidate cached artifacts, or a stale pickle would
    silently serve old semantics."""
    import hashlib
    import os

    h = hashlib.sha256()
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for sub in ("compiler", "seclang"):
        d = os.path.join(pkg_root, sub)
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                with open(os.path.join(d, name), "rb") as fh:
                    h.update(name.encode())
                    h.update(fh.read())
    return h.hexdigest()


_FPRINT_CACHE: list[str] = []


def compile_rules_cached(text: str, cache_dir: str | None = None) -> CompiledRuleSet:
    """``compile_rules`` with a persistent pickle cache keyed by
    (ruleset hash, compiler-source hash).

    compile_rules on the crs-lite corpus is ~30s of host work on the
    1-core bench machine, and the conformance gate re-needs the identical
    artifact on every run (the gate must finish in under 3 min). The
    cache dir defaults to ``$CKO_CRS_CACHE`` or ``~/.cache/cko-crs``;
    ``CKO_CRS_CACHE=0`` disables. Corrupt/stale entries recompile and
    overwrite; the compiler-source fingerprint in the key invalidates on
    any compiler/seclang change."""
    import hashlib
    import os
    import pickle

    loc = os.environ.get("CKO_CRS_CACHE", "")
    if loc == "0":
        return compile_rules(text)
    if cache_dir is None:
        cache_dir = loc or os.path.join(
            os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
            "cko-crs",
        )
    if not _FPRINT_CACHE:
        _FPRINT_CACHE.append(_compiler_fingerprint())
    digest = hashlib.sha256(
        (_FPRINT_CACHE[0] + "\n" + text).encode()
    ).hexdigest()
    path = os.path.join(cache_dir, f"{digest}.crs.pkl")
    try:
        with open(path, "rb") as fh:
            return pickle.load(fh)
    except FileNotFoundError:
        pass
    except Exception:
        pass  # corrupt entry: recompile and overwrite below
    crs = compile_rules(text)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            pickle.dump(crs, fh)
        os.replace(tmp, path)
    except OSError:
        pass
    return crs
