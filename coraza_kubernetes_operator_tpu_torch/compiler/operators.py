"""Seclang operator lowering.

Every string operator becomes DFA scanner tables (``re_dfa``); numeric
operators become vectorized comparisons. This is the TPU-native equivalent
of Coraza's operator registry (the reference consumes it via
``coraza.NewWAF``); ``@pmFromFile`` is intentionally unsupported exactly like
the reference corpus, whose generator strips those rules
(``hack/generate_coreruleset_configmaps.py`` ``--ignore-pmFromFile``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..seclang.ast import Operator
from .re_dfa import DFA, DFAError, compile_nfa_dfa, compile_regex_dfa, literal_dfa, pm_dfa
from .re_nfa import PositionNFA, TRUE_DNF


class UnsupportedOperator(ValueError):
    pass


_MACRO_RE = re.compile(r"%\{([^}]+)\}")

NUMERIC_OPS = {"eq", "ne", "ge", "gt", "le", "lt"}

# Comparison codes used by the device verdict kernel.
CMP_CODES = {"eq": 0, "ne": 1, "ge": 2, "gt": 3, "le": 4, "lt": 5}


def _load_data_lines(arg: str, env: dict[str, str]) -> list[str]:
    """Text lines of one-or-more data files (same resolution rules as
    ``@pmFromFile``): ``#`` comments and blanks stripped."""
    return [w.decode("latin-1", "replace") for w in _load_pm_file(arg, env)]


def _ipmatch_regex(entries: list[str]) -> str:
    """IPv4 addresses/CIDRs → anchored regex over the canonical dotted
    quad (REMOTE_ADDR is produced by the engine's own extraction, so no
    leading-zero/whitespace forms occur). Any CIDR decomposes into fixed
    leading octets + at most one partial-octet range + wildcard tail —
    each directly expressible as (tiny, prefix-shared) alternations that
    the DFA interns compactly. (Reference: Coraza's @ipMatch; IPv6 is
    rejected explicitly rather than silently un-matched.)"""
    alts: list[str] = []
    for entry in entries:
        entry = entry.strip()
        if not entry:
            continue
        if ":" in entry:
            raise UnsupportedOperator(f"@ipMatch: IPv6 not supported ({entry})")
        addr, _, mask_s = entry.partition("/")
        octets = addr.split(".")
        if len(octets) != 4 or not all(o.isdigit() and int(o) <= 255 for o in octets):
            raise UnsupportedOperator(f"@ipMatch: bad address {entry!r}")
        mask = int(mask_s) if mask_s else 32
        if not 0 <= mask <= 32:
            raise UnsupportedOperator(f"@ipMatch: bad mask {entry!r}")
        vals = [int(o) for o in octets]
        parts: list[str] = []
        full, rem = divmod(mask, 8)
        for i in range(full):
            parts.append(str(vals[i]))
        if rem and full < 4:
            lo = vals[full] & ~((1 << (8 - rem)) - 1)
            hi = lo + (1 << (8 - rem)) - 1
            parts.append("(?:" + "|".join(str(v) for v in range(lo, hi + 1)) + ")")
            full += 1
        for _ in range(full, 4):
            parts.append(r"\d{1,3}")
        alts.append(r"\.".join(parts))
    if not alts:
        raise UnsupportedOperator("@ipMatch: empty address list")
    return "^(?:" + "|".join(alts) + ")$"


def _load_pm_file(arg: str, env: dict[str, str]) -> list[bytes]:
    """Resolve and parse ``@pmFromFile`` data files (CRS ``*.data`` shape:
    one phrase per line, ``#`` comments, blank lines ignored). Relative
    paths resolve against ``SecDataDir``. Multiple files may be listed."""
    from pathlib import Path

    base = env.get("__secdatadir__", "")
    words: list[bytes] = []
    for name in arg.split():
        path = Path(name)
        if not path.is_absolute() and base:
            path = Path(base) / path
        try:
            raw = path.read_bytes()
        except OSError as err:
            raise UnsupportedOperator(
                f"@pmFromFile {name}: unreadable ({err}); set SecDataDir or "
                "use an absolute path"
            ) from err
        for line in raw.splitlines():
            line = line.split(b"#", 1)[0].strip()
            if line:
                words.append(line)
    if not words:
        raise UnsupportedOperator(f"@pmFromFile {arg}: no phrases found")
    return words


def expand_macros(arg: str, env: dict[str, str]) -> str:
    """Expand ``%{tx.name}`` macros from the compile-time TX environment
    (populated by unconditional SecAction setvars, e.g. CRS thresholds)."""

    def sub(m: re.Match) -> str:
        key = m.group(1).lower()
        if key in env:
            return str(env[key])
        raise UnsupportedOperator(f"unresolvable macro %{{{m.group(1)}}}")

    return _MACRO_RE.sub(sub, arg)


# Curated approximations of libinjection's detectors. The reference corpus
# itself uses @rx equivalents for SQLi/XSS (test/integration/
# coreruleset_test.go:67-88); these patterns cover the same attack classes.
# A faithful libinjection port is tracked as future work.
_DETECT_SQLI = (
    r"(?i:(union\s+(all\s+)?select)|(\bselect\b.+\bfrom\b)|(\binsert\s+into\b)"
    r"|(\bdrop\s+(table|database)\b)|(\bupdate\b.+\bset\b)|(\bdelete\s+from\b)"
    r"|('\s*(or|and)\b[^=]*=)|(\b(or|and)\b\s+'?\d+'?\s*=\s*'?\d+)"
    r"|(sleep\s*\()|(benchmark\s*\()|(load_file\s*\()|(information_schema)"
    r"|(;\s*(drop|alter|create|shutdown)\b)|('\s*;?\s*--)|(\bexec(ute)?\s+x?p_)"
    r"|(\bhaving\b\s+\d)|(\bgroup\s+by\b.+\()|(waitfor\s+delay))"
)
_DETECT_XSS = (
    r"(?i:(<script)|(javascript:)|(vbscript:)|(livescript:)"
    r"|(on(error|load|click|mouseover|mouseout|focus|blur|abort|change|submit)\s*=)"
    r"|(<iframe)|(<embed)|(<object)|(<applet)|(<meta)|(<form)"
    r"|(alert\s*\()|(confirm\s*\()|(prompt\s*\()|(document\s*\.\s*(cookie|write|location))"
    r"|(window\s*\.\s*location)|(expression\s*\()|(<svg[^>]*onload)|(srcdoc\s*=))"
)


def _within_dfa(arg: bytes) -> DFA:
    """``@within``: the *target* must be a substring of ``arg``. Built as a
    hand-assembled position NFA accepting exactly the substrings of ``arg``
    (entries anchored to start-of-target, accepts to end-of-target)."""
    nfa = PositionNFA(classes=[1 << c for c in arg])
    start_cond = frozenset({frozenset({"start"})})
    end_cond = frozenset({frozenset({"end"})})
    for i in range(len(arg)):
        nfa.entries[i] = start_cond
        nfa.accepts[i] = end_cond
        if i + 1 < len(arg):
            nfa.edges[i] = {i + 1: TRUE_DNF}
    # The empty target is a substring.
    nfa.empty_dnf = frozenset({frozenset({"start", "end"})})
    return compile_nfa_dfa(nfa)


def _byte_range_dfa(arg: str) -> DFA:
    """``@validateByteRange 1-255,32``: matches when the target contains a
    byte OUTSIDE the allowed set — a single complement char class."""
    allowed = 0
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        lo, sep, hi = part.partition("-")
        try:
            lo_v = int(lo)
            hi_v = int(hi) if sep else lo_v
        except ValueError as e:
            raise UnsupportedOperator(f"bad byte range {part!r}") from e
        if not (0 <= lo_v <= 255 and 0 <= hi_v <= 255 and lo_v <= hi_v):
            raise UnsupportedOperator(f"bad byte range {part!r}")
        for b in range(lo_v, hi_v + 1):
            allowed |= 1 << b
    from .re_parser import ALL_BYTES, RChar
    from .re_nfa import build_position_nfa

    bad = ALL_BYTES & ~allowed
    if bad == 0:
        raise UnsupportedOperator("byte range allows all bytes")
    return compile_nfa_dfa(build_position_nfa(RChar(bad)))


_VALIDATE_URLENC = "%([^0-9A-Fa-f]|$|[0-9A-Fa-f]([^0-9A-Fa-f]|$))"

# EXACT UTF-8 validation without lookaround: anchor at start-of-input,
# consume any number of VALID units, then require one INVALID unit start.
# A byte string contains an encoding error iff its longest valid prefix is
# followed by a non-unit — this formulation IS that definition, so it is
# exact (the round-1 approximation missed mid-stream stray continuations).
# Valid units enforce the ModSecurity checks: continuation counts,
# overlongs (E0 A0.., F0 90..), surrogates (ED 80-9F only), max U+10FFFF
# (F4 80-8F only), never-valid leads C0/C1/F5-FF.
_UTF8_UNIT = (
    "(?:[\\x00-\\x7F]"
    "|[\\xC2-\\xDF][\\x80-\\xBF]"
    "|\\xE0[\\xA0-\\xBF][\\x80-\\xBF]"
    "|[\\xE1-\\xEC\\xEE\\xEF][\\x80-\\xBF][\\x80-\\xBF]"
    "|\\xED[\\x80-\\x9F][\\x80-\\xBF]"
    "|\\xF0[\\x90-\\xBF][\\x80-\\xBF][\\x80-\\xBF]"
    "|[\\xF1-\\xF3][\\x80-\\xBF][\\x80-\\xBF][\\x80-\\xBF]"
    "|\\xF4[\\x80-\\x8F][\\x80-\\xBF][\\x80-\\xBF])"
)
_UTF8_INVALID = (
    "(?:[\\x80-\\xBF\\xC0\\xC1\\xF5-\\xFF]"
    "|[\\xC2-\\xDF](?:[^\\x80-\\xBF]|$)"
    "|\\xE0(?:[^\\xA0-\\xBF]|$|[\\xA0-\\xBF](?:[^\\x80-\\xBF]|$))"
    "|[\\xE1-\\xEC\\xEE\\xEF](?:[^\\x80-\\xBF]|$|[\\x80-\\xBF](?:[^\\x80-\\xBF]|$))"
    "|\\xED(?:[^\\x80-\\x9F]|$|[\\x80-\\x9F](?:[^\\x80-\\xBF]|$))"
    "|\\xF0(?:[^\\x90-\\xBF]|$|[\\x90-\\xBF](?:[^\\x80-\\xBF]|$"
    "|[\\x80-\\xBF](?:[^\\x80-\\xBF]|$)))"
    "|[\\xF1-\\xF3](?:[^\\x80-\\xBF]|$|[\\x80-\\xBF](?:[^\\x80-\\xBF]|$"
    "|[\\x80-\\xBF](?:[^\\x80-\\xBF]|$)))"
    "|\\xF4(?:[^\\x80-\\x8F]|$|[\\x80-\\x8F](?:[^\\x80-\\xBF]|$"
    "|[\\x80-\\xBF](?:[^\\x80-\\xBF]|$))))"
)
_VALIDATE_UTF8 = f"^{_UTF8_UNIT}*{_UTF8_INVALID}"


@dataclass
class StringOpPlan:
    dfa: DFA
    approximate: bool = False
    expanded_arg: str = ""  # macro-expanded argument — the dedup identity


def lower_string_operator(op: Operator, env: dict[str, str]) -> StringOpPlan:
    """Lower a string-matching operator to DFA tables.

    Raises UnsupportedOperator for operators that cannot be lowered (caller
    records them in the compile report, mirroring the corpus generator's
    strip-with-warning behavior)."""
    name = op.name
    arg = expand_macros(op.argument, env)
    raw = arg.encode("latin-1", errors="replace")

    if name == "rx":
        return StringOpPlan(compile_regex_dfa(arg), expanded_arg=arg)
    if name in ("contains", "strmatch"):
        return StringOpPlan(literal_dfa(raw), expanded_arg=arg)
    if name == "containsword":
        escaped = re.escape(arg)
        return StringOpPlan(compile_regex_dfa(rf"\b{escaped}\b"), expanded_arg=arg)
    if name == "streq":
        return StringOpPlan(literal_dfa(raw, exact=True), expanded_arg=arg)
    if name == "beginswith":
        return StringOpPlan(literal_dfa(raw, begins_with=True), expanded_arg=arg)
    if name == "endswith":
        return StringOpPlan(literal_dfa(raw, ends_with=True), expanded_arg=arg)
    if name == "within":
        return StringOpPlan(_within_dfa(raw), expanded_arg=arg)
    if name == "pm":
        words = [w.encode("latin-1", errors="replace") for w in arg.split()]
        return StringOpPlan(pm_dfa(words), expanded_arg=arg)
    if name in ("pmf", "pmfromfile"):
        # Vendored data files (CRS *.data shape: one phrase per line, '#'
        # comments). The reference corpus STRIPS these rules because
        # coraza-proxy-wasm has no filesystem (generate_coreruleset_
        # configmaps.py --ignore-pmFromFile); first-party data plane means
        # we can support them (gated on a configured data dir).
        words = _load_pm_file(arg, env)
        return StringOpPlan(pm_dfa(words), expanded_arg=arg)
    if name in ("ipmatch", "ipmatchfromfile"):
        if name == "ipmatchfromfile":
            entries = _load_data_lines(arg, env)
        else:
            entries = [e.strip() for e in arg.split(",") if e.strip()]
        return StringOpPlan(
            compile_regex_dfa(_ipmatch_regex(entries)), expanded_arg=arg
        )
    if name == "detectsqli":
        return StringOpPlan(compile_regex_dfa(_DETECT_SQLI), approximate=True, expanded_arg=arg)
    if name == "detectxss":
        return StringOpPlan(compile_regex_dfa(_DETECT_XSS), approximate=True, expanded_arg=arg)
    if name == "validatebyterange":
        return StringOpPlan(_byte_range_dfa(arg), expanded_arg=arg)
    if name == "validateurlencoding":
        return StringOpPlan(compile_regex_dfa(_VALIDATE_URLENC), expanded_arg=arg)
    if name == "validateutf8encoding":
        # Exact (differential-tested against Python's UTF-8 decoder).
        return StringOpPlan(compile_regex_dfa(_VALIDATE_UTF8), expanded_arg=arg)
    raise UnsupportedOperator(f"@{name} has no TPU lowering yet")


def parse_numeric_arg(
    op: Operator, env: dict[str, str], runtime_tx: frozenset[str] | set[str] = frozenset()
) -> int | str:
    """Numeric operator argument: either a constant int, or the name of a
    runtime TX counter (returned as str) for e.g.
    ``@ge %{tx.inbound_anomaly_score_threshold}``. ``runtime_tx`` names are
    runtime counters even when the env carries an initial value."""
    arg = op.argument.strip()
    m = _MACRO_RE.fullmatch(arg)
    if m:
        key = m.group(1).lower()
        name = key.removeprefix("tx.")
        if name in runtime_tx:
            return name
        if key in env:
            arg = str(env[key])
        else:
            return name  # runtime counter reference
    try:
        return int(arg)
    except ValueError as e:
        raise UnsupportedOperator(f"non-integer numeric arg {arg!r}") from e
