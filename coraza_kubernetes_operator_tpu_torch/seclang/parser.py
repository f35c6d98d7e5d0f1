"""Seclang directive parser.

Strict parse-or-fail semantics mirroring coraza's ``WithDirectives`` path
(reference ``internal/controller/ruleset_controller.go:158-171`` treats any
parse error as an invalid RuleSet): unknown directives, operators, variables,
transforms, bad phases and duplicate rule ids are all errors.
"""

from __future__ import annotations

from .ast import (
    Action,
    KNOWN_ACTIONS,
    KNOWN_OPERATORS,
    KNOWN_TRANSFORMS,
    KNOWN_VARIABLES,
    Marker,
    Operator,
    Rule,
    RuleSetProgram,
    SeclangParseError,
    Variable,
)

_BOOL_DIRECTIVES = {
    "secrequestbodyaccess": "request_body_access",
    "secresponsebodyaccess": "response_body_access",
}

_INT_DIRECTIVES = {
    "secrequestbodylimit": "request_body_limit",
    "secrequestbodyinmemorylimit": "request_body_in_memory_limit",
    "secresponsebodylimit": "response_body_limit",
}

# Configuration directives accepted verbatim into ``program.config``.
_PASSTHROUGH_DIRECTIVES = {
    "secauditengine",
    "secauditlog",
    "secauditlogdir",
    "secauditlogformat",
    "secauditlogtype",
    "secauditlogparts",
    "secauditlogrelevantstatus",
    "secauditlogstoragedir",
    "secargumentseparator",
    "secargumentslimit",
    "seccollectiontimeout",
    "seccomponentsignature",
    "seccookieformat",
    "secdatadir",
    "secdebuglog",
    "secdebugloglevel",
    "secignorerulecompilationerrors",
    "secpcrematchlimit",
    "secpcrematchlimitrecursion",
    "secrequestbodynofileslimit",
    "secresponsebodylimitaction",
    "secresponsebodymimetype",
    "secresponsebodymimetypesclear",
    "secserversignature",
    "secstatusengine",
    "sectmpdir",
    "secunicodemapfile",
    "secuploaddir",
    "secuploadfilelimit",
    "secuploadfilemode",
    "secuploadkeepfiles",
    "secwebappid",
    "secremoterulesfailaction",
}


def _logical_lines(text: str) -> list[tuple[int, str]]:
    """Join backslash-continued lines; drop blanks and ``#`` comments.

    Returns (1-based starting line number, logical line) pairs.
    """
    out: list[tuple[int, str]] = []
    pending: list[str] = []
    pending_start = 0
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip()
        if not pending:
            stripped = line.lstrip()
            if not stripped or stripped.startswith("#"):
                continue
            pending_start = i
        if line.endswith("\\"):
            pending.append(line[:-1])
            continue
        pending.append(line)
        out.append((pending_start, " ".join(p.strip() for p in pending).strip()))
        pending = []
    if pending:
        out.append((pending_start, " ".join(p.strip() for p in pending).strip()))
    return out


def _tokenize(line: str, lineno: int) -> list[str]:
    """Split a directive line into whitespace-delimited tokens.

    Tokens may be wrapped in double or single quotes; the wrapping quote may
    be escaped inside with a backslash (only the wrapper's escape is removed —
    all other backslashes stay literal, they belong to regexes).
    """
    tokens: list[str] = []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i].isspace():
            i += 1
        if i >= n:
            break
        ch = line[i]
        if ch in "\"'":
            quote = ch
            i += 1
            buf: list[str] = []
            while i < n:
                c = line[i]
                if c == "\\" and i + 1 < n and line[i + 1] == quote:
                    buf.append(quote)
                    i += 2
                    continue
                if c == quote:
                    break
                buf.append(c)
                i += 1
            if i >= n:
                raise SeclangParseError("unterminated quoted token", lineno)
            i += 1  # closing quote
            tokens.append("".join(buf))
        else:
            start = i
            while i < n and not line[i].isspace():
                i += 1
            tokens.append(line[start:i])
    return tokens


def _parse_variables(token: str, lineno: int) -> list[Variable]:
    variables: list[Variable] = []
    # Split on '|' at top level. '|' inside a /regex/ selector is literal;
    # regex mode starts when '/' follows the ':' selector separator (plain
    # form ARGS:/re/) or ":'" (quoted form ARGS:'/re/') and ends at the next
    # '/' (a '/' elsewhere in a plain selector, e.g. ARGS:a/b, is just a
    # character).
    parts: list[str] = []
    buf: list[str] = []
    in_regex = False
    prev: str | None = None
    prev2: str | None = None
    for c in token:
        if in_regex:
            buf.append(c)
            if c == "/":
                in_regex = False
        elif c == "/" and (prev == ":" or (prev == "'" and prev2 == ":")):
            in_regex = True
            buf.append(c)
        elif c == "|":
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        prev2 = prev
        prev = c
    if in_regex:
        raise SeclangParseError("unterminated /regex/ selector", lineno)
    parts.append("".join(buf))

    for part in parts:
        part = part.strip()
        if not part:
            raise SeclangParseError("empty variable in variable list", lineno)
        exclude = count = False
        if part.startswith("!"):
            exclude = True
            part = part[1:]
        elif part.startswith("&"):
            count = True
            part = part[1:]
        name, sep, selector = part.partition(":")
        name = name.strip().upper()
        if name not in KNOWN_VARIABLES:
            raise SeclangParseError(f"unknown variable {name!r}", lineno)
        sel: str | None = None
        sel_is_regex = False
        if sep:
            selector = selector.strip()
            if selector.startswith("'") and selector.endswith("'") and len(selector) >= 2:
                selector = selector[1:-1]
            if selector.startswith("/") and selector.endswith("/") and len(selector) >= 2:
                sel_is_regex = True
                selector = selector[1:-1]
            sel = selector
        variables.append(
            Variable(name=name, selector=sel, count=count, exclude=exclude,
                     selector_is_regex=sel_is_regex)
        )
    return variables


def _parse_operator(token: str, lineno: int) -> Operator:
    negated = False
    body = token
    if body.startswith("!"):
        negated = True
        body = body[1:]
    if body.startswith("@"):
        name, _, argument = body[1:].partition(" ")
        name = name.strip().lower()
        if name not in KNOWN_OPERATORS:
            raise SeclangParseError(f"unknown operator @{name}", lineno)
        return Operator(name=name, argument=argument.strip(), negated=negated)
    # Bare pattern ⇒ implicit @rx.
    return Operator(name="rx", argument=body, negated=negated)


def _split_actions(token: str, lineno: int) -> list[str]:
    """Split the action string on top-level commas ('...'-quoted values keep
    their commas)."""
    items: list[str] = []
    buf: list[str] = []
    in_quote = False
    i, n = 0, len(token)
    while i < n:
        c = token[i]
        if c == "\\" and in_quote and i + 1 < n and token[i + 1] == "'":
            buf.append("'")
            i += 2
            continue
        if c == "'":
            in_quote = not in_quote
            buf.append(c)
        elif c == "," and not in_quote:
            items.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        i += 1
    if in_quote:
        raise SeclangParseError("unterminated quote in actions", lineno)
    items.append("".join(buf))
    return [item.strip() for item in items if item.strip()]


def _parse_actions(token: str, lineno: int) -> list[Action]:
    actions: list[Action] = []
    for item in _split_actions(token, lineno):
        name, sep, value = item.partition(":")
        name = name.strip().lower()
        if name not in KNOWN_ACTIONS:
            raise SeclangParseError(f"unknown action {name!r}", lineno)
        if not sep:
            actions.append(Action(name=name))
            continue
        value = value.strip()
        if value.startswith("'") and value.endswith("'") and len(value) >= 2:
            value = value[1:-1]
        if name == "t" and value.lower() not in KNOWN_TRANSFORMS:
            raise SeclangParseError(f"unknown transformation t:{value}", lineno)
        actions.append(Action(name=name, argument=value))
    return actions


def _validate_rule(rule: Rule, lineno: int, chained: bool) -> None:
    if rule.phase is not None and not 1 <= rule.phase <= 5:
        raise SeclangParseError(f"invalid phase {rule.first_action('phase')}", lineno)
    if not chained and rule.operator is not None and rule.id is None:
        raise SeclangParseError("rule missing mandatory id action", lineno)
    if chained and rule.id is not None:
        # ModSecurity forbids ids on chained rules.
        raise SeclangParseError("chained rule must not have an id", lineno)
    status = rule.first_action("status")
    if status is not None and not status.isdigit():
        raise SeclangParseError(f"invalid status {status!r}", lineno)


def parse(text: str) -> RuleSetProgram:
    """Parse a Seclang document into a :class:`RuleSetProgram`.

    Raises :class:`SeclangParseError` on any invalid directive — the
    controller surfaces this as an InvalidRuleSet condition exactly like the
    reference surfaces coraza parse errors.
    """
    program = RuleSetProgram()
    seen_ids: set[int] = set()
    open_chain: Rule | None = None  # chain starter awaiting chained rules
    chain_pending = 0  # outstanding chained rules expected

    for lineno, line in _logical_lines(text):
        tokens = _tokenize(line, lineno)
        if not tokens:
            continue
        directive = tokens[0].lower()
        args = tokens[1:]

        if directive == "secrule":
            if len(args) < 2 or len(args) > 3:
                raise SeclangParseError(
                    f"SecRule expects VARIABLES OPERATOR [ACTIONS], got {len(args)} args",
                    lineno,
                )
            rule = Rule(
                variables=_parse_variables(args[0], lineno),
                operator=_parse_operator(args[1], lineno),
                actions=_parse_actions(args[2], lineno) if len(args) == 3 else [],
                line=lineno,
                raw=line,
            )
            chained = chain_pending > 0
            _validate_rule(rule, lineno, chained)
            if chained:
                assert open_chain is not None
                open_chain.chain.append(rule)
                chain_pending -= 1
                if rule.is_chain_starter:
                    chain_pending += 1
                if chain_pending == 0:
                    open_chain = None
            else:
                if rule.id is not None:
                    if rule.id in seen_ids:
                        raise SeclangParseError(f"duplicate rule id {rule.id}", lineno)
                    seen_ids.add(rule.id)
                program.elements.append(rule)
                if rule.is_chain_starter:
                    open_chain = rule
                    chain_pending = 1
            continue

        if directive == "secaction":
            if len(args) != 1:
                raise SeclangParseError("SecAction expects exactly one argument", lineno)
            rule = Rule(actions=_parse_actions(args[0], lineno), line=lineno, raw=line)
            if chain_pending > 0:
                raise SeclangParseError("SecAction cannot appear inside a chain", lineno)
            if rule.id is None:
                raise SeclangParseError("SecAction missing mandatory id action", lineno)
            if rule.id in seen_ids:
                raise SeclangParseError(f"duplicate rule id {rule.id}", lineno)
            seen_ids.add(rule.id)
            program.elements.append(rule)
            continue

        if directive == "secdefaultaction":
            if len(args) != 1:
                raise SeclangParseError("SecDefaultAction expects exactly one argument", lineno)
            actions = _parse_actions(args[0], lineno)
            phase_vals = [a.argument for a in actions if a.name == "phase"]
            if len(phase_vals) != 1 or phase_vals[0] is None or not phase_vals[0].isdigit():
                raise SeclangParseError("SecDefaultAction requires a phase", lineno)
            phase = int(phase_vals[0])
            if not 1 <= phase <= 5:
                raise SeclangParseError(f"invalid phase {phase}", lineno)
            program.default_actions[phase] = actions
            continue

        if directive == "secmarker":
            if len(args) != 1:
                raise SeclangParseError("SecMarker expects exactly one argument", lineno)
            program.elements.append(Marker(name=args[0].strip("\"'"), line=lineno))
            continue

        if directive == "secruleengine":
            if len(args) != 1 or args[0] not in ("On", "Off", "DetectionOnly"):
                raise SeclangParseError(
                    "SecRuleEngine expects On|Off|DetectionOnly", lineno
                )
            program.engine_mode = args[0]
            continue

        if directive in _BOOL_DIRECTIVES:
            if len(args) != 1 or args[0] not in ("On", "Off"):
                raise SeclangParseError(f"{tokens[0]} expects On|Off", lineno)
            setattr(program, _BOOL_DIRECTIVES[directive], args[0] == "On")
            continue

        if directive in _INT_DIRECTIVES:
            if len(args) != 1 or not args[0].isdigit():
                raise SeclangParseError(f"{tokens[0]} expects an integer", lineno)
            setattr(program, _INT_DIRECTIVES[directive], int(args[0]))
            continue

        if directive == "secrequestbodylimitaction":
            # Enforced by the engine: Reject interrupts over-limit bodies
            # with 413 (Coraza semantics); ProcessPartial truncates at the
            # limit and evaluates the prefix. Value is case-insensitive
            # like every other Seclang engine keyword.
            canon = {"reject": "Reject", "processpartial": "ProcessPartial"}
            if len(args) != 1 or args[0].lower() not in canon:
                raise SeclangParseError(
                    "SecRequestBodyLimitAction expects Reject|ProcessPartial",
                    lineno,
                )
            program.request_body_limit_action = canon[args[0].lower()]
            continue

        if directive == "secruleremovebyid":
            for arg in args:
                arg = arg.strip()
                if "-" in arg and not arg.startswith("-"):
                    lo, _, hi = arg.partition("-")
                    if not (lo.isdigit() and hi.isdigit()):
                        raise SeclangParseError(f"invalid id range {arg!r}", lineno)
                    program.removed_id_ranges.append((int(lo), int(hi)))
                elif arg.isdigit():
                    program.removed_id_ranges.append((int(arg), int(arg)))
                else:
                    raise SeclangParseError(f"invalid rule id {arg!r}", lineno)
            continue

        if directive == "secruleremovebytag":
            if len(args) != 1:
                raise SeclangParseError("SecRuleRemoveByTag expects one tag", lineno)
            program.removed_tags.append(args[0].strip("\"'"))
            continue

        if directive == "secruleupdatetargetbyid":
            # Applied by the compiler: appends targets (usually
            # exclusions like "!ARGS:pwd") to the named rules' variable
            # lists before lowering (Coraza/ModSec update-target).
            if len(args) < 2:
                raise SeclangParseError(
                    "SecRuleUpdateTargetById expects <id|id-range> <targets>",
                    lineno,
                )
            spec = args[0].strip()
            if "-" in spec and not spec.startswith("-"):
                lo, _, hi = spec.partition("-")
                if not (lo.isdigit() and hi.isdigit()):
                    raise SeclangParseError(f"invalid id range {spec!r}", lineno)
                id_lo, id_hi = int(lo), int(hi)
            elif spec.isdigit():
                id_lo = id_hi = int(spec)
            else:
                raise SeclangParseError(f"invalid rule id {spec!r}", lineno)
            variables = _parse_variables(args[1], lineno)
            # The 3-argument REPLACE form (target, replaced-target) is not
            # implemented; appending only would silently keep the replaced
            # target active, so record the whole spec for the compile
            # report instead of half-applying it.
            if len(args) > 2:
                program.config.setdefault("secruleupdatetargetbyid_replace", "")
                program.config["secruleupdatetargetbyid_replace"] += (
                    (";" if program.config["secruleupdatetargetbyid_replace"] else "")
                    + " ".join(args)
                )
            else:
                program.update_targets.append((id_lo, id_hi, variables))
            continue

        if directive in ("secruleupdateactionbyid", "secruleupdatetargetbytag"):
            # Stored for the compiler; currently recorded but not applied.
            program.config.setdefault(directive, "")
            program.config[directive] += (";" if program.config[directive] else "") + " ".join(args)
            continue

        if directive in _PASSTHROUGH_DIRECTIVES:
            program.config[directive] = " ".join(args)
            continue

        raise SeclangParseError(f"unknown directive {tokens[0]!r}", lineno)

    if chain_pending > 0:
        raise SeclangParseError("unterminated rule chain at end of input", 0)
    return program
