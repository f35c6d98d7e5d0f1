"""Typed AST for Seclang directives."""

from __future__ import annotations

from dataclasses import dataclass, field


class SeclangParseError(ValueError):
    """Raised on invalid Seclang input; carries the 1-based source line."""

    def __init__(self, message: str, line: int):
        super().__init__(f"line {line}: {message}")
        self.line = line


# Variables the engine understands, in canonical (upper-case) form. Collections
# (ARGS, REQUEST_HEADERS, ...) expand to many targets per request; scalars
# (REQUEST_URI, REQUEST_BODY, ...) to exactly one.
KNOWN_VARIABLES = {
    "ARGS",
    "ARGS_NAMES",
    "ARGS_GET",
    "ARGS_GET_NAMES",
    "ARGS_POST",
    "ARGS_POST_NAMES",
    "ARGS_COMBINED_SIZE",
    "QUERY_STRING",
    "REQUEST_URI",
    "REQUEST_URI_RAW",
    "REQUEST_BASENAME",
    "REQUEST_FILENAME",
    "REQUEST_LINE",
    "REQUEST_METHOD",
    "REQUEST_PROTOCOL",
    "REQUEST_BODY",
    "REQUEST_BODY_LENGTH",
    "REQUEST_HEADERS",
    "REQUEST_HEADERS_NAMES",
    "REQUEST_COOKIES",
    "REQUEST_COOKIES_NAMES",
    "RESPONSE_BODY",
    "RESPONSE_HEADERS",
    "RESPONSE_STATUS",
    "REQBODY_ERROR",
    "REQBODY_PROCESSOR",
    "MULTIPART_STRICT_ERROR",
    "MULTIPART_UNMATCHED_BOUNDARY",
    "FILES",
    "FILES_NAMES",
    "FILES_COMBINED_SIZE",
    "GEO",
    "REMOTE_ADDR",
    "REMOTE_HOST",
    "SERVER_NAME",
    "SERVER_ADDR",
    "TX",
    "IP",
    "GLOBAL",
    "SESSION",
    "ENV",
    "TIME",
    "TIME_DAY",
    "TIME_EPOCH",
    "TIME_HOUR",
    "TIME_MIN",
    "TIME_MON",
    "TIME_SEC",
    "TIME_WDAY",
    "TIME_YEAR",
    "UNIQUE_ID",
    "MATCHED_VAR",
    "MATCHED_VAR_NAME",
    "MATCHED_VARS",
    "MATCHED_VARS_NAMES",
    "DURATION",
    "WEBAPPID",
    "XML",
    "JSON",
    "AUTH_TYPE",
    "FULL_REQUEST",
    "FULL_REQUEST_LENGTH",
    "PATH_INFO",
    "STATUS_LINE",
}

# Operators the compiler can lower (or constant-fold). Anything else is a
# parse-time validation error, mirroring coraza's strict operator registry.
KNOWN_OPERATORS = {
    "rx",
    "contains",
    "containsword",
    "streq",
    "strmatch",
    "beginswith",
    "endswith",
    "within",
    "pm",
    "pmf",
    "pmfromfile",
    "eq",
    "ne",
    "ge",
    "gt",
    "le",
    "lt",
    "detectsqli",
    "detectxss",
    "validatebyterange",
    "validateurlencoding",
    "validateutf8encoding",
    "unconditionalmatch",
    "nomatch",
    "rbl",
    "geolookup",
    "ipmatch",
    "ipmatchfromfile",
    "verifycc",
    "restpath",
    "validateschema",
}

# Transformation functions. Implemented ones are lowered to byte kernels
# (ops/transforms.py); the rest parse but are rejected at compile time.
KNOWN_TRANSFORMS = {
    "none",
    "lowercase",
    "uppercase",
    "urldecode",
    "urldecodeuni",
    "urlencode",
    "htmlentitydecode",
    "removewhitespace",
    "compresswhitespace",
    "removenulls",
    "replacenulls",
    "removecomments",
    "removecommentschar",
    "replacecomments",
    "jsdecode",
    "cssdecode",
    "base64decode",
    "base64decodeext",
    "base64encode",
    "hexdecode",
    "hexencode",
    "length",
    "trim",
    "trimleft",
    "trimright",
    "normalisepath",
    "normalizepath",
    "normalisepathwin",
    "normalizepathwin",
    "utf8tounicode",
    "sha1",
    "md5",
    "cmdline",
    "escapeseqdecode",
}

DISRUPTIVE_ACTIONS = {"deny", "drop", "block", "redirect", "allow", "pass", "proxy"}

# Action names accepted by the parser (superset used by CRS v4).
KNOWN_ACTIONS = DISRUPTIVE_ACTIONS | {
    "id",
    "phase",
    "status",
    "msg",
    "logdata",
    "tag",
    "severity",
    "ver",
    "rev",
    "maturity",
    "accuracy",
    "t",
    "setvar",
    "setenv",
    "ctl",
    "chain",
    "skip",
    "skipafter",
    "log",
    "nolog",
    "auditlog",
    "noauditlog",
    "capture",
    "multimatch",
    "initcol",
    "expirevar",
    "deprecatevar",
    "exec",
    "append",
    "prepend",
    "sanitisearg",
    "sanitisematched",
    "sanitiserequestheader",
    "sanitiseresponseheader",
}

SEVERITY_LEVELS = {
    "EMERGENCY": 0,
    "ALERT": 1,
    "CRITICAL": 2,
    "ERROR": 3,
    "WARNING": 4,
    "NOTICE": 5,
    "INFO": 6,
    "DEBUG": 7,
}


@dataclass(frozen=True)
class Variable:
    """One entry of a SecRule variable list, e.g. ``!ARGS:foo`` or ``&TX:bar``."""

    name: str
    selector: str | None = None
    count: bool = False
    exclude: bool = False
    selector_is_regex: bool = False

    def render(self) -> str:
        prefix = "!" if self.exclude else "&" if self.count else ""
        if self.selector is None:
            return f"{prefix}{self.name}"
        sel = f"/{self.selector}/" if self.selector_is_regex else self.selector
        return f"{prefix}{self.name}:{sel}"


@dataclass(frozen=True)
class Operator:
    """SecRule operator, e.g. ``@rx pattern`` (negatable, @rx implicit)."""

    name: str
    argument: str = ""
    negated: bool = False

    def render(self) -> str:
        neg = "!" if self.negated else ""
        return f"{neg}@{self.name} {self.argument}".rstrip()


@dataclass(frozen=True)
class Action:
    name: str
    argument: str | None = None

    def render(self) -> str:
        if self.argument is None:
            return self.name
        return f"{self.name}:{self.argument}"


@dataclass
class Rule:
    """A SecRule or SecAction (SecAction has no variables/operator).

    ``chain`` holds chained sub-rules (logical AND, sharing this rule's
    actions for the final disruptive decision).
    """

    variables: list[Variable] = field(default_factory=list)
    operator: Operator | None = None
    actions: list[Action] = field(default_factory=list)
    chain: list[Rule] = field(default_factory=list)
    line: int = 0
    raw: str = ""

    # ---- resolved accessors -------------------------------------------------

    def action_values(self, name: str) -> list[str]:
        return [a.argument or "" for a in self.actions if a.name == name]

    def first_action(self, name: str) -> str | None:
        vals = self.action_values(name)
        return vals[0] if vals else None

    @property
    def id(self) -> int | None:
        v = self.first_action("id")
        return int(v) if v is not None else None

    @property
    def phase(self) -> int | None:
        v = self.first_action("phase")
        if v is None:
            return None
        named = {"request": 2, "response": 4, "logging": 5}
        return named.get(v, None) if not v.isdigit() else int(v)

    @property
    def transformations(self) -> list[str]:
        return [v.lower() for v in self.action_values("t")]

    @property
    def disruptive(self) -> str | None:
        for a in self.actions:
            if a.name in DISRUPTIVE_ACTIONS:
                return a.name
        return None

    @property
    def status(self) -> int | None:
        v = self.first_action("status")
        return int(v) if v is not None else None

    @property
    def severity(self) -> str | None:
        v = self.first_action("severity")
        if v is None:
            return None
        v = v.strip("'\"")
        if v.isdigit():
            inv = {num: name for name, num in SEVERITY_LEVELS.items()}
            return inv.get(int(v))
        return v.upper()

    @property
    def tags(self) -> list[str]:
        return [v.strip("'\"") for v in self.action_values("tag")]

    @property
    def msg(self) -> str | None:
        v = self.first_action("msg")
        return v.strip("'\"") if v is not None else None

    @property
    def setvars(self) -> list[str]:
        return [v.strip("'\"") for v in self.action_values("setvar")]

    @property
    def is_chain_starter(self) -> bool:
        return any(a.name == "chain" for a in self.actions)

    @property
    def skip_after(self) -> str | None:
        v = self.first_action("skipafter")
        return v.strip("'\"") if v is not None else None

    def all_rules(self) -> list[Rule]:
        return [self, *self.chain]


@dataclass(frozen=True)
class Marker:
    """SecMarker — a skipAfter jump target."""

    name: str
    line: int = 0


@dataclass
class RuleSetProgram:
    """A parsed Seclang program: ordered rules/markers + engine configuration.

    Mirrors what coraza builds from ``WithDirectives``: the configuration
    directives land in typed fields / the ``config`` dict, rules keep source
    order (required for first-match-wins and skipAfter semantics).
    """

    elements: list[Rule | Marker] = field(default_factory=list)
    engine_mode: str = "On"  # On | Off | DetectionOnly
    request_body_access: bool = False
    response_body_access: bool = False
    request_body_limit: int = 134217728
    request_body_in_memory_limit: int = 131072
    request_body_limit_action: str = "Reject"
    response_body_limit: int = 524288
    default_actions: dict[int, list[Action]] = field(default_factory=dict)
    config: dict[str, str] = field(default_factory=dict)
    removed_id_ranges: list[tuple[int, int]] = field(default_factory=list)
    removed_tags: list[str] = field(default_factory=list)
    # SecRuleUpdateTargetById: (id_lo, id_hi, [Variable...]) — targets
    # (typically exclusions) appended to matching rules before lowering.
    update_targets: list[tuple[int, int, list]] = field(default_factory=list)

    def is_removed(self, rule: "Rule") -> bool:
        rid = rule.id
        if rid is not None and any(lo <= rid <= hi for lo, hi in self.removed_id_ranges):
            return True
        if self.removed_tags:
            tags = set(rule.tags)
            if any(t in tags for t in self.removed_tags):
                return True
        return False

    @property
    def rules(self) -> list[Rule]:
        return [e for e in self.elements if isinstance(e, Rule)]

    def rule_by_id(self, rule_id: int) -> Rule | None:
        for r in self.rules:
            if r.id == rule_id:
                return r
        return None

    @property
    def rule_ids(self) -> list[int]:
        return [r.id for r in self.rules if r.id is not None]
