"""The plain reference: a rule-by-rule Seclang evaluator in Python.

It reads the ruleset text itself (``seclang_parser`` is a frozen copy of
the port's parser), builds each request's variables, applies each rule's
transformations (``transforms``, a frozen copy), matches each operator with
Python's ``re``, plain string operations, ``sqli``/``xss`` (frozen copies)
or ``ipaddress``, and decides the verdict the way the engine's rule model
documents it (``docs/RULE_MODEL.md`` in spirit; ``engine/host_fallback.py``
is its NumPy mirror in the port):

- every rule is evaluated on the request, independent of the others; a
  chain matches when every link matches; a string link matches when any of
  its targets matches (or, negated, fails to match);
- TX values set by unconditional ``SecAction``s and by constant rules
  (paranoia gates) are constants; a constant rule that matches may
  ``skipAfter`` to its marker, and the skipped rules do not exist;
- anomaly counters are the constants' base plus the increments of every
  matched rule; rules comparing a counter are decided after the sum (twice,
  when such a rule increments a counter itself);
- ``ctl:ruleRemoveById`` of a matched rule removes the later rules it names;
- the verdict is the first matched rule, in (phase, order), that carries a
  decision (deny, drop, redirect or allow) in the phases evaluated;
- a body over ``SecRequestBodyLimit`` under ``Reject`` is answered 413 by the
  phase-1 evaluation of the headers alone, unless that interrupts itself.

It imports nothing of the program and takes nothing the program built.
"""

from __future__ import annotations

import ipaddress
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from .seclang_ast import Marker, Rule
from .seclang_parser import parse
from .sqli import is_sqli
from .transforms import apply_pipeline, t_urldecode
from .xss import is_xss

NUMERIC_OPS = {"eq", "ne", "ge", "gt", "le", "lt"}
DECISIONS = {"deny": "deny", "drop": "drop", "redirect": "redirect", "allow": "allow"}
INTERRUPTING = {"deny", "drop", "redirect"}
_MACRO = re.compile(r"%\{([^}]+)\}")


@dataclass(frozen=True)
class Request:
    """One request as the sidecar receives it."""

    method: str
    uri: str
    headers: tuple  # ((name, value), ...), names as sent
    body: bytes = b""
    version: str = "HTTP/1.1"
    remote_addr: str = "127.0.0.1"

    def header(self, name: str):
        name = name.lower()
        return next((v for k, v in self.headers if k.lower() == name), None)


@dataclass
class Verdict:
    interrupted: bool
    status: int
    rule_id: int | None
    matched_ids: list = field(default_factory=list)
    scores: dict = field(default_factory=dict)

    def key(self) -> tuple:
        return (self.interrupted, self.status, self.rule_id, tuple(sorted(self.matched_ids)),
                tuple(sorted(self.scores.items())))


# -- request variables -----------------------------------------------------


def _pairs(raw: str) -> list:
    out = []
    for item in raw.split("&"):
        if item:
            k, _, v = item.partition("=")
            out.append((t_urldecode(k.encode("latin-1", "replace")),
                        t_urldecode(v.encode("latin-1", "replace"))))
    return out


def _flatten_json(obj, prefix: str, out: list) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten_json(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _flatten_json(v, f"{prefix}.{i}" if prefix else str(i), out)
    else:
        val = (b"true" if obj else b"false") if isinstance(obj, bool) else (
            b"" if obj is None else str(obj).encode("utf-8", "replace"))
        out.append((prefix.encode("utf-8", "replace"), val))


_BOUNDARY_CANDIDATE = re.compile(rb"--[0-9A-Za-z'()+_,\-./:=?]{1,72}")


def _multipart(content_type: str, body: bytes):
    """(args, files as (field, filename, size), strict error, unmatched boundary)."""
    m = re.search(r'boundary="?([^";,]{1,256})"?', content_type, re.I)
    if not m:
        return [], [], 1, 0
    delim = b"--" + m.group(1).encode("latin-1", "replace")
    args, files, strict, unmatched = [], [], 0, 0
    segments = body.split(delim)
    if len(segments) < 2 or not body.rstrip(b"\r\n ").endswith(delim + b"--"):
        strict = 1
    for seg in segments[1:]:
        if seg.startswith(b"--"):
            break
        if not seg.startswith((b"\r\n", b"\n")):
            strict = 1
            continue
        part = seg.lstrip(b"\r\n")
        head, sep, content = part.partition(b"\r\n\r\n")
        if not sep:
            head, sep, content = part.partition(b"\n\n")
            if not sep:
                strict = 1
                continue
        content = content[:-2] if content.endswith(b"\r\n") else content.rstrip(b"\n")
        hm = re.search(rb"content-disposition\s*:\s*form-data\s*;([^\r\n]*)", head, re.I)
        if not hm:
            strict = 1
            continue
        nm = re.search(rb'name="([^"]*)"', hm.group(1))
        fm = re.search(rb'filename="([^"]*)"', hm.group(1))
        if not nm:
            strict = 1
        name = nm.group(1) if nm else b""
        if fm is not None:
            files.append((name.decode("latin-1", "replace"), fm.group(1), len(content)))
        else:
            args.append((name, content))
    for line in body.split(b"\n"):
        line = line.strip(b"\r")
        if (len(line) > 4 and _BOUNDARY_CANDIDATE.fullmatch(line)
                and re.search(rb"[0-9A-Za-z]", line[2:]) and not line.startswith(delim)):
            unmatched = 1
            break
    return args, files, strict, unmatched


class Variables:
    """A request's collections ({name: [(key, value bytes)]}) and numbers."""

    def __init__(self, req: Request, body_access: bool, body_limit: int, headers_only: bool):
        body = b"" if headers_only else req.body[:body_limit]
        path, _, query = req.uri.partition("?")
        args_get = _pairs(query)
        args_post, files = [], []
        strict = unmatched = reqbody_error = 0
        processor = ""
        if body_access and body:
            ctype = (req.header("content-type") or "").lower()
            if "json" in ctype:
                processor = "JSON"
                try:
                    _flatten_json(json.loads(body.decode("utf-8", "replace")), "json", args_post)
                except (ValueError, RecursionError):
                    reqbody_error = 1
            elif "multipart/form-data" in ctype:
                processor = "MULTIPART"
                args_post, files, strict, unmatched = _multipart(req.header("content-type") or "", body)
                reqbody_error = strict
            elif "x-www-form-urlencoded" in ctype or not ctype:
                processor = "URLENCODED"
                args_post = _pairs(body.decode("latin-1", "replace"))
        c: dict[str, list] = {}

        def add(coll, key, value):
            c.setdefault(coll, []).append((key, value))

        for src, pairs in (("GET", args_get), ("POST", args_post)):
            for k, v in pairs:
                kn = k.decode("latin-1", "replace")
                add("ARGS", kn, v)
                add(f"ARGS_{src}", kn, v)
                add("ARGS_NAMES", kn, k)
                add(f"ARGS_{src}_NAMES", kn, k)
        for fld, filename, _size in files:
            add("FILES", fld, filename)
            add("FILES_NAMES", fld, fld.encode("latin-1", "replace"))
        for k, v in req.headers:
            add("REQUEST_HEADERS", k, v.encode("latin-1", "replace"))
            add("REQUEST_HEADERS_NAMES", k, k.encode("latin-1", "replace"))
        cookie = req.header("cookie")
        if cookie:
            for part in cookie.split(";"):
                name, _, value = part.strip().partition("=")
                add("REQUEST_COOKIES", name, value.encode("latin-1", "replace"))
                add("REQUEST_COOKIES_NAMES", name, name.encode("latin-1", "replace"))
        request_line = f"{req.method} {req.uri} {req.version}"
        full = (request_line + "\r\n" + "".join(f"{k}: {v}\r\n" for k, v in req.headers)
                + "\r\n").encode("latin-1", "replace") + body
        enc = lambda s: s.encode("latin-1", "replace")  # noqa: E731
        self.scalars = {
            "REQUEST_URI": enc(req.uri), "REQUEST_URI_RAW": enc(req.uri),
            "REQUEST_FILENAME": enc(path), "REQUEST_BASENAME": enc(path.rsplit("/", 1)[-1]),
            "REQUEST_LINE": enc(request_line), "REQUEST_METHOD": enc(req.method),
            "REQUEST_PROTOCOL": enc(req.version), "QUERY_STRING": enc(query),
            "REQUEST_BODY": body if body_access else b"", "FULL_REQUEST": full,
            "PATH_INFO": b"", "REMOTE_ADDR": enc(req.remote_addr),
            "SERVER_NAME": enc(req.header("host") or ""), "STATUS_LINE": b"",
            "RESPONSE_BODY": b"", "AUTH_TYPE": b"", "REQBODY_PROCESSOR": processor.encode(),
        }
        self.numbers = {
            "REQUEST_BODY_LENGTH": len(body), "REQBODY_ERROR": reqbody_error,
            "MULTIPART_STRICT_ERROR": strict, "MULTIPART_UNMATCHED_BOUNDARY": unmatched,
            "ARGS_COMBINED_SIZE": sum(len(k) + len(v) for k, v in args_get + args_post),
            "FULL_REQUEST_LENGTH": len(full), "FILES_COMBINED_SIZE": sum(s for _, _, s in files),
            "RESPONSE_STATUS": 0, "DURATION": 0,
        }
        self.collections = c

    def _selects(self, var, key: str) -> bool:
        if var.selector is None:
            return True
        if var.selector_is_regex:
            return re.search(var.selector.encode("latin-1"), key.encode("latin-1", "replace"),
                             re.I) is not None
        return key.lower() == var.selector.lower()

    def targets(self, variables) -> list:
        """The values a link's variable list selects, exclusions applied: a
        target is one (collection, key) entry; excluded when any exclusion
        names its collection and selects its key."""
        out = []
        includes = [v for v in variables if not v.exclude]
        excludes = [v for v in variables if v.exclude]
        for var in includes:
            if var.name in self.scalars:
                out.append((var.name, None, self.scalars[var.name]))
            elif var.name in self.numbers:
                out.append((var.name, None, str(self.numbers[var.name]).encode()))
            else:
                for key, value in self.collections.get(var.name, ()):
                    if self._selects(var, key):
                        out.append((var.name, key, value))
        if excludes:
            out = [t for t in out if not any(
                x.name == t[0] and t[1] is not None and self._selects(x, t[1]) for x in excludes)]
        return out

    def number(self, var) -> int:
        if var.count:
            return sum(1 for key, _ in self.collections.get(var.name, ())
                       if self._selects(var, key))
        return self.numbers[var.name]


# -- operators --------------------------------------------------------------


def _translate_rx(pattern: str) -> bytes:
    """A PCRE pattern in Python's ``re`` syntax (bytes)."""
    p = pattern.replace(r"\z", r"\Z")
    if "(?i)" in p and not p.startswith("(?i)"):
        p = "(?i)" + p.replace("(?i)", "")
    return p.encode("latin-1")


class StringOp:
    """One string operator over transformed bytes."""

    def __init__(self, name: str, arg: str, data_dir: str):
        self.name = name
        raw = arg.encode("latin-1", "replace")
        if name == "rx":
            self.rx = re.compile(_translate_rx(arg))
        elif name in ("pm", "pmf", "pmfromfile"):
            words = arg.split() if name == "pm" else _data_lines(arg, data_dir)
            self.words = [w.lower().encode("latin-1", "replace") if isinstance(w, str) else w.lower()
                          for w in words if w]
        elif name in ("ipmatch", "ipmatchfromfile"):
            entries = (_data_lines(arg, data_dir) if name == "ipmatchfromfile"
                       else [e for e in arg.split(",") if e.strip()])
            self.nets = [ipaddress.ip_network(
                e.decode() if isinstance(e, bytes) else e.strip(), strict=False) for e in entries]
        elif name == "containsword":
            self.rx = re.compile(rb"\b" + re.escape(raw) + rb"\b")
        elif name == "validatebyterange":
            allowed = set()
            for part in arg.split(","):
                lo, sep, hi = part.strip().partition("-")
                if lo:
                    allowed.update(range(int(lo), int(hi if sep else lo) + 1))
            self.bad = bytes(b for b in range(256) if b not in allowed)
        self.raw = raw

    def __call__(self, value: bytes) -> bool:
        n = self.name
        if n == "rx":
            return self.rx.search(value) is not None
        if n in ("contains", "strmatch"):
            return self.raw in value
        if n == "streq":
            return value == self.raw
        if n == "beginswith":
            return value.startswith(self.raw)
        if n == "endswith":
            return value.endswith(self.raw)
        if n == "within":
            return value in self.raw
        if n == "containsword":
            return self.rx.search(value) is not None
        if n in ("pm", "pmf", "pmfromfile"):
            low = value.lower()
            return any(w in low for w in self.words)
        if n in ("ipmatch", "ipmatchfromfile"):
            try:
                addr = ipaddress.ip_address(value.decode("ascii"))
            except ValueError:
                return False
            return any(addr in net for net in self.nets)
        if n == "detectsqli":
            return is_sqli(value)[0]
        if n == "detectxss":
            return bool(is_xss(value))
        if n == "validateurlencoding":
            return _bad_urlencoding(value)
        if n == "validateutf8encoding":
            try:
                value.decode("utf-8")
            except UnicodeDecodeError:
                return True
            return False
        if n == "validatebyterange":
            return any(b in self.bad for b in value)
        raise ValueError(f"@{n} has no reference implementation")


def _bad_urlencoding(value: bytes) -> bool:
    i = 0
    while True:
        i = value.find(b"%", i)
        if i < 0:
            return False
        pair = value[i + 1:i + 3]
        if len(pair) < 2 or not all(chr(c) in "0123456789abcdefABCDEF" for c in pair):
            return True
        i += 1


def _data_lines(arg: str, data_dir: str) -> list:
    words = []
    for name in arg.split():
        path = Path(name) if Path(name).is_absolute() else Path(data_dir) / name
        for line in path.read_bytes().splitlines():
            line = line.split(b"#", 1)[0].strip()
            if line:
                words.append(line)
    return words


def _compare(op: str, left: int, right: int) -> bool:
    return {"eq": left == right, "ne": left != right, "ge": left >= right,
            "gt": left > right, "le": left <= right, "lt": left < right}[op]


# -- rules ------------------------------------------------------------------


def _setvar(sv: str):
    sv = sv.strip().strip("'\"")
    if sv.startswith("!"):
        return None
    name, sep, value = sv.partition("=")
    if not sep:
        name, value = sv, "1"
    name, value, op = name.strip().lower(), value.strip(), "="
    if value[:1] in "+-" and value:
        op, value = value[0] + "=", value[1:]
    return name, op, value


def _expand(arg: str, env: dict) -> str | None:
    try:
        return _MACRO.sub(lambda m: str(env[m.group(1).lower()]), arg)
    except KeyError:
        return None


@dataclass
class Link:
    kind: str  # "string" | "number" | "counter" | "always" | "never"
    negated: bool
    variables: list
    pipeline: tuple = ()
    op: object = None
    cmp: str = ""
    arg: int = 0
    counter: str = ""


@dataclass
class RefRule:
    rule_id: int
    phase: int
    order: int
    decision: str | None
    status: int
    links: list
    increments: dict  # counter -> delta
    removes: list  # (lo, hi) id ranges


class Reference:
    """Evaluate requests against one ruleset text."""

    def __init__(self, text: str, tx: dict | None = None, engine: str | None = None):
        """``tx`` overrides TX constants and ``engine`` the ``SecRuleEngine``
        mode: only the check's controls use them."""
        prog = parse(text)
        overrides = tx
        self.body_access = prog.request_body_access
        self.body_limit = prog.request_body_limit
        self.reject = prog.request_body_limit_action == "Reject"
        self.engine_on = (engine or prog.engine_mode) == "On"
        self.body_cap = max(32, prog.request_body_limit)
        data_dir = prog.config.get("secdatadir", "")
        defaults = prog.default_actions
        runtime = set()
        for r in prog.rules:
            if r.operator is not None:
                for sv in r.setvars:
                    p = _setvar(sv)
                    if p and p[0].startswith("tx."):
                        runtime.add(p[0][3:])
        env: dict = {}
        self.rules: list[RefRule] = []
        self.counters: list[str] = []
        pending: list = []
        skip_to = None
        seq = 0
        for el in prog.elements:
            if isinstance(el, Marker):
                if skip_to == el.name:
                    skip_to = None
                continue
            if skip_to is not None or prog.is_removed(el):
                continue
            rule: Rule = el
            if rule.operator is None:
                self._setvars(rule, env, overrides)
                skip_to = rule.skip_after or skip_to
                if self._decision(rule, defaults)[0] in INTERRUPTING:
                    pending.append((rule, [Link("always", False, [])], seq))
                    seq += 1
                continue
            const = self._constant(rule, env, runtime)
            if const is not None:
                if const:
                    self._setvars(rule, env, overrides)
                    skip_to = rule.skip_after or skip_to
                    if self._decision(rule, defaults)[0] in ("deny", "drop"):
                        pending.append((rule, [Link("always", False, [])], seq))
                        seq += 1
                continue
            phase_defaults = defaults.get(rule.phase or 2, [])
            links = [self._link(l, phase_defaults, env, runtime, data_dir) for l in rule.all_rules()]
            pending.append((rule, links, seq))
            seq += 1
        self.env = env
        for rule, links, order in pending:
            decision, status = self._decision(rule, defaults)
            incs: dict = {}
            for sv in rule.setvars:
                p = _setvar(sv)
                if not p or not p[0].startswith("tx.") or p[0][3:] not in self.counters:
                    continue
                value = _expand(p[2], env)
                if value is None or not value.lstrip("-").isdigit():
                    continue
                incs[p[0][3:]] = incs.get(p[0][3:], 0) + (-1 if p[1] == "-=" else 1) * int(value)
            removes = []
            for a in list(rule.actions) + [a for sub in rule.chain for a in sub.actions]:
                if a.name == "ctl" and a.argument:
                    key, _, val = a.argument.partition("=")
                    if key.strip().lower() == "ruleremovebyid":
                        lo, _, hi = val.strip().partition("-")
                        removes.append((int(lo), int(hi or lo)))
            self.rules.append(RefRule(rule.id or 0, rule.phase or 2, (rule.phase or 2) * 1_000_000 + order,
                                      decision, status, links, incs, removes))
        self.base = {c: int(env.get(f"tx.{c}", "0")) for c in self.counters}
        self.two_pass = any(r.increments and any(l.kind == "counter" for l in r.links) for r in self.rules)

    # -- construction helpers

    @staticmethod
    def _setvars(rule: Rule, env: dict, overrides: dict | None) -> None:
        for sv in rule.setvars:
            p = _setvar(sv)
            if not p or not p[0].startswith("tx."):
                continue
            value = _expand(p[2], env)
            if value is None:
                continue
            if p[1] == "=":
                env[p[0]] = value
            else:
                cur = int(env.get(p[0], "0"))
                env[p[0]] = str(cur + int(value) if p[1] == "+=" else cur - int(value))
            if overrides and p[0] in overrides:
                env[p[0]] = str(overrides[p[0]])

    @staticmethod
    def _constant(rule: Rule, env: dict, runtime: set) -> bool | None:
        for link in rule.all_rules():
            op = link.operator
            if op.name not in NUMERIC_OPS | {"streq", "unconditionalmatch", "nomatch"}:
                return None
            result = None
            for var in link.variables:
                sel = (var.selector or "").lower()
                if var.name != "TX" or sel in runtime:
                    return None
                raw = env.get(f"tx.{sel}")
                val = (1 if raw is not None else 0) if var.count else (raw if raw is not None else "0")
                arg = _expand(op.argument, env)
                if arg is None:
                    return None
                if op.name == "streq":
                    m = str(val) == arg
                elif op.name in NUMERIC_OPS:
                    try:
                        m = _compare(op.name, int(val), int(arg))
                    except ValueError:
                        return None
                else:
                    m = False
                m = m != op.negated
                result = m if result is None else (result or m)
            if op.name == "unconditionalmatch":
                result = not op.negated
            if op.name == "nomatch":
                result = op.negated
            if not result:
                return False
        return True

    @staticmethod
    def _decision(rule: Rule, defaults: dict):
        phase_defaults = defaults.get(rule.phase or 2, [])
        disruptive, status = rule.disruptive, rule.status
        if disruptive in (None, "block"):
            disruptive = next((a.name for a in phase_defaults
                               if a.name in ("deny", "drop", "allow", "redirect", "pass")), "pass")
            status = status or next((int(a.argument) for a in phase_defaults
                                     if a.name == "status" and a.argument), None)
        decision = DECISIONS.get(disruptive)
        if decision in ("deny", "drop"):
            return decision, status or 403
        if decision == "redirect":
            return decision, status or 302
        return decision, 0

    def _link(self, link: Rule, phase_defaults, env, runtime, data_dir) -> Link:
        op = link.operator
        names = [a.argument.lower() for a in phase_defaults if a.name == "t" and a.argument]
        for t in link.transformations:
            names = [] if t == "none" else names + [t]
        if op.name == "unconditionalmatch":
            return Link("always", op.negated, [])
        if op.name == "nomatch":
            return Link("never", op.negated, [])
        if op.name in NUMERIC_OPS:
            var = link.variables[0]
            arg = op.argument.strip()
            m = _MACRO.fullmatch(arg)
            if m and m.group(1).lower() in env and m.group(1).lower()[3:] not in runtime:
                arg = env[m.group(1).lower()]
            if var.name == "TX":
                name = (var.selector or "").lower()
                if name not in self.counters:
                    self.counters.append(name)
                return Link("counter", op.negated, [], cmp=op.name, arg=int(arg), counter=name)
            return Link("number", op.negated, [var], cmp=op.name, arg=int(arg))
        arg = _expand(op.argument, env)
        return Link("string", op.negated, [v for v in link.variables if v.name != "TX"],
                    pipeline=tuple(names), op=StringOp(op.name, arg, data_dir))

    # -- evaluation

    def evaluate(self, req: Request) -> Verdict:
        if self.body_access and self.reject and len(req.body) > self.body_limit:
            early = self._evaluate(req, headers_only=True, max_phase=1)
            return early if early.interrupted else Verdict(True, 413, None)
        return self._evaluate(req, headers_only=False, max_phase=2)

    def _evaluate(self, req: Request, headers_only: bool, max_phase: int) -> Verdict:
        variables = Variables(req, self.body_access, self.body_limit, headers_only)
        memo: dict = {}
        pre = [self._plain_match(r, variables, memo) for r in self.rules]
        removed = self._removed(pre)
        prelim = [m is True and not x for m, x in zip(pre, removed)]
        counters = self._sum(prelim)
        matched = self._with_counters(pre, removed, counters)
        if self.two_pass:
            extra = [m and not p for m, p in zip(matched, prelim)]
            for r, e in zip(self.rules, extra):
                if e:
                    for c, d in r.increments.items():
                        counters[c] += d
            matched = self._with_counters(pre, removed, counters)
        first = None
        for r, m in zip(self.rules, matched):
            if m and r.decision and r.phase <= max_phase and (first is None or r.order < first.order):
                first = r
        interrupted = first is not None and first.decision in INTERRUPTING and self.engine_on
        return Verdict(
            interrupted=interrupted,
            status=first.status if interrupted else 200,
            rule_id=first.rule_id if first is not None else None,
            matched_ids=[r.rule_id for r, m in zip(self.rules, matched) if m],
            scores=dict(counters),
        )

    def _plain_match(self, rule: RefRule, v: Variables, memo: dict):
        """True / False over the links that need no counter; None when the
        rule's non-counter links all match but a counter link decides."""
        waits = False
        for link in rule.links:
            if link.kind == "counter":
                waits = True
                continue
            if not self._link_match(link, v, memo):
                return False
        return None if waits else True

    def _link_match(self, link: Link, v: Variables, memo: dict) -> bool:
        if link.kind == "always":
            return not link.negated
        if link.kind == "never":
            return link.negated
        if link.kind == "number":
            return _compare(link.cmp, v.number(link.variables[0]), link.arg) != link.negated
        for _coll, _key, value in v.targets(link.variables):
            key = (value, link.pipeline)
            tv = memo.get(key)
            if tv is None:
                tv = memo[key] = apply_pipeline(value[: self.body_cap], list(link.pipeline))
            if link.op(tv) != link.negated:
                return True
        return False

    def _removed(self, pre) -> list:
        removed = [False] * len(self.rules)
        order = sorted(range(len(self.rules)), key=lambda i: self.rules[i].order)
        for i in order:
            r = self.rules[i]
            if r.removes and pre[i] is True and not removed[i]:
                for j, r2 in enumerate(self.rules):
                    if r2.order > r.order and any(lo <= r2.rule_id <= hi for lo, hi in r.removes):
                        removed[j] = True
        return removed

    def _sum(self, matched) -> dict:
        counters = dict(self.base)
        for r, m in zip(self.rules, matched):
            if m:
                for c, d in r.increments.items():
                    counters[c] += d
        return counters

    def _with_counters(self, pre, removed, counters) -> list:
        out = []
        for r, p, x in zip(self.rules, pre, removed):
            if x or p is False:
                out.append(False)
            elif p is True:
                out.append(True)
            else:
                out.append(all(_compare(l.cmp, counters[l.counter], l.arg) != l.negated
                               for l in r.links if l.kind == "counter"))
        return out
