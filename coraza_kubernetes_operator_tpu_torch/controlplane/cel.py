"""Mini-CEL: evaluator for the CRD ``x-kubernetes-validations`` subset.

Without an evaluator, the CRD YAML's CEL rules would be decorative, and
the tested validation path a parallel Python ``validate()`` that could
silently diverge. This module makes the YAML the source of truth: ``crdschema.py`` loads the CRD and
evaluates both the structural OpenAPI constraints and these CEL rules
against object documents, exactly where a real kube-apiserver would.

Supported grammar (the subset Kubernetes CRD validation rules actually
use, cf. reference ``api/v1alpha1/engine_driver_types.go:27`` /
``engine_driver_istio_types.go:32,47``):

- literals: int, string (single/double quoted), bool, null, list ``[...]``
- identifiers and field selection ``self.driver.istio.mode``
- ``has(expr)`` — field presence
- calls/methods: ``size()``, ``matches(re)``, ``startsWith/endsWith/
  contains``, ``filter(var, pred)``, ``exists(var, pred)``,
  ``all(var, pred)``, ``map(var, expr)``
- operators: ``! - || && == != < <= > >= + in`` and ``?:``

Evaluation is over plain Python dict/list/scalar documents; absent fields
raise ``CelAbsentField`` which ``has()`` catches (CEL's partial-value
semantics for our subset).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class CelError(ValueError):
    """Parse or evaluation failure."""


class CelAbsentField(CelError):
    """Field access on an absent path (caught by has())."""


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<num>\d+)
      | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
      | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<op>&&|\|\||[=!<>]=|[-+*/%()\[\].,:?<>!])
    )""",
    re.VERBOSE,
)


def _lex(src: str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            if src[pos:].strip() == "":
                break
            raise CelError(f"cel: bad token at {src[pos:pos+10]!r}")
        pos = m.end()
        for kind in ("num", "str", "ident", "op"):
            val = m.group(kind)
            if val is not None:
                out.append((kind, val))
                break
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------------------
# Parser (precedence climbing) → tuple AST
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def eat_op(self, op: str) -> bool:
        if self.peek() == ("op", op):
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise CelError(f"cel: expected {op!r}, got {self.peek()[1]!r}")

    # ternary > or > and > equality > relational > additive > unary > postfix
    def expr(self):
        cond = self.or_()
        if self.eat_op("?"):
            then = self.expr()
            self.expect_op(":")
            other = self.expr()
            return ("cond", cond, then, other)
        return cond

    def or_(self):
        left = self.and_()
        while self.eat_op("||"):
            left = ("or", left, self.and_())
        return left

    def and_(self):
        left = self.equality()
        while self.eat_op("&&"):
            left = ("and", left, self.equality())
        return left

    def equality(self):
        left = self.relational()
        while True:
            if self.eat_op("=="):
                left = ("eq", left, self.relational())
            elif self.eat_op("!="):
                left = ("ne", left, self.relational())
            elif self.peek() == ("ident", "in"):
                self.next()
                left = ("in", left, self.relational())
            else:
                return left

    def relational(self):
        left = self.additive()
        for op, tag in (("<=", "le"), (">=", "ge"), ("<", "lt"), (">", "gt")):
            if self.eat_op(op):
                return (tag, left, self.additive())
        return left

    def additive(self):
        left = self.unary()
        while True:
            if self.eat_op("+"):
                left = ("add", left, self.unary())
            elif self.eat_op("-"):
                left = ("sub", left, self.unary())
            else:
                return left

    def unary(self):
        if self.eat_op("!"):
            return ("not", self.unary())
        if self.eat_op("-"):
            return ("neg", self.unary())
        return self.postfix()

    def postfix(self):
        node = self.primary()
        while True:
            if self.eat_op("."):
                kind, name = self.next()
                if kind != "ident":
                    raise CelError("cel: expected field/method name after '.'")
                if self.eat_op("("):
                    args = self.call_args()
                    node = ("method", node, name, args)
                else:
                    node = ("select", node, name)
            elif self.eat_op("["):
                idx = self.expr()
                self.expect_op("]")
                node = ("index", node, idx)
            else:
                return node

    def call_args(self) -> list:
        args = []
        if not self.eat_op(")"):
            args.append(self.expr())
            while self.eat_op(","):
                args.append(self.expr())
            self.expect_op(")")
        return args

    def primary(self):
        kind, val = self.next()
        if kind == "num":
            return ("lit", int(val))
        if kind == "str":
            body = val[1:-1]
            body = re.sub(r"\\(.)", r"\1", body)
            return ("lit", body)
        if kind == "ident":
            if val == "true":
                return ("lit", True)
            if val == "false":
                return ("lit", False)
            if val == "null":
                return ("lit", None)
            if self.eat_op("("):
                return ("call", val, self.call_args())
            return ("var", val)
        if (kind, val) == ("op", "("):
            node = self.expr()
            self.expect_op(")")
            return node
        if (kind, val) == ("op", "["):
            items = []
            if not self.eat_op("]"):
                items.append(self.expr())
                while self.eat_op(","):
                    items.append(self.expr())
                self.expect_op("]")
            return ("list", items)
        raise CelError(f"cel: unexpected token {val!r}")


def parse(src: str):
    p = _Parser(_lex(src))
    node = p.expr()
    if p.peek()[0] != "eof":
        raise CelError(f"cel: trailing tokens at {p.peek()[1]!r}")
    return node


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

_ABSENT = object()


def _get_field(obj, name: str):
    if isinstance(obj, dict):
        if name in obj and obj[name] is not None:
            return obj[name]
        raise CelAbsentField(name)
    raise CelError(f"cel: field {name!r} on non-object {type(obj).__name__}")


def _size(v) -> int:
    if isinstance(v, (list, dict, str)):
        return len(v)
    raise CelError(f"cel: size() on {type(v).__name__}")


@dataclass
class Program:
    """Compiled CEL rule."""

    src: str
    ast: tuple

    def evaluate(self, self_value, variables: dict | None = None):
        env = {"self": self_value}
        if variables:
            env.update(variables)
        return _eval(self.ast, env)


def compile_rule(src: str) -> Program:
    return Program(src=src, ast=parse(src))


def _eval(node, env: dict):
    tag = node[0]
    if tag == "lit":
        return node[1]
    if tag == "var":
        if node[1] in env:
            return env[node[1]]
        raise CelError(f"cel: unknown variable {node[1]!r}")
    if tag == "list":
        return [_eval(item, env) for item in node[1]]
    if tag == "select":
        return _get_field(_eval(node[1], env), node[2])
    if tag == "index":
        base = _eval(node[1], env)
        idx = _eval(node[2], env)
        try:
            return base[idx]
        except (KeyError, IndexError, TypeError) as err:
            raise CelAbsentField(str(idx)) from err
    if tag == "cond":
        return _eval(node[2] if _eval(node[1], env) else node[3], env)
    if tag == "or":
        return bool(_eval(node[1], env)) or bool(_eval(node[2], env))
    if tag == "and":
        return bool(_eval(node[1], env)) and bool(_eval(node[2], env))
    if tag == "not":
        return not _eval(node[1], env)
    if tag == "neg":
        return -_eval(node[1], env)
    if tag in ("eq", "ne", "lt", "le", "gt", "ge", "add", "sub", "in"):
        left = _eval(node[1], env)
        right = _eval(node[2], env)
        if tag == "eq":
            return left == right
        if tag == "ne":
            return left != right
        if tag == "lt":
            return left < right
        if tag == "le":
            return left <= right
        if tag == "gt":
            return left > right
        if tag == "ge":
            return left >= right
        if tag == "add":
            return left + right
        if tag == "sub":
            return left - right
        return left in right
    if tag == "call":
        name, args = node[1], node[2]
        if name == "has":
            if len(args) != 1:
                raise CelError("cel: has() takes one argument")
            try:
                _eval(args[0], env)
                return True
            except CelAbsentField:
                return False
        if name == "size":
            return _size(_eval(args[0], env))
        if name == "string":
            return str(_eval(args[0], env))
        if name == "int":
            return int(_eval(args[0], env))
        raise CelError(f"cel: unknown function {name!r}")
    if tag == "method":
        recv = node[1]
        name = node[2]
        args = node[3]
        if name in ("filter", "exists", "all", "map"):
            coll = _eval(recv, env)
            if not isinstance(coll, list):
                raise CelError(f"cel: {name}() on non-list")
            var_node = args[0]
            if var_node[0] != "var":
                raise CelError(f"cel: {name}() first arg must be a variable")
            var = var_node[1]
            body = args[1]
            results = []
            for item in coll:
                sub = dict(env)
                sub[var] = item
                results.append(_eval(body, sub))
            if name == "filter":
                return [item for item, keep in zip(coll, results) if keep]
            if name == "exists":
                return any(results)
            if name == "all":
                return all(results)
            return results
        value = _eval(recv, env)
        if name == "size":
            return _size(value)
        if name == "matches":
            return re.search(_eval(args[0], env), value) is not None
        if name == "startsWith":
            return str(value).startswith(_eval(args[0], env))
        if name == "endsWith":
            return str(value).endswith(_eval(args[0], env))
        if name == "contains":
            return _eval(args[0], env) in str(value)
        if name == "lowerAscii":
            return str(value).lower()
        raise CelError(f"cel: unknown method {name!r}")
    raise CelError(f"cel: unhandled node {tag!r}")
