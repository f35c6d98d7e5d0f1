"""RE2-subset regex parser.

The data plane only needs RE2 semantics: the reference corpus is explicitly
RE2-constrained because coraza-proxy-wasm runs under RE2 (reference
``hack/generate_coreruleset_configmaps.py:24-27`` — "does not support negative
lookahead"). Accordingly this parser rejects lookarounds and backreferences,
and supports: literals, escapes, char classes (incl. POSIX classes), ``.``,
alternation, groups (capturing / non-capturing / named / inline flags
``i``/``s``/``m``), repetition (``* + ? {n,m}``, greedy or lazy — equivalent
for boolean matching), anchors ``^ $ \\A \\z \\Z`` and word boundaries
``\\b \\B``.

Matching is byte-level (chars > 0xFF are rejected), case-insensitivity is
folded into char classes at parse time.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class RegexParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

# Char classes are 256-bit int bitmasks: bit b set ⇔ byte b matches.
ALL_BYTES = (1 << 256) - 1
NEWLINE = 1 << ord("\n")


def _mask_of(chars: bytes) -> int:
    m = 0
    for c in chars:
        m |= 1 << c
    return m


def _range_mask(lo: int, hi: int) -> int:
    return ((1 << (hi + 1)) - 1) & ~((1 << lo) - 1)


DIGIT = _range_mask(ord("0"), ord("9"))
UPPER = _range_mask(ord("A"), ord("Z"))
LOWER = _range_mask(ord("a"), ord("z"))
ALPHA = UPPER | LOWER
ALNUM = ALPHA | DIGIT
WORD = ALNUM | _mask_of(b"_")
SPACE = _mask_of(b" \t\n\r\f\v")
XDIGIT = DIGIT | _range_mask(ord("A"), ord("F")) | _range_mask(ord("a"), ord("f"))

POSIX_CLASSES = {
    "alpha": ALPHA,
    "digit": DIGIT,
    "alnum": ALNUM,
    "upper": UPPER,
    "lower": LOWER,
    "space": SPACE,
    "blank": _mask_of(b" \t"),
    "punct": _mask_of(bytes(range(33, 48)) + bytes(range(58, 65)) + bytes(range(91, 97)) + bytes(range(123, 127))),
    "cntrl": _range_mask(0, 31) | (1 << 127),
    "print": _range_mask(32, 126),
    "graph": _range_mask(33, 126),
    "xdigit": XDIGIT,
    "word": WORD,
    "ascii": _range_mask(0, 127),
}


def case_fold(mask: int) -> int:
    """Extend a byte-class mask so upper/lower ASCII pairs match together."""
    folded = mask
    for i in range(26):
        up, lo = ord("A") + i, ord("a") + i
        if mask >> up & 1 or mask >> lo & 1:
            folded |= (1 << up) | (1 << lo)
    return folded


@dataclass(frozen=True)
class RChar:
    """A single byte-class position."""

    mask: int


@dataclass(frozen=True)
class RAssert:
    """Zero-width assertion: kind ∈ {wordb, nwordb, start, end, line_start, line_end}."""

    kind: str


@dataclass
class RCat:
    items: list = field(default_factory=list)


@dataclass
class RAlt:
    items: list = field(default_factory=list)


@dataclass
class RRep:
    item: object = None
    min: int = 0
    max: int | None = None  # None = unbounded


@dataclass(frozen=True)
class REmpty:
    pass


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


@dataclass
class _Flags:
    i: bool = False  # case-insensitive
    s: bool = False  # dot matches newline
    m: bool = False  # multi-line anchors


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.n = len(pattern)

    def error(self, msg: str) -> RegexParseError:
        return RegexParseError(f"{msg} at offset {self.i} in {self.p!r}")

    def peek(self) -> str | None:
        return self.p[self.i] if self.i < self.n else None

    def next(self) -> str:
        if self.i >= self.n:
            raise self.error("unexpected end of pattern")
        c = self.p[self.i]
        self.i += 1
        return c

    def eat(self, c: str) -> bool:
        if self.peek() == c:
            self.i += 1
            return True
        return False

    # -- grammar ------------------------------------------------------------

    def alternation(self, flags: _Flags) -> object:
        branches = [self.concat(flags)]
        while self.eat("|"):
            branches.append(self.concat(flags))
        if len(branches) == 1:
            return branches[0]
        return RAlt(branches)

    def concat(self, flags: _Flags) -> object:
        items: list = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            items.append(self.repeat(flags))
        if not items:
            return REmpty()
        if len(items) == 1:
            return items[0]
        return RCat(items)

    def repeat(self, flags: _Flags) -> object:
        atom = self.atom(flags)
        while True:
            c = self.peek()
            if c == "*":
                self.i += 1
                atom = RRep(atom, 0, None)
            elif c == "+":
                self.i += 1
                atom = RRep(atom, 1, None)
            elif c == "?":
                self.i += 1
                atom = RRep(atom, 0, 1)
            elif c == "{":
                save = self.i
                rep = self._try_braces(atom)
                if rep is None:
                    self.i = save
                    break
                atom = rep
            else:
                break
            self.eat("?")  # lazy modifier — irrelevant for boolean match
            self.eat("+")  # possessive — RE2 rejects, but harmless to accept
        return atom

    def _try_braces(self, atom: object) -> RRep | None:
        """Parse {n}, {n,}, {n,m}; returns None if not a valid counted repeat
        (RE2 then treats '{' as a literal)."""
        assert self.next() == "{"
        start = self.i
        while self.peek() is not None and self.peek() in "0123456789,":
            self.i += 1
        if not self.eat("}"):
            return None
        body = self.p[start : self.i - 1]
        if not body or body == ",":
            return None
        lo_s, sep, hi_s = body.partition(",")
        if not lo_s.isdigit():
            return None
        lo = int(lo_s)
        if not sep:
            hi: int | None = lo
        elif hi_s == "":
            hi = None
        elif hi_s.isdigit():
            hi = int(hi_s)
        else:
            return None
        if hi is not None and hi < lo:
            raise self.error("repeat max < min")
        if lo > 1000 or (hi is not None and hi > 1000):
            raise self.error("repeat count too large")
        return RRep(atom, lo, hi)

    def atom(self, flags: _Flags) -> object:
        c = self.next()
        if c == "(":
            return self.group(flags)
        if c == "[":
            return RChar(self.char_class(flags))
        if c == ".":
            mask = ALL_BYTES if flags.s else (ALL_BYTES & ~NEWLINE)
            return RChar(mask)
        if c == "^":
            return RAssert("line_start" if flags.m else "start")
        if c == "$":
            return RAssert("line_end" if flags.m else "end")
        if c == "\\":
            return self.escape(flags)
        if c in "*+?":
            raise self.error(f"nothing to repeat with {c!r}")
        mask = 1 << ord(c) if ord(c) < 256 else None
        if mask is None:
            raise self.error(f"non-byte character {c!r}")
        return RChar(case_fold(mask) if flags.i else mask)

    def group(self, flags: _Flags) -> object:
        inner_flags = _Flags(flags.i, flags.s, flags.m)
        if self.eat("?"):
            c = self.next()
            if c == ":":
                pass  # non-capturing
            elif c == "P":
                if not self.eat("<"):
                    raise self.error("expected (?P<name>")
                while self.next() != ">":
                    pass
            elif c == "<":
                nxt = self.peek()
                if nxt in ("=", "!"):
                    raise self.error("lookbehind not supported (RE2 subset)")
                while self.next() != ">":
                    pass
            elif c in "ism-" or c.isalpha():
                # Inline flags: (?i), (?i:...), (?-i), (?si:...) etc.
                self.i -= 1
                on = True
                saw_colon = False
                while True:
                    f = self.next()
                    if f in (":", ")"):
                        saw_colon = f == ":"
                        break
                    if f == "-":
                        on = False
                    elif f in "ism":
                        setattr(inner_flags, f, on)
                    elif f != "U":  # U (ungreedy) is irrelevant here
                        raise self.error(f"unsupported flag {f!r}")
                if not saw_colon:
                    # (?flags) applies to the rest of the current group; RE2
                    # scopes it to the enclosing group. Approximate by
                    # mutating the caller's flags.
                    flags.i, flags.s, flags.m = inner_flags.i, inner_flags.s, inner_flags.m
                    return REmpty()
            else:
                if c in ("=", "!"):
                    raise self.error("lookahead not supported (RE2 subset)")
                raise self.error(f"unsupported group (?{c}")
        node = self.alternation(inner_flags)
        if not self.eat(")"):
            raise self.error("missing )")
        return node

    def escape(self, flags: _Flags) -> object:
        c = self.next()
        simple = {
            "n": b"\n", "r": b"\r", "t": b"\t", "f": b"\f", "v": b"\v",
            "a": b"\a", "e": b"\x1b",
        }
        if c in simple:
            return RChar(_mask_of(simple[c]))
        if c in "01234567":
            # RE2 octal escape: up to three octal digits (\0, \12, \123).
            mask = 1 << self._octal(c)
            return RChar(case_fold(mask) if flags.i else mask)
        if c == "d":
            return RChar(DIGIT)
        if c == "D":
            return RChar(ALL_BYTES & ~DIGIT)
        if c == "w":
            return RChar(WORD)
        if c == "W":
            return RChar(ALL_BYTES & ~WORD)
        if c == "s":
            return RChar(SPACE)
        if c == "S":
            return RChar(ALL_BYTES & ~SPACE)
        if c == "b":
            return RAssert("wordb")
        if c == "B":
            return RAssert("nwordb")
        if c == "A":
            return RAssert("start")
        if c in ("z", "Z"):
            return RAssert("end")
        if c == "x":
            val = self._hex_escape()
            if val > 0xFF:
                raise self.error("non-byte codepoint (matching is byte-level)")
            mask = 1 << val
            return RChar(case_fold(mask) if flags.i else mask)
        if c.isdigit():  # \8, \9 — not octal, and RE2 has no backreferences
            raise self.error("backreferences not supported (RE2 subset)")
        if c == "Q":
            # \Q...\E literal quoting
            items = []
            while True:
                ch = self.next()
                if ch == "\\" and self.peek() == "E":
                    self.i += 1
                    break
                m = 1 << ord(ch)
                items.append(RChar(case_fold(m) if flags.i else m))
            return RCat(items) if len(items) != 1 else items[0]
        if ord(c) < 256:
            m = 1 << ord(c)
            return RChar(case_fold(m) if flags.i else m)
        raise self.error(f"unsupported escape \\{c}")

    def _octal(self, first: str) -> int:
        digits = first
        while len(digits) < 3 and (self.peek() or "") in "01234567":
            digits += self.next()
        if first != "0" and len(digits) == 1:
            # RE2 parse.cc: a single non-zero digit is a backreference,
            # which RE2 (and therefore this engine) does not support —
            # compiling it as octal would silently change what the rule
            # matches, so fail loudly at compile time.
            raise self.error(f"backreference \\{digits} not supported (RE2 subset)")
        val = int(digits, 8)
        if val > 0xFF:
            raise self.error(f"octal escape \\{digits} out of byte range")
        return val

    def _hex_escape(self) -> int:
        """Value of a ``\\x``-escape body: two hex digits or ``{...}``."""
        if self.eat("{"):
            start = self.i
            while self.next() != "}":
                pass
            body = self.p[start : self.i - 1]
        else:
            body = self.next() + self.next()
        try:
            return int(body, 16)
        except ValueError:
            raise self.error(f"invalid hex escape \\x{body!r}") from None

    def char_class(self, flags: _Flags) -> int:
        negate = self.eat("^")
        mask = 0
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self.error("unterminated character class")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "[" and self.p.startswith("[:", self.i):
                end = self.p.find(":]", self.i)
                if end != -1:
                    name = self.p[self.i + 2 : end]
                    neg_posix = name.startswith("^")
                    if neg_posix:
                        name = name[1:]
                    if name in POSIX_CLASSES:
                        cls = POSIX_CLASSES[name]
                        mask |= (ALL_BYTES & ~cls) if neg_posix else cls
                        self.i = end + 2
                        continue
            lo_mask = self._class_atom(flags)
            if (
                lo_mask.bit_count() == 1
                and self.peek() == "-"
                and self.i + 1 < self.n
                and self.p[self.i + 1] != "]"
            ):
                self.i += 1
                hi_mask = self._class_atom(flags)
                if hi_mask.bit_count() != 1:
                    raise self.error("invalid range endpoint")
                lo = lo_mask.bit_length() - 1
                hi = hi_mask.bit_length() - 1
                if hi < lo:
                    raise self.error("invalid range (hi < lo)")
                mask |= _range_mask(lo, hi)
            else:
                mask |= lo_mask
        if flags.i:
            mask = case_fold(mask)
        if negate:
            mask = ALL_BYTES & ~mask
        if mask == 0:
            raise self.error("empty character class")
        return mask

    def _class_atom(self, flags: _Flags) -> int:
        """One class member's byte mask (single chars have one bit set;
        class escapes like \\d have many — those can't be range endpoints)."""
        c = self.next()
        if c == "\\":
            e = self.next()
            table = {
                "n": _mask_of(b"\n"), "r": _mask_of(b"\r"), "t": _mask_of(b"\t"),
                "f": _mask_of(b"\f"), "v": _mask_of(b"\v"),
                "a": _mask_of(b"\a"), "e": _mask_of(b"\x1b"), "b": _mask_of(b"\x08"),
            }
            if e in table:
                return table[e]
            if e in "01234567":
                return 1 << self._octal(e)
            if e == "d":
                return DIGIT
            if e == "D":
                return ALL_BYTES & ~DIGIT
            if e == "w":
                return WORD
            if e == "W":
                return ALL_BYTES & ~WORD
            if e == "s":
                return SPACE
            if e == "S":
                return ALL_BYTES & ~SPACE
            if e == "x":
                val = self._hex_escape()
                if val > 0xFF:
                    raise self.error("non-byte codepoint in class")
                return 1 << val
            if ord(e) < 256:
                return 1 << ord(e)
            raise self.error(f"unsupported class escape \\{e}")
        if ord(c) < 256:
            return 1 << ord(c)
        raise self.error(f"non-byte char {c!r} in class")


def parse_regex(pattern: str, case_insensitive: bool = False) -> object:
    """Parse ``pattern`` into a regex AST. ``case_insensitive`` pre-sets the
    ``i`` flag (used for operators that are case-insensitive by spec)."""
    parser = _Parser(pattern)
    flags = _Flags(i=case_insensitive)
    node = parser.alternation(flags)
    if parser.i != parser.n:
        raise parser.error(f"unexpected {parser.p[parser.i]!r}")
    return node
