"""Regex AST → position NFA with assertion-conditioned transitions.

Construction: Thompson epsilon-NFA whose epsilon edges carry zero-width
assertion labels (``\\b``, ``^``, ``$``...), collapsed by condition-
accumulating epsilon closure into a *position automaton*: states are the
char-class occurrences (Glushkov positions), and every transition / entry /
accept carries a DNF of assertion conjunctions evaluated over the
(previous byte, next byte) gap. This makes ``\\b`` and anchors exact under
determinization (``re_dfa``) — each gap's truth is fully determined by the
byte that entered the current DFA state plus the byte being consumed.

Conditions are evaluated byte-level: ``is_word = [A-Za-z0-9_]`` matching RE2
ASCII semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .re_parser import (
    RAlt,
    RAssert,
    RCat,
    RChar,
    REmpty,
    RRep,
    WORD,
)

# A conjunction of assertion kinds; a DNF is a frozenset of conjunctions.
# The DNF {frozenset()} (containing the empty conjunction) is "true";
# the empty DNF frozenset() is "false".
Conj = frozenset
DNF = frozenset

TRUE_DNF: DNF = frozenset({frozenset()})
FALSE_DNF: DNF = frozenset()

_CONTRADICTIONS = [
    {"wordb", "nwordb"},
]


def _conj_consistent(conj: Conj) -> bool:
    return not any(bad <= conj for bad in _CONTRADICTIONS)


def _dnf_or(a: DNF, b: DNF) -> DNF:
    merged = set(a) | set(b)
    # Absorption: drop conjunctions that are supersets of another.
    minimal = {c for c in merged if not any(o < c for o in merged)}
    return frozenset(minimal)


def is_word_byte(b: int | None) -> bool:
    return b is not None and bool(WORD >> b & 1)


def eval_conj(conj: Conj, prev: int | None, nxt: int | None) -> bool:
    """Evaluate an assertion conjunction at the gap between bytes ``prev``
    and ``nxt`` (either may be None at text edges)."""
    for kind in conj:
        if kind == "wordb":
            if is_word_byte(prev) == is_word_byte(nxt):
                return False
        elif kind == "nwordb":
            if is_word_byte(prev) != is_word_byte(nxt):
                return False
        elif kind == "start":
            if prev is not None:
                return False
        elif kind == "end":
            if nxt is not None:
                return False
        elif kind == "line_start":
            if prev is not None and prev != 0x0A:
                return False
        elif kind == "line_end":
            if nxt is not None and nxt != 0x0A:
                return False
        else:  # pragma: no cover
            raise AssertionError(f"unknown assertion {kind}")
    return True


def eval_dnf(dnf: DNF, prev: int | None, nxt: int | None) -> bool:
    return any(eval_conj(c, prev, nxt) for c in dnf)


@dataclass
class PositionNFA:
    """Char-position automaton with conditioned transitions."""

    classes: list[int] = field(default_factory=list)  # byte-class mask per position
    entries: dict[int, DNF] = field(default_factory=dict)
    edges: dict[int, dict[int, DNF]] = field(default_factory=dict)
    accepts: dict[int, DNF] = field(default_factory=dict)
    empty_dnf: DNF = FALSE_DNF  # conditions under which the empty string matches

    @property
    def n_positions(self) -> int:
        return len(self.classes)

    @property
    def always_matches(self) -> bool:
        return frozenset() in self.empty_dnf

    # -- reference simulator (test oracle plumbing / debugging) -------------

    def search(self, data: bytes) -> bool:
        """Unanchored boolean search, the semantics of Seclang ``@rx``."""
        for t in range(len(data) + 1):
            prev = data[t - 1] if t > 0 else None
            nxt = data[t] if t < len(data) else None
            if eval_dnf(self.empty_dnf, prev, nxt):
                return True
        active: set[int] = set()
        for t, c in enumerate(data):
            prev = data[t - 1] if t > 0 else None
            new: set[int] = set()
            for p, dnf in self.entries.items():
                if self.classes[p] >> c & 1 and eval_dnf(dnf, prev, c):
                    new.add(p)
            for p in active:
                for q, dnf in self.edges.get(p, {}).items():
                    if self.classes[q] >> c & 1 and eval_dnf(dnf, prev, c):
                        new.add(q)
            nxt = data[t + 1] if t + 1 < len(data) else None
            for p in new:
                dnf = self.accepts.get(p)
                if dnf and eval_dnf(dnf, c, nxt):
                    return True
            active = new
        return False


# ---------------------------------------------------------------------------
# Thompson construction
# ---------------------------------------------------------------------------


class _Builder:
    """Epsilon-NFA builder. States are ints; epsilon edges carry assertion
    labels; char edges consume one position."""

    def __init__(self) -> None:
        self.n_states = 0
        self.eps: dict[int, list[tuple[int, str | None]]] = {}
        # char_edges[state] = (position, target_state)
        self.char_edges: dict[int, tuple[int, int]] = {}
        self.classes: list[int] = []

    def state(self) -> int:
        s = self.n_states
        self.n_states += 1
        return s

    def add_eps(self, a: int, b: int, label: str | None = None) -> None:
        self.eps.setdefault(a, []).append((b, label))

    def add_char(self, a: int, b: int, mask: int) -> None:
        pos = len(self.classes)
        self.classes.append(mask)
        self.char_edges[a] = (pos, b)

    def build(self, node: object) -> tuple[int, int]:
        if isinstance(node, REmpty):
            s = self.state()
            return s, s
        if isinstance(node, RChar):
            s, e = self.state(), self.state()
            self.add_char(s, e, node.mask)
            return s, e
        if isinstance(node, RAssert):
            s, e = self.state(), self.state()
            self.add_eps(s, e, node.kind)
            return s, e
        if isinstance(node, RCat):
            s = e = self.state()
            for item in node.items:
                i_s, i_e = self.build(item)
                self.add_eps(e, i_s)
                e = i_e
            return s, e
        if isinstance(node, RAlt):
            s, e = self.state(), self.state()
            for item in node.items:
                i_s, i_e = self.build(item)
                self.add_eps(s, i_s)
                self.add_eps(i_e, e)
            return s, e
        if isinstance(node, RRep):
            s = e = self.state()
            for _ in range(node.min):
                i_s, i_e = self.build(node.item)
                self.add_eps(e, i_s)
                e = i_e
            if node.max is None:
                i_s, i_e = self.build(node.item)
                end = self.state()
                self.add_eps(e, i_s)
                self.add_eps(e, end)
                self.add_eps(i_e, i_s)
                self.add_eps(i_e, end)
                return s, end
            for _ in range(node.max - node.min):
                i_s, i_e = self.build(node.item)
                end = self.state()
                self.add_eps(e, i_s)
                self.add_eps(e, end)
                self.add_eps(i_e, end)
                e = end
            return s, e
        raise AssertionError(f"unknown AST node {node!r}")

    def closure(self, start: int) -> dict[int, DNF]:
        """All states reachable from ``start`` via epsilon edges, with the DNF
        of accumulated assertion conjunctions for each."""
        reached: dict[int, set[Conj]] = {start: {frozenset()}}
        work: list[tuple[int, Conj]] = [(start, frozenset())]
        while work:
            state, conj = work.pop()
            for target, label in self.eps.get(state, ()):  # noqa: B905
                new_conj = conj if label is None else conj | {label}
                if not _conj_consistent(new_conj):
                    continue
                bucket = reached.setdefault(target, set())
                if new_conj in bucket or any(c <= new_conj for c in bucket):
                    continue
                bucket.add(new_conj)
                work.append((target, new_conj))
        return {s: frozenset(conjs) for s, conjs in reached.items()}


def build_position_nfa(node: object) -> PositionNFA:
    """Lower a regex AST into a :class:`PositionNFA`."""
    builder = _Builder()
    start, accept = builder.build(node)

    nfa = PositionNFA(classes=builder.classes)

    def harvest(closure: dict[int, DNF]) -> tuple[dict[int, DNF], DNF]:
        """Map a closure to (position → entry DNF via that position's char
        edge, DNF for reaching accept)."""
        targets: dict[int, DNF] = {}
        accept_dnf = FALSE_DNF
        for state, dnf in closure.items():
            if state == accept:
                accept_dnf = _dnf_or(accept_dnf, dnf)
            edge = builder.char_edges.get(state)
            if edge is not None:
                pos, _ = edge
                # Conjunctions accumulated up to the char are evaluated at the
                # gap immediately before it.
                targets[pos] = _dnf_or(targets.get(pos, FALSE_DNF), dnf)
        return targets, accept_dnf

    entry_targets, empty_dnf = harvest(builder.closure(start))
    nfa.entries = entry_targets
    nfa.empty_dnf = empty_dnf

    for _state, (pos, after) in builder.char_edges.items():
        targets, accept_dnf = harvest(builder.closure(after))
        if targets:
            nfa.edges[pos] = targets
        if accept_dnf:
            nfa.accepts[pos] = accept_dnf
    return nfa
