"""Catastrophic-backtracking analysis on the compiled position NFA.

A backtracking engine (Python ``re``, which evaluates anything the TPU
compiler routed to the host path) goes exponential exactly when the
pattern's NFA has *exponential degree of ambiguity* (EDA): some state can
loop back to itself along two distinct paths reading the same word
(Weideman et al., "Analyzing Matching Time Behavior of Backtracking Regex
Matchers"; the same property Hyperflex-style SIMD-DFA work decides to pick
vectorizable automata — PAPERS.md). We already build a Glushkov position
automaton per pattern (``compiler/re_nfa.py``), so the test is a product-
automaton SCC check over byte-class overlaps — automata analysis, not
regex-string heuristics.

The check is conservative in one direction only: zero-width assertion
conditions on transitions are ignored (treated as true), so a pattern can
be flagged whose assertions actually forbid the ambiguous word. That is
the right polarity for a linter — an assertion-saved pattern is one
refactor away from a 3am ReDoS on the degraded path.
"""

from __future__ import annotations

from functools import lru_cache

from ..compiler.re_nfa import PositionNFA, build_position_nfa
from ..compiler.re_parser import (
    RAlt,
    RAssert,
    RCat,
    RChar,
    REmpty,
    RegexParseError,
    RRep,
    parse_regex,
)

# Product-graph size guard: pairs scale as positions^2. Patterns past the
# cap get verdict None ("too large to analyze") rather than a wrong answer.
MAX_POSITIONS = 320

# Work cap for one pattern: product edge expansions (deg(p)·deg(q) per
# visited pair, counted once — successor lists are memoized and shared by
# the reachability pass and the SCC pass). CRS-scale patterns land well
# under this; a pathological one gets verdict None instead of minutes.
MAX_PRODUCT_EDGES = 4_000_000


def _useful_positions(nfa: PositionNFA) -> set[int]:
    """Positions both reachable from an entry and co-reachable to an
    accept — ambiguity among useless states cannot affect matching."""
    fwd: set[int] = set(nfa.entries)
    work = list(fwd)
    while work:
        p = work.pop()
        for q in nfa.edges.get(p, ()):
            if q not in fwd:
                fwd.add(q)
                work.append(q)
    rev_edges: dict[int, list[int]] = {}
    for p, targets in nfa.edges.items():
        for q in targets:
            rev_edges.setdefault(q, []).append(p)
    back: set[int] = set(nfa.accepts)
    work = list(back)
    while work:
        q = work.pop()
        for p in rev_edges.get(q, ()):
            if p not in back:
                back.add(p)
                work.append(p)
    return fwd & back


def nfa_has_eda(nfa: PositionNFA) -> bool | None:
    """True when the position NFA has exponential ambiguity (an SCC of the
    self-product containing both a diagonal and an off-diagonal pair),
    False when provably not, None when the pattern is too large.

    The product is built over *unordered* pairs: swap is an automorphism
    of the self-product, so the quotient preserves SCC structure and the
    diagonal/off-diagonal mixing property while halving the state space.
    Successor lists are computed once per pair and shared between the
    reachability pass and the SCC pass (the walk, not the SCC, is the
    cost: deg(p)·deg(q) mask tests per pair)."""
    if nfa.n_positions > MAX_POSITIONS:
        return None
    useful = _useful_positions(nfa)
    if not useful:
        return False

    classes = nfa.classes
    adj: dict[int, list[tuple[int, int]]] = {
        p: [(q, classes[q]) for q in nfa.edges.get(p, {}) if q in useful]
        for p in useful
    }

    # Reachable product subgraph seeded from the diagonal (two copies of
    # the automaton starting in lockstep — the configuration a
    # backtracker actually reaches), memoizing successors per pair.
    succ: dict[tuple[int, int], list[tuple[int, int]]] = {}
    seeds = [(p, p) for p in useful]
    seen: set[tuple[int, int]] = set(seeds)
    work = list(seeds)
    budget = MAX_PRODUCT_EDGES
    while work:
        node = work.pop()
        p, q = node
        ap = adj[p]
        outs: set[tuple[int, int]] = set()
        if p == q:
            budget -= (len(ap) * (len(ap) + 1)) // 2
            for i, (p2, cp) in enumerate(ap):
                for q2, cq in ap[i:]:
                    if cp & cq:
                        outs.add((p2, q2) if p2 <= q2 else (q2, p2))
        else:
            aq = adj[q]
            budget -= len(ap) * len(aq)
            for p2, cp in ap:
                for q2, cq in aq:
                    if cp & cq:
                        outs.add((p2, q2) if p2 <= q2 else (q2, p2))
        if budget < 0:
            return None
        lst = list(outs)
        succ[node] = lst
        for nxt in lst:
            if nxt not in seen:
                seen.add(nxt)
                work.append(nxt)

    # Tarjan SCC (iterative): EDA iff some SCC mixes a diagonal pair with
    # an off-diagonal pair — the state can split into two distinct runs
    # and re-merge on the same word, doubling the backtrack tree per loop.
    index: dict[tuple[int, int], int] = {}
    low: dict[tuple[int, int], int] = {}
    on_stack: set[tuple[int, int]] = set()
    stack: list[tuple[int, int]] = []
    counter = [0]

    def strongconnect(root: tuple[int, int]) -> bool:
        call = [(root, iter(succ[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while call:
            node, it = call[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    call.append((nxt, iter(succ[nxt])))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            call.pop()
            if call:
                parent = call[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    scc.append(member)
                    if member == node:
                        break
                # Mixing a diagonal with an off-diagonal pair needs at
                # least two members, so trivial (single-node) SCCs can
                # never witness EDA regardless of self loops.
                if len(scc) > 1:
                    has_diag = any(p == q for p, q in scc)
                    has_off = any(p != q for p, q in scc)
                    if has_diag and has_off:
                        return True
        return False

    for node in succ:
        if node not in index and strongconnect(node):
            return True
    return False


def _nullable(node: object) -> bool:
    if isinstance(node, (REmpty, RAssert)):
        return True
    if isinstance(node, RChar):
        return False
    if isinstance(node, RCat):
        return all(_nullable(i) for i in node.items)
    if isinstance(node, RAlt):
        return any(_nullable(i) for i in node.items)
    if isinstance(node, RRep):
        return node.min == 0 or _nullable(node.item)
    return False


def _consumes(node: object) -> bool:
    """True when the sub-language contains at least one non-empty word."""
    if isinstance(node, RChar):
        return True
    if isinstance(node, (RCat, RAlt)):
        return any(_consumes(i) for i in node.items)
    if isinstance(node, RRep):
        return (node.max is None or node.max > 0) and _consumes(node.item)
    return False


def ast_has_nullable_loop(node: object) -> bool:
    """Unbounded repeat over a nullable body that can also consume input
    (``(a*)*``, ``(a?)+``, ``(x|y*)*``). The ambiguity lives in the
    ε-decompositions of each iteration, which the ε-free position NFA
    cannot represent — Glushkov construction collapses nested stars — so
    it must be decided on the AST. Python ``re`` demonstrably goes
    exponential on this class (the empty-iteration guard does not help:
    the blowup is in how the non-empty iterations split the input)."""
    if isinstance(node, RRep):
        if node.max is None and _nullable(node.item) and _consumes(node.item):
            return True
        return ast_has_nullable_loop(node.item)
    if isinstance(node, (RCat, RAlt)):
        return any(ast_has_nullable_loop(i) for i in node.items)
    return False


@lru_cache(maxsize=4096)
def pattern_has_eda(pattern: str, case_insensitive: bool = False) -> bool | None:
    """EDA verdict for a raw pattern string; None when it cannot be parsed
    by the RE2-subset front end or is too large to analyze. Cached
    process-wide: CRS repeats the same pattern across paranoia levels and
    the reload gate re-analyzes the same document version repeatedly."""
    try:
        ast = parse_regex(pattern, case_insensitive=case_insensitive)
    except RegexParseError:
        return None
    if ast_has_nullable_loop(ast):
        return True
    try:
        nfa = build_position_nfa(ast)
    except Exception:
        return None
    return nfa_has_eda(nfa)
