"""Regex → fixed-length segment / gap decomposition for the conv matcher.

The DFA bank scan (``ops/dfa.py``) is inherently sequential: one MXU
contraction *per input byte*, costing ``256·S·G`` MACs a step. Most WAF
patterns, however, are a chain of **fixed-length byte-class runs** joined
by constrained gaps — ``\\bunion\\s+select\\b``, ``<script[^>]*>``,
``attack\\d+x=\\d`` — and fixed-length runs can be matched for *every
start position at once* with ONE convolution riding the MXU
(``ops/segment.py``). This module is the host-side decomposer: given a
parsed regex AST (``re_parser``) it either produces an **exact** plan

    Branch = Seg (class positions, incl. \\b context) · Gap (class, lo, hi) · …

or returns ``None``, in which case the group stays on the DFA tier. The
decomposition is the TPU-shaped analog of Hyperscan's literal+FDR
decomposition (the engine behind the reference's Coraza/aho-corasick
dependency chain, reference ``go.mod:52``) — but lowered to convolution
instead of SIMD shift-or, because on TPU the systolic array is the fast
path and convs are its native diet.

Exactness contract: every accepted plan matches byte-for-byte the same
inputs as the source regex under search semantics (differentially tested
against Python ``re`` in ``tests/test_segment_matcher.py``). Anything not
provably exact falls back — never approximate here.
"""

from __future__ import annotations

from dataclasses import dataclass

from .re_parser import ALL_BYTES, RAlt, RAssert, RCat, RChar, REmpty, RRep, WORD

NONWORD = ALL_BYTES & ~WORD

# Decomposition caps: beyond these the DFA tier is the better engine
# (e.g. @pm word lists compile to one Aho-Corasick DFA, not 500 channels).
# MAX_BRANCHES at 128 admits CRS-grade alternation products (a 10-tag x
# 10-event XSS rule expands to ~100 branches). Conv columns after the
# finals dedup are cheap — branches from a shared token vocabulary
# collapse to one column per distinct (first segment, suffix) — while
# the SAME pattern on the DFA tier determinizes to ~4-6k states and
# scans on the serializing gather path (measured ~4x the whole step).
MAX_BRANCHES = 128
MAX_SEG_LEN = 24
MAX_ELEMENTS = 12
# Bounded class-gaps: spans <= the unroll cap use shift-unrolled ORs;
# wider spans (up to MAX_BOUNDED_GAP_SPAN) use the O(log span)
# windowed-min over NCE prefix sums (ops/segment.py:gap_cls) — both
# exact, so the planner accepts any span up to the cap.
MAX_BOUNDED_GAP_SPAN = 256


@dataclass(frozen=True)
class Seg:
    """Fixed-length run of byte-class positions.

    ``classes[i]`` is a 256-bit mask. The first ``n_lead`` positions are
    *context*: they read the byte(s) immediately before the real match
    start (the ``\\b`` encoding — the matcher front-pads the buffer with
    one NUL so position -1 reads as a non-word byte). The last ``n_trail``
    positions read bytes at/after the real end without consuming them.
    """

    classes: tuple[int, ...]
    n_lead: int = 0
    n_trail: int = 0

    @property
    def n_real(self) -> int:
        return len(self.classes) - self.n_lead - self.n_trail


@dataclass(frozen=True)
class Gap:
    """``lo``..``hi`` bytes, every one in ``mask`` (``hi=None`` unbounded)."""

    mask: int
    lo: int
    hi: int | None


@dataclass(frozen=True)
class Branch:
    elements: tuple  # Seg | Gap
    anchored_start: bool = False
    anchored_end: bool = False


@dataclass(frozen=True)
class SegmentPlan:
    """One group's exact decomposition: match ⇔ any branch matches."""

    branches: tuple[Branch, ...]
    always: bool = False  # pattern matches the empty string (search ⇒ always)


class _Reject(Exception):
    """Internal: this AST has no exact segment decomposition."""


# ---------------------------------------------------------------------------
# AST → raw element branches
# ---------------------------------------------------------------------------

# Raw elements: ('cls', mask) | ('gap', mask, lo, hi|None) | ('assert', kind)


def _expand(node) -> list[list[tuple]]:
    if isinstance(node, RChar):
        return [[("cls", node.mask)]]
    if isinstance(node, REmpty):
        return [[]]
    if isinstance(node, RAssert):
        if node.kind in ("wordb", "start", "end"):
            return [[("assert", node.kind)]]
        raise _Reject(f"assertion {node.kind}")
    if isinstance(node, RCat):
        branches: list[list[tuple]] = [[]]
        for item in node.items:
            subs = _expand(item)
            branches = [b + s for b in branches for s in subs]
            if len(branches) > MAX_BRANCHES:
                raise _Reject("branch explosion in concat")
        return branches
    if isinstance(node, RAlt):
        branches = []
        for item in node.items:
            branches.extend(_expand(item))
            if len(branches) > MAX_BRANCHES:
                raise _Reject("branch explosion in alternation")
        return branches
    if isinstance(node, RRep):
        return _expand_rep(node)
    raise _Reject(f"unsupported node {type(node).__name__}")


def _single_class_of(subs: list[list[tuple]]) -> int | None:
    """If every branch of the repeated item is exactly one class position,
    the union mask (repetition of a class is a class gap)."""
    mask = 0
    for branch in subs:
        if len(branch) != 1 or branch[0][0] != "cls":
            return None
        mask |= branch[0][1]
    # Union is exact only when all branches share one mask (e.g. (a|b) as
    # [ab] was already folded by the parser); differing masks under
    # repetition would conflate orders ((a|b){2} != [ab]{2} is FALSE —
    # they are the same language, single positions have no ordering).
    return mask


def _expand_rep(node: RRep) -> list[list[tuple]]:
    subs = _expand(node.item)
    lo, hi = node.min, node.max
    mask = _single_class_of(subs)
    if mask is not None:
        out: list[tuple] = [("cls", mask)] * lo
        if hi is None:
            out.append(("gap", mask, 0, None))
        elif hi > lo:
            out.append(("gap", mask, 0, hi - lo))
        return [out]
    # Complex item: expand bounded small repetitions as alternation.
    if hi is None:
        raise _Reject("unbounded repetition of a composite")
    if hi > 3:
        raise _Reject("wide bounded repetition of a composite")
    branches: list[list[tuple]] = []
    for k in range(lo, hi + 1):
        reps: list[list[tuple]] = [[]]
        for _ in range(k):
            reps = [r + s for r in reps for s in subs]
            if len(reps) > MAX_BRANCHES:
                raise _Reject("branch explosion in repetition")
        branches.extend(reps)
        if len(branches) > MAX_BRANCHES:
            raise _Reject("branch explosion in repetition")
    return branches


# ---------------------------------------------------------------------------
# Assertion resolution
# ---------------------------------------------------------------------------


def _wordness(mask: int) -> bool | None:
    """True = all word bytes, False = all non-word, None = mixed."""
    if mask == 0:
        return None
    if mask & ~WORD == 0:
        return True
    if mask & WORD == 0:
        return False
    return None


def _neighbor_wordness(elems: list[tuple], idx: int, direction: int) -> bool | None:
    """Word-ness of the byte adjacent to position ``idx`` looking
    ``direction`` (+1 right / -1 left), seeing through possibly-empty gaps
    when gap content and the next element agree."""
    j = idx + direction
    agree: bool | None = "unset"  # sentinel
    while 0 <= j < len(elems):
        kind = elems[j][0]
        if kind == "assert":
            j += direction
            continue
        if kind == "cls":
            w = _wordness(elems[j][1])
            return w if agree == "unset" else (w if w == agree else None)
        # gap
        _, mask, lo, _hi = elems[j]
        w = _wordness(mask)
        if w is None:
            return None
        if agree != "unset" and w != agree:
            return None
        if lo > 0:
            return w  # gap guaranteed non-empty: its first byte decides
        agree = w  # gap may be empty: the next element must agree
        j += direction
    return None  # ran off the pattern edge


def _resolve_asserts(elems: list[tuple]) -> tuple[list[tuple], bool, bool] | None:
    """Convert assertions to anchors / context classes. Returns
    (elements, anchored_start, anchored_end), None when the branch can
    never match, raises _Reject when not exactly encodable."""
    anchored_start = anchored_end = False
    out: list[tuple] = []

    def _min_consumed(sub: list[tuple]) -> int:
        total = 0
        for e in sub:
            if e[0] == "cls":
                total += 1
            elif e[0] == "gap":
                total += e[2]
        return total

    for i, e in enumerate(elems):
        if e[0] != "assert":
            out.append(e)
            continue
        kind = e[1]
        if kind == "start":
            if _min_consumed(elems[:i]) > 0:
                return None  # ^ after mandatory consumption: never matches
            if any(x[0] != "assert" for x in elems[:i]):
                raise _Reject("^ after possibly-empty elements")
            anchored_start = True
            continue
        if kind == "end":
            if _min_consumed(elems[i + 1 :]) > 0:
                return None
            if any(x[0] != "assert" for x in elems[i + 1 :]):
                raise _Reject("$ before possibly-empty elements")
            anchored_end = True
            continue
        # wordb: boundary ⇔ word-ness(prev byte / absent=nonword) differs
        # from word-ness(next byte / absent=nonword).
        left = _neighbor_wordness(elems, i, -1)
        right = _neighbor_wordness(elems, i, +1)
        if left is not None and right is not None:
            if left == right:
                return None  # \b between two same-wordness bytes: never
            continue  # opposite word-ness: always true, drop
        if right is not None:
            # Context position reading the byte before: nonword when the
            # following byte is word (the front NUL pad makes
            # start-of-input read as nonword) and vice versa. Exact
            # whether the left side is mixed-class or the pattern edge.
            out.append(("ctx_lead", NONWORD if right else WORD))
            continue
        if left is not None:
            out.append(("ctx_trail", NONWORD if left else WORD))
            continue
        raise _Reject("wordb with both neighbors undetermined")
    return out, anchored_start, anchored_end


# ---------------------------------------------------------------------------
# Normalization: fuse classes into segments, merge gaps
# ---------------------------------------------------------------------------


def _normalize(elems: list[tuple], anchored_start: bool, anchored_end: bool) -> Branch:
    elements: list = []
    run: list[int] = []
    lead = 0
    trail = 0

    def flush_run():
        nonlocal run, lead, trail
        if run:
            if len(run) - lead - trail > MAX_SEG_LEN:
                raise _Reject("segment longer than MAX_SEG_LEN")
            elements.append(Seg(tuple(run), n_lead=lead, n_trail=trail))
        run, lead, trail = [], 0, 0

    for e in elems:
        kind = e[0]
        if kind == "cls":
            if trail:
                # Real positions may not follow a trailing context inside
                # one segment; start a new one (the context overlaps the
                # following bytes by design).
                flush_run()
            run.append(e[1])
        elif kind == "ctx_lead":
            # Reads the byte before the NEXT real position: start a new
            # run with it as lead context (when it directly follows real
            # positions both windows constrain that same byte — the chain
            # ANDs them, which is exactly \b's conjunction).
            if run and (len(run) - lead - trail) > 0:
                flush_run()
            run.append(e[1])
            lead += 1
        elif kind == "ctx_trail":
            run.append(e[1])
            trail += 1
        else:  # gap
            flush_run()
            _, mask, lo, hi = e
            if elements and isinstance(elements[-1], Gap) and elements[-1].mask == mask:
                prev = elements.pop()
                hi2 = None if (prev.hi is None or hi is None) else prev.hi + hi
                elements.append(Gap(mask, prev.lo + lo, hi2))
            else:
                elements.append(Gap(mask, lo, hi))
    flush_run()

    if len(elements) > MAX_ELEMENTS:
        raise _Reject("too many elements")
    for el in elements:
        if isinstance(el, Gap) and el.mask != ALL_BYTES and el.hi is not None:
            if el.hi - el.lo > MAX_BOUNDED_GAP_SPAN:
                raise _Reject("wide bounded class gap")
    return Branch(tuple(elements), anchored_start, anchored_end)


def plan_segments(ast) -> SegmentPlan | None:
    """Exact segment/gap plan for ``ast``, or None (stay on the DFA tier)."""
    if ast is None:
        return None
    try:
        raw = _expand(ast)
    except (_Reject, RecursionError):
        return None

    branches: list[Branch] = []
    always = False
    try:
        for elems in raw:
            resolved = _resolve_asserts(elems)
            if resolved is None:
                continue  # branch can never match
            out, a_start, a_end = resolved
            branch = _normalize(out, a_start, a_end)
            if not branch.elements:
                if a_start and a_end:
                    raise _Reject("empty anchored branch (len==0 match)")
                # Empty unanchored branch matches everywhere.
                always = True
                continue
            if not any(isinstance(el, Seg) for el in branch.elements):
                gaps = branch.elements
                if all(g.lo == 0 for g in gaps) and not (a_start and a_end):
                    always = True
                    continue
                raise _Reject("segment-free branch with required gap bytes")
            # A branch must contain at least one real position for the
            # chain's valid-start masking to anchor on.
            if not any(isinstance(el, Seg) and el.n_real > 0 for el in branch.elements):
                raise _Reject("branch with only context positions")
            branches.append(branch)
    except _Reject:
        return None

    if always and not branches:
        return SegmentPlan(branches=(), always=True)
    if not branches:
        return None  # no branch can ever match: leave to the DFA (never)
    return SegmentPlan(branches=tuple(branches), always=always)
