"""Position NFA → byte-class-compressed DFA tables.

The device-side matcher (``ops/dfa.py``) is a ``lax.scan`` over input bytes
doing two gathers per step: ``cls = classmap[byte]`` then
``state, hit = trans[state, cls], emit[state, cls]``. This module builds those
tables by subset construction over (position set, previous-byte context),
where the previous-byte context (exists / is-word / is-newline) is exactly
what's needed to evaluate assertion gaps, so ``\\b``/anchors are exact.

Byte-class compression is the classic lexer-table trick: bytes with identical
behavior across every position class share a column, typically compressing
256 → ≲64 columns, an ~8x HBM saving across a full CRS ruleset.

This replaces (TPU-shaped) what the reference outsources to the RE2 engine
inside coraza-proxy-wasm (see ``hack/generate_coreruleset_configmaps.py:24-27``
for the RE2 constraint the corpus already obeys).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .re_parser import RAlt, RCat, RChar, case_fold, parse_regex, WORD
from .re_nfa import (
    FALSE_DNF,
    PositionNFA,
    build_position_nfa,
    eval_conj,
)


class DFAError(ValueError):
    """Raised when a pattern cannot be compiled to bounded DFA tables."""


# Previous-byte context: (exists, is_word, is_newline)
_PREV_NONE = (False, False, False)


def _prev_ctx_of(byte: int) -> tuple[bool, bool, bool]:
    return (True, bool(WORD >> byte & 1), byte == 0x0A)


def _eval_dnf_ctx(dnf, prev_ctx: tuple[bool, bool, bool], nxt: int | None) -> bool:
    """Evaluate a DNF where the previous byte is abstracted to its context
    bits. Assertions only inspect exists/is-word/is-newline of the previous
    byte, so any representative byte with matching bits is equivalent."""
    exists, is_word, is_nl = prev_ctx
    if not exists:
        prev = None
    elif is_nl:
        prev = 0x0A
    elif is_word:
        prev = ord("a")
    else:
        prev = ord(" ")
    return any(eval_conj(conj, prev, nxt) for conj in dnf)


@dataclass
class DFA:
    """Compiled scanner tables for one pattern.

    ``trans[s, c]`` — next state; ``emit[s, c]`` — a match completed when
    consuming a byte of class ``c`` in state ``s``; ``match_end[s]`` — a match
    completes at end-of-input in state ``s``; ``classmap[b]`` — byte → class.
    State 0 is initial. ``always_match`` short-circuits patterns that match
    the empty string unconditionally.
    """

    trans: np.ndarray  # [S, C] int32
    emit: np.ndarray  # [S, C] bool
    match_end: np.ndarray  # [S] bool
    classmap: np.ndarray  # [256] int32
    always_match: bool
    # Source AST (host-only metadata): lets the model builder try the
    # conv-segment decomposition (``compiler/segments.py``) before falling
    # back to scanning these tables.
    ast: object = None
    # State count of the subset-construction automaton BEFORE minimization
    # (0 = never minimized). Host metadata for CompileReport / metrics.
    pre_min_states: int = 0

    @property
    def n_states(self) -> int:
        return int(self.trans.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.trans.shape[1])

    def minimize(self) -> "DFA":
        """Hopcroft-equivalent state minimization plus byte-class re-merge.

        Partition refinement over Mealy signatures: two states are merged
        only when they agree on ``match_end``, on the full ``emit`` row,
        and transition to pairwise-equivalent states — so ``search`` is
        bit-identical on every input by construction. Implemented as
        vectorized signature hashing (``np.unique`` over rows) iterated
        to fixpoint, which computes the same coarsest partition Hopcroft
        does in near-linear practical time. After state merging, byte
        classes whose (trans, emit) columns became identical are merged
        and ``classmap`` re-derived, shrinking both table axes.
        """
        trans, emit, me = self.trans, self.emit, self.match_end
        n_states = int(trans.shape[0])
        # Initial partition: Mealy outputs (match_end, emit row).
        sig0 = np.concatenate(
            [me[:, None].astype(np.int64), emit.astype(np.int64)], axis=1
        )
        _, block = np.unique(sig0, axis=0, return_inverse=True)
        n_blocks = int(block.max()) + 1 if n_states else 0
        while True:
            sig = np.concatenate([block[:, None], block[trans]], axis=1)
            _, new_block = np.unique(sig, axis=0, return_inverse=True)
            n_new = int(new_block.max()) + 1 if n_states else 0
            block = new_block
            if n_new == n_blocks:
                break
            n_blocks = n_new
        # Stable relabel: blocks numbered by first-occurrence state order,
        # so the block containing state 0 is state 0 and equal automata
        # minimize to byte-identical tables (cache determinism).
        uniq, first = np.unique(block, return_index=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(n_blocks, dtype=np.int64)
        rank[uniq[order]] = np.arange(n_blocks)
        new_of_state = rank[block]
        reps = first[order]  # representative old state per new state
        trans2 = new_of_state[trans[reps]].astype(np.int32)
        emit2 = emit[reps]
        me2 = me[reps]
        # Byte-class merge: columns with identical behavior share a class.
        colsig = np.concatenate(
            [trans2.astype(np.int64), emit2.astype(np.int64)], axis=0
        ).T  # [C, 2*S']
        _, cinv = np.unique(colsig, axis=0, return_inverse=True)
        n_cls = int(cinv.max()) + 1 if cinv.size else 0
        cu, cfirst = np.unique(cinv, return_index=True)
        corder = np.argsort(cfirst, kind="stable")
        crank = np.empty(n_cls, dtype=np.int64)
        crank[cu[corder]] = np.arange(n_cls)
        creps = cfirst[corder]
        return DFA(
            trans=np.ascontiguousarray(trans2[:, creps]),
            emit=np.ascontiguousarray(emit2[:, creps]),
            match_end=me2,
            classmap=crank[cinv[self.classmap]].astype(np.int32),
            always_match=self.always_match,
            ast=self.ast,
            pre_min_states=self.pre_min_states or n_states,
        )

    def search(self, data: bytes) -> bool:
        """Reference scalar scan — the oracle for kernel differential tests."""
        if self.always_match:
            return True
        s = 0
        for b in data:
            c = self.classmap[b]
            if self.emit[s, c]:
                return True
            s = self.trans[s, c]
        return bool(self.match_end[s])


def _byte_classes(nfa: PositionNFA) -> tuple[np.ndarray, list[int]]:
    """Partition bytes into equivalence classes by (position-class membership
    vector, word-ness, newline-ness). Returns (classmap[256], representatives)."""
    signatures: dict[tuple, int] = {}
    classmap = np.zeros(256, dtype=np.int32)
    reps: list[int] = []
    for b in range(256):
        sig = tuple(cls >> b & 1 for cls in nfa.classes) + (
            bool(WORD >> b & 1),
            b == 0x0A,
        )
        cls_id = signatures.get(sig)
        if cls_id is None:
            cls_id = len(signatures)
            signatures[sig] = cls_id
            reps.append(b)
        classmap[b] = cls_id
    return classmap, reps


def compile_nfa_dfa(nfa: PositionNFA, max_states: int = 8192, ast: object | None = None) -> DFA:
    """Subset construction over (position bitmask, prev-byte context).

    Position sets are Python big-int bitmasks and every DNF guard is
    pre-evaluated per (context, byte-class) into entry/target/accept
    masks, so the per-(state, class) inner loop is pure integer ORs —
    a CRS-grade ``[^>]{0,60}`` alternation (~4k DFA states) determinizes
    in well under a second where the dict/frozenset form took ~80 s.
    """
    classmap, reps = _byte_classes(nfa)

    # The 4 reachable prev-byte contexts: none, word, non-word, newline.
    ctxs = [_PREV_NONE, (True, True, False), (True, False, False), (True, False, True)]
    ctx_index = {c: i for i, c in enumerate(ctxs)}
    n_ctx = len(ctxs)
    n_reps = len(reps)

    from .re_nfa import TRUE_DNF

    _dnf_cache: dict[tuple, bool] = {}

    def dnf_at(dnf, ci: int, nxt: int | None) -> bool:
        # Fast paths: almost every guard is unconditional.
        if dnf is TRUE_DNF or dnf == TRUE_DNF:
            return True
        if not dnf:
            return False
        key = (dnf, ci, nxt)
        val = _dnf_cache.get(key)
        if val is None:
            val = _eval_dnf_ctx(dnf, ctxs[ci], nxt)
            _dnf_cache[key] = val
        return val

    # Precompute per (ctx, rep): entry mask, accept mask, empty-match bit;
    # per position additionally the outgoing-target mask.
    ent_mask = [[0] * n_reps for _ in range(n_ctx)]
    acc_mask = [[0] * n_reps for _ in range(n_ctx)]
    empty_hit = [[False] * n_reps for _ in range(n_ctx)]
    acc_end = [0] * n_ctx
    empty_end = [False] * n_ctx
    n_pos = nfa.n_positions
    tgt_mask = [[[0] * n_reps for _ in range(n_ctx)] for _ in range(n_pos)]
    for ci in range(n_ctx):
        empty_end[ci] = dnf_at(nfa.empty_dnf, ci, None)
        for p, dnf in nfa.accepts.items():
            if dnf_at(dnf, ci, None):
                acc_end[ci] |= 1 << p
        for ri, b in enumerate(reps):
            empty_hit[ci][ri] = dnf_at(nfa.empty_dnf, ci, b)
            for q, dnf in nfa.entries.items():
                if nfa.classes[q] >> b & 1 and dnf_at(dnf, ci, b):
                    ent_mask[ci][ri] |= 1 << q
            for p, dnf in nfa.accepts.items():
                if dnf_at(dnf, ci, b):
                    acc_mask[ci][ri] |= 1 << p
            for p, out in nfa.edges.items():
                m = 0
                for q, dnf in out.items():
                    if nfa.classes[q] >> b & 1 and dnf_at(dnf, ci, b):
                        m |= 1 << q
                tgt_mask[p][ci][ri] = m

    rep_ctx = [ctx_index[_prev_ctx_of(b)] for b in reps]

    # DFA state: (position bitmask, ctx id).
    initial = (0, ctx_index[_PREV_NONE])
    index: dict[tuple[int, int], int] = {initial: 0}
    worklist: list[tuple[int, int]] = [initial]
    head = 0
    trans_rows: list[list[int]] = []
    emit_rows: list[list[bool]] = []
    end_rows: list[bool] = []

    while head < len(worklist):
        pos_mask, ci = worklist[head]
        head += 1
        end_rows.append(empty_end[ci] or bool(pos_mask & acc_end[ci]))
        row_t: list[int] = []
        row_e: list[bool] = []
        # Decompose the position set ONCE per state (not per byte class).
        tgt_ci: list[list[int]] = []
        m = pos_mask
        while m:
            low = m & -m
            tgt_ci.append(tgt_mask[low.bit_length() - 1][ci])
            m ^= low
        for ri in range(n_reps):
            row_e.append(empty_hit[ci][ri] or bool(pos_mask & acc_mask[ci][ri]))
            nxt = ent_mask[ci][ri]
            for row in tgt_ci:
                nxt |= row[ri]
            nxt_state = (nxt, rep_ctx[ri])
            nxt_id = index.get(nxt_state)
            if nxt_id is None:
                nxt_id = len(index)
                if nxt_id >= max_states:
                    raise DFAError(
                        f"DFA exceeds {max_states} states "
                        f"({nfa.n_positions} NFA positions)"
                    )
                index[nxt_state] = nxt_id
                worklist.append(nxt_state)
            row_t.append(nxt_id)
        trans_rows.append(row_t)
        emit_rows.append(row_e)

    # Minimize before the tables are emitted: subset construction over
    # (positions, prev-ctx) routinely mints context-duplicated states, and
    # every state removed here shrinks the stacked device banks and the
    # flat-slot bins downstream. literal_dfa
    # and pm_dfa funnel through this same return, so all three entry
    # points emit minimized tables.
    return DFA(
        trans=np.asarray(trans_rows, dtype=np.int32),
        emit=np.asarray(emit_rows, dtype=bool),
        match_end=np.asarray(end_rows, dtype=bool),
        classmap=classmap,
        always_match=nfa.always_matches,
        ast=ast,
    ).minimize()


# DFA construction cache: in-process memo + persistent on-disk pickle.
# The bench compiles overlapping rulesets (crs-lite base shared by
# configs 2/3/4, config 3's padding is a prefix of config 4's) and the
# control plane recompiles identical CRS text on every hot-reload poll;
# determinization is the dominant host-compile cost (~0.1 s per
# CRS-grade pattern on one core), so both layers pay for themselves
# immediately. Keyed by (algo version, pattern, ci, max_states); the
# AST is re-parsed on disk hits (parsing is ~free, and ASTs stay out of
# the pickle format). CKO_DFA_CACHE=0 disables the disk layer.
_DFA_ALGO_VERSION = 4  # v4: minimized tables + pre_min_states in pickle
_DFA_MEMO: dict[tuple, DFA] = {}


def _dfa_disk_dir():
    import os

    loc = os.environ.get("CKO_DFA_CACHE", "")
    if loc == "0":
        return None
    if loc:
        return loc
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "cko-dfa",
    )


def compile_regex_dfa(
    pattern: str, case_insensitive: bool = False, max_states: int = 8192
) -> DFA:
    """Compile an RE2-subset pattern into scanner tables (search semantics)."""
    import hashlib
    import os
    import pickle

    key = (pattern, case_insensitive, max_states)
    hit = _DFA_MEMO.get(key)
    if hit is not None:
        return hit
    cache_dir = _dfa_disk_dir()
    path = None
    if cache_dir is not None:
        digest = hashlib.sha256(
            repr((_DFA_ALGO_VERSION,) + key).encode()
        ).hexdigest()
        path = os.path.join(cache_dir, f"{digest}.pkl")
        try:
            with open(path, "rb") as fh:
                trans, emit, match_end, classmap, always, pre_min = pickle.load(fh)
            dfa = DFA(
                trans=trans,
                emit=emit,
                match_end=match_end,
                classmap=classmap,
                always_match=always,
                ast=parse_regex(pattern, case_insensitive=case_insensitive),
                pre_min_states=pre_min,
            )
            _DFA_MEMO[key] = dfa
            return dfa
        except FileNotFoundError:
            pass
        except Exception:
            pass  # corrupt/stale entry: recompile below and overwrite

    ast = parse_regex(pattern, case_insensitive=case_insensitive)
    nfa = build_position_nfa(ast)
    dfa = compile_nfa_dfa(nfa, max_states=max_states, ast=ast)
    _DFA_MEMO[key] = dfa
    if path is not None:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                pickle.dump(
                    (
                        dfa.trans,
                        dfa.emit,
                        dfa.match_end,
                        dfa.classmap,
                        dfa.always_match,
                        dfa.pre_min_states,
                    ),
                    fh,
                )
            os.replace(tmp, path)
        except OSError:
            pass
    return dfa


def _literal_ast(literal: bytes, case_insensitive: bool) -> object:
    items = []
    for ch in literal:
        mask = 1 << ch
        items.append(RChar(case_fold(mask) if case_insensitive else mask))
    if not items:
        from .re_parser import REmpty

        return REmpty()
    return RCat(items) if len(items) > 1 else items[0]


def literal_dfa(
    literal: bytes,
    case_insensitive: bool = False,
    begins_with: bool = False,
    ends_with: bool = False,
    exact: bool = False,
) -> DFA:
    """DFA for literal operators: ``@contains`` (default), ``@beginsWith``,
    ``@endsWith``, ``@streq``/``@within`` members (``exact``)."""
    ast = _literal_ast(literal, case_insensitive)
    from .re_parser import RAssert

    if exact:
        ast = RCat([RAssert("start"), ast, RAssert("end")])
    elif begins_with:
        ast = RCat([RAssert("start"), ast])
    elif ends_with:
        ast = RCat([ast, RAssert("end")])
    nfa = build_position_nfa(ast)
    return compile_nfa_dfa(nfa, ast=ast)


def joint_classmap(dfas: list[DFA]) -> tuple[np.ndarray, list[np.ndarray]]:
    """Joint byte-class partition across a bank of DFAs.

    Two bytes share a joint class iff every member DFA maps them to the
    same per-DFA class — the coarsest common refinement of the members'
    classmaps. Returns ``(classmap, remaps)``: ``classmap[256]`` int32
    with classes numbered by first byte occurrence (deterministic for
    the compile cache), and per member a ``remaps[i][joint_class] →
    member class`` vector so packed transition tables can be re-indexed
    by joint class. The gather hot tier keys its dense tables by joint
    class: table height drops from 256 to C (typically ≲64 for banks of
    similar CRS patterns), shrinking both VMEM residency and the
    per-step matmul by 256/C.
    """
    if not dfas:
        return np.zeros(256, dtype=np.int32), []
    stacked = np.stack([d.classmap for d in dfas], axis=1)  # [256, N]
    _, inv = np.unique(stacked, axis=0, return_inverse=True)
    n_cls = int(inv.max()) + 1
    uniq, first = np.unique(inv, return_index=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(n_cls, dtype=np.int64)
    rank[uniq[order]] = np.arange(n_cls)
    classmap = rank[inv].astype(np.int32)
    reps = first[order]  # representative byte per joint class
    remaps = [d.classmap[reps].astype(np.int32) for d in dfas]
    return classmap, remaps


def joint_class_count(dfas: list[DFA]) -> int:
    """Number of joint byte classes ``joint_classmap`` would produce —
    cheap enough for greedy bank packing to call per candidate."""
    if not dfas:
        return 0
    stacked = np.stack([d.classmap for d in dfas], axis=1)
    return int(np.unique(stacked, axis=0).shape[0])


def pm_dfa(words: list[bytes], max_states: int = 65536) -> DFA:
    """DFA for ``@pm``/``@pmFromFile``: case-insensitive multi-literal match.
    Subset construction over the alternation yields exactly the Aho-Corasick
    automaton (cf. coraza's aho-corasick dependency, reference ``go.mod:52``)."""
    branches = [_literal_ast(w, case_insensitive=True) for w in words if w]
    if not branches:
        raise DFAError("@pm requires at least one pattern")
    ast = RAlt(branches) if len(branches) > 1 else branches[0]
    nfa = build_position_nfa(ast)
    return compile_nfa_dfa(nfa, max_states=max_states, ast=ast)
