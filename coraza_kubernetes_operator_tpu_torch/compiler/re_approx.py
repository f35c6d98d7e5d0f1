"""Lossy over-approximating automata for the device prefilter.

An expensive rule group (state count past the dense-table ceiling) scans
through XLA's serializing gather path today. The two-level automata
design (arXiv:1904.10786) fronts such a group with a SMALL automaton
whose language is a strict superset of the original's: the common
no-match case clears on device at hot-tier cost, and only the rare
positive rows pay an exact host confirmation (the existing bit-identical
host-fallback machinery), so verdicts never change.

Construction — state merging under a surjection φ:

1. pick a partition of the exact DFA's states into at most ``width``
   blocks (``_merge_partition``): partition refinement from the trivial
   one-block partition, keeping the LAST refinement step that still fits
   the width cap. Refinement only splits, so every kept partition is a
   valid surjection; later steps are strictly more selective.
2. quotient the DFA by φ with OR-ed outputs: block ``b`` emits on class
   ``c`` when ANY member state does, transitions to the SET of images of
   member transitions. φ is then a simulation of the exact DFA by the
   merged NFA — every exact run maps step-by-step to a merged run with a
   superset of emits — hence L(exact) ⊆ L(merged). **No false
   negatives, by construction.**
3. determinize the merged NFA by subset construction over block
   bitmasks (≤ ``width`` bits, so sets are machine ints) under a state
   cap, then Hopcroft-minimize. Determinization and minimization both
   preserve the language, so the soundness inclusion survives to the
   emitted tables.

On cap blowup the width is halved and the construction retried — a
narrower merge has fewer subset states. A width below 2 (or an exact
automaton that ``always_match``es, or a merge that collapsed to an
automaton accepting essentially everything) is ineligible: the caller
keeps the group on the exact NFA path and reports why.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .re_dfa import DFA

# Default number of merged states (φ's codomain). Narrow enough that the
# subset DFA stays inside the dense-table fast path, wide enough to keep
# the byte-class structure (hence selectivity) of CRS-grade patterns.
DEFAULT_WIDTH = 16

# Subset-construction cap for the approximate DFA. 128 == the dense-table
# ceiling (ops/dfa.py _DENSE_MAX_STATES): an approximation past it would
# land right back on the serializing path it exists to avoid.
DEFAULT_MAX_STATES = 128


@dataclass
class ApproxResult:
    """Outcome of one prefilter-automaton construction attempt."""

    dfa: DFA | None  # None = ineligible
    reason: str  # "" on success, else why the group stays exact
    width: int = 0  # merge width actually used


def _merge_partition(dfa: DFA, width: int) -> np.ndarray:
    """Partition states into <= ``width`` blocks: refinement from one
    block by (block, successor blocks, emit row, match_end) signatures,
    stopping BEFORE the block count exceeds the cap. Any prefix of the
    refinement is a valid (sound) merge; the deepest one that fits is
    the most selective."""
    n = dfa.n_states
    block = np.zeros(n, dtype=np.int64)
    n_blocks = 1
    outputs = np.concatenate(
        [dfa.match_end[:, None].astype(np.int64), dfa.emit.astype(np.int64)],
        axis=1,
    )
    while True:
        sig = np.concatenate([block[:, None], block[dfa.trans], outputs], axis=1)
        _, new_block = np.unique(sig, axis=0, return_inverse=True)
        n_new = int(new_block.max()) + 1 if n else 0
        if n_new > width or n_new == n_blocks:
            return block
        block, n_blocks = new_block, n_new


def _subset_determinize(
    n_blocks: int,
    q_trans: list[list[int]],  # [K][C] target-block bitmask
    q_emit: np.ndarray,  # [K, C] bool
    q_end: np.ndarray,  # [K] bool
    init_block: int,
    n_classes: int,
    max_states: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Subset construction over block bitmasks. Returns (trans, emit,
    match_end) arrays or None past the state cap."""
    initial = 1 << init_block
    index: dict[int, int] = {initial: 0}
    work = [initial]
    trans_rows: list[list[int]] = []
    emit_rows: list[list[bool]] = []
    end_rows: list[bool] = []
    head = 0
    members_cache: dict[int, list[int]] = {}

    def members(mask: int) -> list[int]:
        got = members_cache.get(mask)
        if got is None:
            got = []
            m = mask
            while m:
                low = m & -m
                got.append(low.bit_length() - 1)
                m ^= low
            members_cache[mask] = got
        return got

    while head < len(work):
        mask = work[head]
        head += 1
        blocks = members(mask)
        end_rows.append(bool(any(q_end[b] for b in blocks)))
        row_t: list[int] = []
        row_e: list[bool] = []
        for c in range(n_classes):
            nxt = 0
            hit = False
            for b in blocks:
                nxt |= q_trans[b][c]
                hit = hit or bool(q_emit[b, c])
            row_e.append(hit)
            nid = index.get(nxt)
            if nid is None:
                nid = len(index)
                if nid >= max_states:
                    return None
                index[nxt] = nid
                work.append(nxt)
            row_t.append(nid)
        trans_rows.append(row_t)
        emit_rows.append(row_e)
    return (
        np.asarray(trans_rows, dtype=np.int32),
        np.asarray(emit_rows, dtype=bool),
        np.asarray(end_rows, dtype=bool),
    )


def _collapsed(dfa: DFA) -> bool:
    """True when the approximation accepts essentially everything — a
    prefilter that confirms every row is pure overhead."""
    if dfa.always_match:
        return True
    return dfa.n_states == 1 and bool(dfa.match_end[0] or dfa.emit.all())


def approx_dfa(
    exact: DFA,
    width: int = DEFAULT_WIDTH,
    max_states: int = DEFAULT_MAX_STATES,
) -> ApproxResult:
    """Build the over-approximating prefilter automaton for ``exact``.

    Guarantee (property-tested in tests/test_prefilter.py): for every
    byte string ``v``, ``exact.search(v)`` implies ``result.dfa.search(v)``
    — the prefilter can only over-match, never miss."""
    if exact.always_match:
        return ApproxResult(None, "pattern always matches (no no-match case to clear)")
    if exact.n_states <= max_states:
        return ApproxResult(
            None, f"exact automaton already small ({exact.n_states} states)"
        )
    n_classes = exact.n_classes
    w = max(2, int(width))
    while w >= 2:
        block = _merge_partition(exact, w)
        k = int(block.max()) + 1
        # Quotient tables: per (block, class) the target-block set + OR-ed
        # outputs.
        q_trans: list[list[int]] = [[0] * n_classes for _ in range(k)]
        q_emit = np.zeros((k, n_classes), dtype=bool)
        q_end = np.zeros(k, dtype=bool)
        tgt_block = block[exact.trans]  # [S, C]
        for s in range(exact.n_states):
            b = int(block[s])
            row = tgt_block[s]
            qt = q_trans[b]
            for c in range(n_classes):
                qt[c] |= 1 << int(row[c])
            q_emit[b] |= exact.emit[s]
            q_end[b] = q_end[b] or bool(exact.match_end[s])
        tables = _subset_determinize(
            k, q_trans, q_emit, q_end, int(block[0]), n_classes, max_states
        )
        if tables is None:
            w //= 2  # narrower merge => fewer subset states; retry
            continue
        trans, emit, match_end = tables
        cand = DFA(
            trans=trans,
            emit=emit,
            match_end=match_end,
            classmap=exact.classmap.copy(),
            always_match=False,
        ).minimize()
        if _collapsed(cand):
            return ApproxResult(
                None, f"approximation collapsed to accept-all at width {w}"
            )
        return ApproxResult(cand, "", width=w)
    return ApproxResult(
        None, f"subset construction exceeds {max_states} states at every width"
    )
