"""Long-read (--long) EC resolution: strict intersection with mode fallback.

reference: MinCollector::modeKmers / modeECs (src/MinCollector.cpp:121-157,
283-355) and the long-read branches of ReadProcessor::processBuffer
(src/ProcessReads.cpp:1051-1090, 1222-1235).  A read whose exhaustive k-mer
scan leaves more than threshold*len k-mers unmapped is "novel" and excluded
from counting (written to novel.fastq).

Batch resolution is vectorized for ONT-scale inputs: the strict
intersection runs once per DISTINCT row set (content-keyed cache shared
across batches), and the modeECs state machine advances all reads of a
batch simultaneously -- G lock-step iterations over [B]-wide numpy state
vectors instead of a per-read Python loop.

A copy of kallisto_tpu/quant/longread.py (host numpy; the port's kernel J
gives it the rows and groups), plus resolve_long_reads, the per-batch step
that quant and bus share.
"""

from typing import Callable, List, Optional, Tuple

import numpy as np

INT32_MAX = np.int32(2**31 - 1)


def mode_ecs(groups: np.ndarray, resolver) -> Optional[np.ndarray]:
    """Port of MinCollector::modeECs over the ordered group EC-row list.

    groups: int32 row ids in hit order (-1 = empty/wildcard EC group).
    Returns the winning EC content (sorted transcript ids) or None.
    State machine transcribed verbatim (including its quirks: the mode is
    only promoted when the *next* distinct EC is a singleton or the
    current candidate is flagged multi-mapping).  Scalar reference
    implementation; batches go through mode_ecs_batch below (parity
    pinned by tests/test_torch_longread.py).
    """
    n = groups.shape[0]
    if n == 0:
        return None
    # content equality == row-id equality (rows are content-deduplicated)
    mode = int(groups[0])
    found_nonempty = mode >= 0
    mode_multi = False
    last = mode
    mode_count = 0
    cur_count = 0
    for i in range(1, n):
        g = int(groups[i])
        if not found_nonempty:
            mode = g
            found_nonempty = g >= 0
            if found_nonempty and resolver._row(g).shape[0] == 1:
                mode_multi = True
        # every element here is already a distinct group boundary
        if g == last and g >= 0:
            cur_count += 1
        if g != last and g >= 0:
            card = resolver._row(g).shape[0]
            if cur_count > mode_count and (card == 1 or mode_multi):
                if card == 1:
                    mode_multi = False
                mode = last
                mode_count = cur_count
            cur_count = 0
            last = g
    if mode_count > 0 and mode >= 0:
        return resolver._row(mode)
    return None


def mode_ecs_batch(
    groups: np.ndarray,      # [B, G] ordered group rows (-2 pad)
    n_groups: np.ndarray,    # [B]
    row_card: np.ndarray,    # [NR] per-row transcript cardinality
) -> np.ndarray:
    """Vectorized modeECs: all B state machines advance in lock step.

    Returns [B] int64 winning row ids (-1 = no mode).  Exactly the scalar
    machine above with every scalar replaced by a [B] vector and each
    branch by a mask.
    """
    B, G = groups.shape
    if B == 0:
        return np.empty(0, np.int64)
    g0 = groups[:, 0].astype(np.int64)
    alive0 = n_groups > 0
    mode = np.where(alive0, g0, -1)
    found = alive0 & (g0 >= 0)
    mode_multi = np.zeros(B, bool)
    last = mode.copy()
    mode_count = np.zeros(B, np.int64)
    cur_count = np.zeros(B, np.int64)
    for i in range(1, G):
        if not (n_groups > i).any():
            break
        valid = n_groups > i
        g = groups[:, i].astype(np.int64)
        card_g = row_card[np.maximum(g, 0)]
        upd = valid & ~found
        mode = np.where(upd, g, mode)
        newfound = upd & (g >= 0)
        mode_multi = np.where(newfound & (card_g == 1), True, mode_multi)
        found = found | newfound
        eq = valid & (g == last) & (g >= 0)
        cur_count = cur_count + eq
        ne = valid & (g != last) & (g >= 0)
        promote = ne & (cur_count > mode_count) & ((card_g == 1) | mode_multi)
        mode_multi = np.where(promote & (card_g == 1), False, mode_multi)
        mode = np.where(promote, last, mode)
        mode_count = np.where(promote, cur_count, mode_count)
        cur_count = np.where(ne, 0, cur_count)
        last = np.where(ne, g, last)
    return np.where((mode_count > 0) & (mode >= 0), mode, -1)


def resolve_long_batch(
    rows: np.ndarray,        # [B, R] sorted distinct rows (INT32_MAX pad)
    groups: np.ndarray,      # [B, G] ordered group rows (-2 pad)
    n_groups: np.ndarray,    # [B]
    resolver,                # unmasked EcResolver (mask_offlist=False)
    num_onlist: int,
    cache: Optional[dict] = None,
) -> List[Optional[np.ndarray]]:
    """Per-read EC sets: intersect distinct rows; empty -> modeECs fallback;
    then the on-list mask (reference: modeKmers + ProcessReads.cpp:1072).

    cache maps rows-key bytes -> intersected (pre-mask) set, letting the
    strict intersection run once per distinct row set across batches."""
    B = rows.shape[0]
    if cache is None:
        cache = {}
    # one strict intersection per DISTINCT row set
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    uniq_sets: List[np.ndarray] = []
    for q in range(uniq.shape[0]):
        kb = uniq[q].tobytes()
        u = cache.get(kb)
        if u is None:
            rr = uniq[q]
            rr = rr[rr != INT32_MAX]
            u = (
                resolver._intersect_rows(rr) if rr.shape[0]
                else np.empty(0, np.int32)
            )
            cache[kb] = u
        uniq_sets.append(u)
    empty_q = np.array([s.shape[0] == 0 for s in uniq_sets], bool)
    need_mode = np.flatnonzero(empty_q[inverse])

    mode_row = np.full(B, -1, np.int64)
    if need_mode.size:
        row_card = np.diff(resolver.ec_ptr)
        mode_row[need_mode] = mode_ecs_batch(
            groups[need_mode], n_groups[need_mode], row_card
        )

    out: List[Optional[np.ndarray]] = []
    for r in range(B):
        u = uniq_sets[inverse[r]]
        if u.shape[0] == 0 and mode_row[r] >= 0:
            u = resolver._row(int(mode_row[r]))
        u = u[u < num_onlist]
        out.append(u if u.shape[0] else None)
    return out


def resolve_long_reads(
    h,                       # kernel J's LongResult, fetched to the host
    lens: np.ndarray,        # [B] read lengths
    threshold: float,
    resolver,                # unmasked EcResolver (mask_offlist=False)
    num_onlist: int,
    codes_of: Callable[[int], np.ndarray],  # read r -> its base codes
    cache: Optional[dict] = None,
    write_unset: bool = False,
) -> Tuple[List[Optional[np.ndarray]], np.ndarray, List[str]]:
    """One batch of long reads to the sets to count (JAX quant
    pipeline.py:1621-1654, sc/bus.py:1267-1301).  A read is novel when more
    than threshold * len of its k-mers are unmapped; it gets no set.
    Returns (sets, novel [B] bool, novel.fastq records): the records hold
    the novel reads, and under write_unset (quant) also the reads that
    resolved to no set; each is named by whether its set was empty
    (reference: ProcessReads.cpp:1794-1807)."""
    novel = h.unmapped > threshold * lens
    sets = resolve_long_batch(h.rows, h.groups, h.n_groups, resolver,
                              num_onlist, cache)
    out = novel
    if write_unset:
        out = novel | np.array([s is None for s in sets], bool)
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    records = []
    for r in np.flatnonzero(out).tolist():
        name = ("novel_disjointIntersect" if sets[r] is None
                else "novel_tooManyEmptyKmers")
        seqc = codes_of(r)[: int(lens[r])]
        records.append(f"@{name}\n{bytes(acgtn[seqc]).decode()}\n")
    return ([None if novel[r] else sets[r] for r in range(len(sets))], novel,
            records)
