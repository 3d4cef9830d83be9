"""Per-read post-resolution filters that shrink a read's transcript set.

Both filters consult the per-(mosaic block, transcript) payload of the
first matched k-mer:

- FldPositionFilter: drop transcripts whose implied fragment overhangs the
  transcript end (reference: ProcessReads.cpp:1095-1136 +
  KmerIndex::findPosition, src/KmerIndex.cpp:2188-2292),
- StrandFilter: --fr/--rf strandedness and the FR defaults of single-cell
  technologies (reference: doStrandSpecificity, ProcessReads.cpp:61-124).

Filters run between key resolution and counting; only the final
(possibly shrunk) sets enter the dynamic EC map, as in the reference.
"""

from typing import List, Optional, Tuple

import numpy as np


class _PayloadLookup:
    """Sorted (block, transcript) -> payload-row lookup over the index's
    block payload CSR."""

    def __init__(self, index):
        self.k = index.k
        nb = index.bp_ptr.shape[0] - 1
        bp_block = np.repeat(np.arange(nb, dtype=np.int64), np.diff(index.bp_ptr))
        self.T1 = int(index.target_lens.shape[0]) + 1
        self.bp_key = bp_block * self.T1 + index.bp_tx  # ascending
        self.bp_pos = index.bp_pos
        self.bp_rstart = index.bp_rstart
        self.bp_rstop = index.bp_rstop
        self.bp_strand = index.bp_strand

    def find(self, block: np.ndarray, tx: np.ndarray):
        key = block.astype(np.int64) * self.T1 + tx
        pidx = np.searchsorted(self.bp_key, key)
        pidx_c = np.minimum(pidx, max(self.bp_key.shape[0] - 1, 0))
        found = (self.bp_key.shape[0] > 0) & (self.bp_key[pidx_c] == key)
        return pidx_c, found


def _expand(read_idx: np.ndarray, final_idx: np.ndarray, final_sets):
    """Expand (read, transcript) pairs for the selected reads.

    Returns (pair_read_sel_pos, tx, pair_off) where pair_off is the CSR
    offsets per selected read and pair_read_sel_pos indexes into read_idx.
    """
    cards = np.array(
        [0 if s is None else s.shape[0] for s in final_sets], np.int64
    )
    set_off = np.zeros(len(final_sets) + 1, np.int64)
    np.cumsum(cards, out=set_off[1:])
    flat = (
        np.concatenate([s for s in final_sets if s is not None and s.shape[0]])
        if set_off[-1]
        else np.empty(0, np.int64)
    )
    rcard = cards[final_idx[read_idx]]
    start = set_off[final_idx[read_idx]]
    pair_pos = np.repeat(np.arange(read_idx.shape[0]), rcard)
    excl = np.zeros(read_idx.shape[0], np.int64)
    np.cumsum(rcard[:-1], out=excl[1:])
    within = np.arange(pair_pos.shape[0], dtype=np.int64) - np.repeat(excl, rcard)
    tx = flat[np.repeat(start, rcard) + within].astype(np.int64)
    pair_off = np.zeros(read_idx.shape[0] + 1, np.int64)
    np.cumsum(rcard, out=pair_off[1:])
    return pair_pos, tx, pair_off


def _apply_keep(
    read_idx: np.ndarray,
    keep: np.ndarray,
    tx: np.ndarray,
    pair_off: np.ndarray,
    final_idx: np.ndarray,
    final_sets: List[Optional[np.ndarray]],
    local: dict,
) -> None:
    """Rewrite shrunk per-read sets into final_idx/final_sets (in place)."""
    n_keep = np.zeros(read_idx.shape[0], np.int64)
    np.add.at(n_keep, np.repeat(np.arange(read_idx.shape[0]),
                                np.diff(pair_off)), keep)
    changed = n_keep < np.diff(pair_off)
    for j in np.flatnonzero(changed):
        sl = slice(pair_off[j], pair_off[j + 1])
        sub = tx[sl][keep[sl]].astype(np.int32)
        kb = sub.tobytes()
        fi = local.get(kb)
        if fi is None:
            fi = len(final_sets)
            final_sets.append(sub if sub.shape[0] else None)
            local[kb] = fi
        final_idx[read_idx[j]] = fi


class FldPositionFilter:
    """Fragment-length position feasibility filter (single-overhang off)."""

    def __init__(self, index, fl: int):
        self.pl = _PayloadLookup(index)
        self.fl = fl
        self.target_lens = index.target_lens.astype(np.int64)

    def apply_one(
        self, u: np.ndarray, block: int, strand: bool, upos: int, rpos: int
    ) -> Optional[np.ndarray]:
        """Filter ONE transcript set (compact-path per-key application:
        keys carry (block, strand, upos/rpos rank), so every read sharing
        the key provably shares this exact filtered outcome)."""
        fi, fs = self.apply(
            np.zeros(1, np.int64), [u], np.ones(1, bool),
            np.array([block]), np.array([upos]), np.array([rpos]),
            np.array([strand], bool),
        )
        return fs[fi[0]]

    def apply(
        self,
        read_uidx: np.ndarray,
        uniq_sets: List[Optional[np.ndarray]],
        applies: np.ndarray,
        f_block: np.ndarray,
        f_upos: np.ndarray,
        f_rpos: np.ndarray,
        f_strand: np.ndarray,
    ) -> Tuple[np.ndarray, List[Optional[np.ndarray]]]:
        cards = np.array(
            [0 if s is None else s.shape[0] for s in uniq_sets], np.int64
        )
        sel = np.flatnonzero(applies & (cards[read_uidx] > 0))
        final_idx = read_uidx.copy()
        final_sets: List[Optional[np.ndarray]] = list(uniq_sets)
        if sel.size == 0:
            return final_idx, final_sets

        pair_pos, tx, pair_off = _expand(sel, read_uidx, uniq_sets)
        pair_read = sel[pair_pos]
        pidx, found = self.pl.find(f_block[pair_read], tx)

        raw = self.pl.bp_pos[pidx].astype(np.int64)
        trsense = (raw >> 31) == 0
        t0 = raw & 0x7FFFFFFF
        rstart = self.pl.bp_rstart[pidx].astype(np.int64)
        rstop = self.pl.bp_rstop[pidx].astype(np.int64)
        d = f_upos[pair_read].astype(np.int64)
        p = f_rpos[pair_read].astype(np.int64)
        csense = f_strand[pair_read]

        t_kmer = np.where(trsense, t0 + (d - rstart), t0 + (rstop - 1 - d))
        sense = trsense == csense
        x = np.where(sense, t_kmer - p + 1, t_kmer + self.pl.k + p)
        # missing payload -> (-1, sense=true), reference: KmerIndex.cpp:2207
        x = np.where(found, x, -1)
        sense = np.where(found, sense, True)
        keep = np.where(
            sense,
            x + self.fl <= self.target_lens[tx],
            x - self.fl >= 0,
        )
        _apply_keep(sel, keep, tx, pair_off, final_idx, final_sets, {})
        return final_idx, final_sets


class StrandFilter:
    """--fr/--rf strand-specificity (standard, non-comprehensive mode).

    For each mate with hits: intersect the read's set with the first
    matched k-mer's block set, then keep transcripts whose payload strand
    char agrees with the expected orientation (2 = ambiguous always kept).
    reference: doStrandSpecificity, ProcessReads.cpp:83-124.
    """

    def __init__(self, index, strand: str):
        assert strand in ("fr", "rf")
        self.pl = _PayloadLookup(index)
        self.strand = strand

    def _one_mate(
        self,
        expected_fw: bool,
        final_idx,
        final_sets,
        applies,
        f_block,
        f_strand,
        local: dict,
    ):
        cards = np.array(
            [0 if s is None else s.shape[0] for s in final_sets], np.int64
        )
        sel = np.flatnonzero(applies & (cards[final_idx] > 0))
        if sel.size == 0:
            return
        pair_pos, tx, pair_off = _expand(sel, final_idx, final_sets)
        pair_read = sel[pair_pos]
        pidx, found = self.pl.find(f_block[pair_read], tx)
        sense = self.pl.bp_strand[pidx]
        um_strand = f_strand[pair_read]
        keep = found & (
            ((um_strand == (sense == 1)) == expected_fw) | (sense == 2)
        )
        _apply_keep(sel, keep, tx, pair_off, final_idx, final_sets, local)

    def apply_one(
        self,
        u: np.ndarray,
        has1: bool, fb1: int, fs1: bool,
        has2: Optional[bool] = None, fb2: int = -1, fs2: bool = False,
    ) -> Optional[np.ndarray]:
        """Filter ONE transcript set (compact-path per-key application;
        same semantics as apply_pair on a single read)."""
        idx = np.zeros(1, np.int64)
        if has2 is None:
            fi, fs = self.apply_pair(
                idx, [u], np.array([has1]), np.array([fb1]), np.array([fs1])
            )
        else:
            fi, fs = self.apply_pair(
                idx, [u], np.array([has1]), np.array([fb1]), np.array([fs1]),
                np.array([has2]), np.array([fb2]), np.array([fs2]),
            )
        return fs[fi[0]]

    def apply_pair(
        self,
        read_uidx: np.ndarray,
        uniq_sets: List[Optional[np.ndarray]],
        has_hits1: np.ndarray,
        f_block1: np.ndarray,
        f_strand1: np.ndarray,
        has_hits2: Optional[np.ndarray] = None,
        f_block2: Optional[np.ndarray] = None,
        f_strand2: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, List[Optional[np.ndarray]]]:
        final_idx = read_uidx.copy()
        final_sets: List[Optional[np.ndarray]] = list(uniq_sets)
        local: dict = {}
        first_fw = self.strand == "fr"   # FR: mate 1 maps forward/sense
        self._one_mate(
            first_fw, final_idx, final_sets, has_hits1, f_block1, f_strand1, local
        )
        if has_hits2 is not None:
            second_fw = self.strand == "rf"
            self._one_mate(
                second_fw, final_idx, final_sets, has_hits2, f_block2, f_strand2,
                local,
            )
        return final_idx, final_sets
