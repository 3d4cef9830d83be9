"""Sequence-specific (hexamer) bias correction.

Read side: counts the 5' hexamer upstream of each counted fragment start on
its unitig (reference: MinCollector::countBias + hexamerToInt,
src/MinCollector.cpp:653-766) -- extraction happens on device
(ops.pseudoalign.read_keys with bias=: kernel H in kernel B's launch),
accumulation on host.

Model side: `update_eff_lens` recomputes bias-corrected effective lengths
from the current abundance estimates (reference: src/weights.cpp:81-218),
vectorized with numpy over all transcript positions at once.  Called from
the EM at iterations min_rounds and min_rounds+500
(reference: EMAlgorithm.h:113-116).
"""

from typing import Optional, Tuple

import numpy as np

MIN_ALPHA = 1e-8  # reference: src/weights.cpp:5
NUM_6MERS = 4096


class TranscriptHexamers:
    """Precomputed per-position hexamer ids for all targets.

    fw[j]: hexamer id at target position j read forward; rc[j]: reverse-
    complement hexamer at position j.  Flattened over all targets with
    tx_of[j] giving the owner, pos_of[j] the in-target offset; only
    positions with a full 6-mer inside the target are materialized.
    """

    def __init__(self, index):
        off = index.target_seq_off
        seq = index.target_seq.astype(np.int64)
        # only real targets carry sequences (D-list pseudo-targets do not)
        T = off.shape[0] - 1
        seqlens = (off[1:] - off[:-1]).astype(np.int64)
        n_hex = np.maximum(seqlens - 5, 0)
        self.seqlens = seqlens
        self.hex_ptr = np.concatenate([[0], np.cumsum(n_hex)]).astype(np.int64)
        total = int(self.hex_ptr[-1])
        fw = np.zeros(total, np.int64)
        rc = np.zeros(total, np.int64)
        self.tx_of = np.repeat(np.arange(T, dtype=np.int32), n_hex)
        self.pos_of = (
            np.arange(total, dtype=np.int64) - self.hex_ptr[self.tx_of]
        )
        # global start of each hexamer window in the concatenated seq
        gstart = off[self.tx_of] + self.pos_of
        for m in range(6):
            c = seq[gstart + m]
            fw |= c << (2 * (5 - m))
            rc |= (3 - c) << (2 * m)
        self.fw = fw
        self.rc = rc

    def ranges(self, means: np.ndarray, strand: Optional[str]):
        """Boolean masks over flattened positions for the fw and rc loops.

        fw loop: j in [0, max(seqlen - means_i - 6, 0))   (truncated int)
        rc loop: j in [bwlimit, seqlen - 6), bwlimit = max(means_i - 6, 0)
        (reference: src/weights.cpp:136-160)
        """
        fwlimit = np.maximum(
            self.seqlens.astype(np.float64) - means - 6.0, 0.0
        ).astype(np.int64)
        bwlimit = np.maximum(means - 6.0, 0.0).astype(np.int64)
        j = self.pos_of
        fw_mask = j < fwlimit[self.tx_of]
        rc_mask = (j >= bwlimit[self.tx_of]) & (
            j < (self.seqlens - 6)[self.tx_of]
        )
        if strand == "fr":
            rc_mask = np.zeros_like(rc_mask)
        elif strand == "rf":
            fw_mask = np.zeros_like(fw_mask)
        return fw_mask, rc_mask


def update_eff_lens(
    means: np.ndarray,          # [T] conditional mean fragment lengths
    bias5: np.ndarray,          # [4096] observed hexamer counts
    hx: TranscriptHexamers,
    target_lens: np.ndarray,    # [T] (pre-clip, as the reference compares)
    alpha: np.ndarray,          # [T] current abundances
    eff_lens: np.ndarray,       # [T] current effective lengths
    strand: Optional[str] = None,  # None | "fr" | "rf"
) -> Tuple[np.ndarray, np.ndarray]:
    """Bias-corrected effective lengths (reference: src/weights.cpp:101-218).

    Returns (biaslens [T], dbias5 [4096] = expected hexamer distribution).
    """
    strand_specific = strand in ("fr", "rf")
    T_seq = hx.seqlens.shape[0]
    full_eff, full_alpha = eff_lens, alpha
    target_lens = target_lens[:T_seq]
    alpha = alpha[:T_seq]
    eff_lens = eff_lens[:T_seq]
    means = means[:T_seq]
    active = (target_lens.astype(np.int64) >= means) & (alpha >= MIN_ALPHA)
    contrib = np.where(
        active,
        (1.0 if strand_specific else 0.5) * alpha / eff_lens,
        0.0,
    )
    fw_mask, rc_mask = hx.ranges(means, strand)
    w = contrib[hx.tx_of]

    dbias5 = np.zeros(NUM_6MERS, np.float64)
    np.add.at(dbias5, hx.fw[fw_mask], w[fw_mask])
    np.add.at(dbias5, hx.rc[rc_mask], w[rc_mask])

    bias_data_norm = float(bias5.sum())
    bias_alpha_norm = float(dbias5.sum())

    ratio = np.divide(
        bias5.astype(np.float64),
        dbias5,
        out=np.zeros(NUM_6MERS, np.float64),
        where=dbias5 > 0,
    )
    efflen = np.zeros(hx.seqlens.shape[0], np.float64)
    am = active[hx.tx_of]
    np.add.at(efflen, hx.tx_of[fw_mask & am], ratio[hx.fw[fw_mask & am]])
    np.add.at(efflen, hx.tx_of[rc_mask & am], ratio[hx.rc[rc_mask & am]])
    scale = (
        bias_alpha_norm / bias_data_norm
        if strand_specific
        else 0.5 * bias_alpha_norm / bias_data_norm
    )
    efflen = np.where(active, efflen * scale, 0.0)

    biaslens = np.where(efflen > means, efflen, eff_lens)
    if full_eff.shape[0] > T_seq:  # D-list pseudo-targets keep their lens
        biaslens = np.concatenate([biaslens, full_eff[T_seq:]])
    return biaslens, dbias5
