"""Host (numpy) re-derivation of one read's EC rows.

Used for the rare reads whose distinct-EC-row count exceeds the device
result width (SideResult.overflow) -- the device truncates; the host
recomputes the full set.  Also serves as an independent oracle for tests.
"""

from typing import Tuple

import numpy as np

from ..index.kmers import canonicalize, pack_kmers


def host_side_rows(index, codes_row: np.ndarray, length: int) -> Tuple[np.ndarray, bool]:
    """Full sorted distinct non-empty EC rows for one read + has_hits flag."""
    k = index.k
    if length < k:
        return np.empty(0, np.int32), False
    km, valid = pack_kmers(codes_row[:length], k)
    canon, _ = canonicalize(km, k)
    canon = canon[valid]
    if canon.shape[0] == 0:
        return np.empty(0, np.int32), False
    idx = np.searchsorted(index.kmer_keys, canon)
    idx = np.minimum(idx, index.kmer_keys.shape[0] - 1)
    hit = index.kmer_keys[idx] == canon
    if not hit.any():
        return np.empty(0, np.int32), False
    rows = index.block_ec[index.kmer_block[idx[hit]]]
    rows = np.unique(rows[rows >= 0]).astype(np.int32)
    return rows, True
