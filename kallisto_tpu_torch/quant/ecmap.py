"""Dynamic equivalence-class discovery and counting (host side).

The reference maintains a mutable hash map Roaring-set -> EC id that worker
threads race to update under transfer locks (reference:
src/MinCollector.cpp:251-269, src/ProcessReads.cpp:1148-1161, 424-646).
Here the device reduces each read to its sorted set of distinct EC *rows*
(static index content rows); the host then:

1. deduplicates read keys per batch by their 128-bit device hash --
   thousands of unique keys per million reads,
2. resolves each new key once: intersect the row transcript lists with the
   reference's non-strict paired rules (src/MinCollector.cpp:160-218),
3. counts final per-read transcript sets, assigning EC ids in first-seen
   read order (deterministic, matching a single-threaded reference run).

Resolution (key -> transcript set) and counting (set -> EC id, += count)
are separate because filters (fragment-length position filter, strand
specificity) may shrink a read's set *after* resolution but *before*
counting, and only counted sets enter the EC map
(reference: ProcessReads.cpp:1091-1161).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

INT32_MAX = np.int32(2**31 - 1)


class _GrowCounts:
    """Growable int64 count vector with list-like [] access (the EC count
    table; reference: MinCollector::counts)."""

    def __init__(self):
        self._a = np.zeros(1024, np.int64)
        self.n = 0

    def append(self, v: int) -> None:
        if self.n == self._a.shape[0]:
            b = np.zeros(self._a.shape[0] * 2, np.int64)
            b[: self.n] = self._a
            self._a = b
        self._a[self.n] = v
        self.n += 1

    def __getitem__(self, i):
        return self._a[i]

    def __setitem__(self, i, v):
        self._a[i] = v

    def __len__(self):
        return self.n

    def array(self) -> np.ndarray:
        return self._a[: self.n].copy()


class EcResolver:
    def __init__(self, index):
        self.ec_ptr = index.ec_ptr
        self.ec_tx = index.ec_tx
        self.num_onlist = index.num_onlist
        self.has_offlist = index.num_onlist < index.num_trans
        # shades: targets named "<color>_shade_<variant>" from a --distinguish
        # index.  Detected from names exactly like the reference's load path
        # (src/KmerIndex.cpp:1506-1517).
        self.use_shade = False
        shade_ids = [
            i for i, n in enumerate(index.target_names) if "_shade_" in n
        ]
        if shade_ids:
            T = index.num_trans
            self.use_shade = True
            self._shade_mask = np.zeros(T, bool)
            self._shade_mask[shade_ids] = True
            self._shade_color = np.full(T, -1, np.int64)
            name_pos = {}
            for i, n in enumerate(index.target_names):
                name_pos.setdefault(n, i)
            for i in shade_ids:
                n = index.target_names[i]
                tname = n[: n.find("_shade_")]
                if tname in name_pos:
                    self._shade_color[i] = name_pos[tname]
        # dynamic EC map: key = sorted transcript-id int32 bytes -> ec id
        self.ecmapinv: Dict[bytes, int] = {}
        self.ec_sets: List[np.ndarray] = []
        self.counts = _GrowCounts()
        self.num_mapped = 0  # running total for progress reporting
        # cache: raw row-set key bytes -> resolved transcript set (or None)
        self._key_cache: Dict[bytes, Optional[np.ndarray]] = {}
        # cache: 128-bit device key hash -> resolved transcript set (or None)
        self._hash_cache: Dict[bytes, Optional[np.ndarray]] = {}

    # -- EC id management ------------------------------------------------

    def ec_id_for(self, u: np.ndarray) -> int:
        """Find or create the EC id for a sorted transcript set
        (reference: MinCollector::increaseCount, src/MinCollector.cpp:251)."""
        kb = u.astype(np.int32).tobytes()
        ec = self.ecmapinv.get(kb)
        if ec is None:
            ec = len(self.ec_sets)
            self.ecmapinv[kb] = ec
            self.ec_sets.append(u.astype(np.int32))
            self.counts.append(0)
        return ec

    def _row(self, r: int) -> np.ndarray:
        return self.ec_tx[self.ec_ptr[r] : self.ec_ptr[r + 1]]

    def _intersect_rows(self, rows: np.ndarray) -> np.ndarray:
        """Intersection of the transcript lists of non-empty EC rows.

        Content-equivalent to MinCollector::intersectECs
        (src/MinCollector.cpp:425-496): empty/wildcard rows never reach here
        (the device already dropped them) and duplicate rows are idempotent.
        With shades, every row is stripped of shade targets first; rows that
        become empty are skipped as wildcards (MinCollector.cpp:443-465).
        """
        if not self.use_shade:
            u = self._row(int(rows[0]))
            for r in rows[1:]:
                if u.shape[0] == 0:
                    break
                u = _intersect_sorted(u, self._row(int(r)))
            return u
        u = None
        for r in rows:
            row = self._row(int(r))
            row = row[~self._shade_mask[row]]
            if row.shape[0] == 0:
                continue
            u = row if u is None else _intersect_sorted(u, row)
            if u.shape[0] == 0:
                return u
        return u if u is not None else np.empty(0, np.int32)

    def _union_rows(self, rows: np.ndarray) -> np.ndarray:
        u = self._row(int(rows[0]))
        for r in rows[1:]:
            u = np.union1d(u, self._row(int(r)))
        return u

    # -- key resolution --------------------------------------------------

    def _resolve_key(
        self, key: np.ndarray, R: int, paired: bool, do_union: bool
    ) -> Optional[np.ndarray]:
        """Resolve one deduplicated read key -> transcript set (None = none).

        key layout: [rows1 (R), rows2 (R if paired), flags] where flags bit0 =
        mate1 had any k-mer hit, bit1 = mate2 did.  Implements the non-strict
        paired intersection (reference: MinCollector::intersectKmers,
        src/MinCollector.cpp:160-218): a mate with hits but an empty EC
        intersection vetoes the fragment; a mate with no hits at all defers
        to the other mate.
        """
        kb = key.tobytes()
        if kb in self._key_cache:
            return self._key_cache[kb]

        rows1 = key[:R]
        rows1 = rows1[rows1 != INT32_MAX]
        if paired:
            rows2 = key[R : 2 * R]
            rows2 = rows2[rows2 != INT32_MAX]
            flags = int(key[2 * R])
            hits1, hits2 = bool(flags & 1), bool(flags & 2)
        else:
            rows2 = np.empty(0, np.int32)
            flags = int(key[R])
            hits1, hits2 = bool(flags & 1), False

        u = self.resolve_rows(rows1, hits1, rows2, hits2, paired, do_union)
        self._key_cache[kb] = u
        return u

    def resolve_rows(
        self,
        rows1: np.ndarray,
        hits1: bool,
        rows2: np.ndarray,
        hits2: bool,
        paired: bool,
        do_union: bool = False,
    ) -> Optional[np.ndarray]:
        """Core intersection + non-strict pairing on explicit row lists."""
        combine = self._union_rows if do_union else self._intersect_rows
        u1 = combine(rows1) if rows1.shape[0] else np.empty(0, np.int32)
        u2 = combine(rows2) if rows2.shape[0] else np.empty(0, np.int32)

        u: Optional[np.ndarray]
        if u1.shape[0] == 0 and u2.shape[0] == 0:
            u = None
        elif u1.shape[0] == 0:
            u = u2 if not hits1 else None
        elif u2.shape[0] == 0:
            if paired:
                u = u1 if not hits2 else None
            else:
                u = u1
        else:
            if self.use_shade:
                # shades never participate in the cross-mate intersection
                # (MinCollector.cpp:194-195; no-op unless do_union)
                u1 = u1[~self._shade_mask[u1]]
                u2 = u2[~self._shade_mask[u2]]
            u = _intersect_sorted(u1, u2)
            if u.shape[0] == 0:
                u = None

        if u is not None and self.use_shade:
            # add back every seen shade whose color is in the intersection
            # (MinCollector.cpp:204-214: union of both mates' row unions,
            # restricted to shades of retained colors)
            seen = [self._row(int(r)) for r in rows1] + [
                self._row(int(r)) for r in rows2
            ]
            if seen:
                allv = np.unique(np.concatenate(seen))
                shades = allv[self._shade_mask[allv]]
                keep = shades[np.isin(self._shade_color[shades], u)]
                if keep.shape[0]:
                    u = np.union1d(u, keep).astype(np.int32)

        # off-list mask (u &= onlist_sequences, ProcessReads.cpp:1072);
        # a no-op until D-list support adds off-list pseudo-targets
        if u is not None and self.has_offlist:
            u = u[u < self.num_onlist]
        if u is not None and u.shape[0] == 0:
            u = None
        return u

    # -- batch processing ------------------------------------------------

    def resolve_batch_hashed(
        self,
        h128: np.ndarray,
        fetch_exemplars,
        R: int,
        paired: bool,
        do_union: bool = False,
    ) -> Tuple[np.ndarray, List[Optional[np.ndarray]]]:
        """Resolve a batch from device-computed 128-bit key hashes.

        Only 16 bytes/read cross the device->host link; the full row lists
        of first-seen keys are fetched via `fetch_exemplars(read_indices) ->
        key matrix [n, 2R+1 or R+1]`.  Returns (read_uidx [B] indices into
        uniq_sets, uniq_sets); entries of uniq_sets are sorted transcript-id
        arrays or None (fragment rejected).
        """
        hv = np.ascontiguousarray(h128).reshape(-1, 2)
        struct = hv.view([("a", "<i8"), ("b", "<i8")]).reshape(-1)
        uniq, first_idx, inverse = np.unique(
            struct, return_index=True, return_inverse=True
        )
        raw = uniq.tobytes()
        hkeys = [raw[16 * i : 16 * (i + 1)] for i in range(uniq.shape[0])]
        new_q = [qi for qi, kb in enumerate(hkeys) if kb not in self._hash_cache]
        if new_q:
            keys = fetch_exemplars(first_idx[new_q])
            for j, qi in enumerate(new_q):
                self._hash_cache[hkeys[qi]] = self._resolve_key(
                    keys[j], R, paired, do_union
                )
        uniq_sets = [self._hash_cache[kb] for kb in hkeys]
        return inverse.reshape(-1).copy(), uniq_sets

    def count_batch(
        self,
        final_idx: np.ndarray,
        final_sets: List[Optional[np.ndarray]],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Count one batch of resolved reads (in read order).

        final_idx: [B] per-read index into final_sets (entries mapping to
        None are unmapped).  Assigns EC ids to new transcript sets at their
        first counted read, in read order, then accumulates counts.
        Returns (read_ec [B] with -1 for unmapped, read_card [B]).
        """
        uniq_f, first_idx, inv_f = np.unique(
            final_idx, return_index=True, return_inverse=True
        )
        occ = np.bincount(inv_f, minlength=uniq_f.shape[0])
        ec_of = np.full(uniq_f.shape[0], -1, np.int64)
        card_of = np.zeros(uniq_f.shape[0], np.int64)
        for qi in np.argsort(first_idx, kind="stable"):
            s = final_sets[int(uniq_f[qi])]
            if s is None or s.shape[0] == 0:
                continue
            ec = self.ec_id_for(s)
            self.counts[ec] += int(occ[qi])
            self.num_mapped += int(occ[qi])
            ec_of[qi] = ec
            card_of[qi] = s.shape[0]
        return ec_of[inv_f], card_of[inv_f]

    # -- outputs ---------------------------------------------------------

    def counts_array(self) -> np.ndarray:
        return self.counts.array()

    def num_unique_reads(self) -> int:
        c = self.counts.array()
        card = np.array([s.shape[0] for s in self.ec_sets], np.int64)
        return int(c[card == 1].sum()) if c.shape[0] else 0


def _intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two sorted unique int arrays."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.empty(0, a.dtype)
    if a.shape[0] > b.shape[0]:
        a, b = b, a
    idx = np.searchsorted(b, a)
    idx[idx >= b.shape[0]] = b.shape[0] - 1
    return a[b[idx] == a]
