"""Dynamic equivalence-class discovery and counting (host side).

The reference maintains a mutable hash map Roaring-set -> EC id that worker
threads race to update under transfer locks (reference:
src/MinCollector.cpp:251-269, src/ProcessReads.cpp:1148-1161, 424-646).
Here the device reduces each read to its sorted set of distinct EC *rows*
(static index content rows); the host then:

1. deduplicates read keys per batch by their 128-bit device hash --
   thousands of unique keys per million reads,
2. resolves each new key once: intersect the row transcript lists with the
   reference's non-strict paired rules (src/MinCollector.cpp:160-218) --
   a batch's new keys in one native call (quant/ecresolve.py), or key by
   key in Python for the modes with rules of their own (union, shades,
   --dfk-onlist, per-key filters),
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

from ..utils import spans
from .ecresolve import NativeKeySets

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

    def add_at(self, idx: np.ndarray, occ: np.ndarray) -> None:
        np.add.at(self._a, idx, occ)

    def array(self) -> np.ndarray:
        return self._a[: self.n].copy()


class _SortedCache128:
    """Batch-lookup map from 128-bit hashes to int64 values.

    Keys live as a V16 (memcmp-ordered void) sorted array; a whole
    batch's worth of lookups is one searchsorted.  Inserts re-sort
    (microseconds up to millions of keys, once per batch at most).
    """

    def __init__(self):
        self._keys = np.empty(0, "V16")
        self._vals = np.empty(0, np.int64)

    @staticmethod
    def _as_void(h: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(h).view("V16").reshape(-1)

    def lookup(self, h: np.ndarray):
        """h: [n, 2] int64 -> (values [n] int64, found [n] bool)."""
        q = self._as_void(h)
        if self._keys.shape[0] == 0:
            return np.empty(q.shape[0], np.int64), np.zeros(q.shape[0], bool)
        pos = np.searchsorted(self._keys, q)
        pos_c = np.minimum(pos, self._keys.shape[0] - 1)
        found = self._keys[pos_c] == q
        return self._vals[pos_c], found

    def insert(self, h: np.ndarray, vals: np.ndarray) -> None:
        q = self._as_void(h)
        keys = np.concatenate([self._keys, q])
        vv = np.concatenate([self._vals, vals.astype(np.int64)])
        o = np.argsort(keys, kind="stable")
        self._keys = keys[o]
        self._vals = vv[o]


class EcResolver:
    def __init__(self, index, mask_offlist: bool = True,
                 dfk_onlist: bool = False):
        self.ec_ptr = index.ec_ptr
        self.ec_tx = index.ec_tx
        self.num_onlist = index.num_onlist
        # mask_offlist=False keeps raw sets (the --aa 6-frame combiner needs
        # to see off-list members before masking, MinCollector.cpp:51-71)
        self.has_offlist = mask_offlist and index.num_onlist < index.num_trans
        # --dfk-onlist: D-list members are not intersected away; a fragment
        # touching the D-list keeps a sentinel target (= num_onlist) unless
        # ALL its members are off-list (reference: includeDList,
        # src/MinCollector.cpp:37-42,147-151,190-193; ProcessReads.cpp:1713-1722)
        self.dfk_onlist = dfk_onlist
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
        # 128-bit key hash -> EC id cache of the compact path (-1 = resolves
        # to no set); lookups and inserts are batch numpy operations
        self._ec_cache = _SortedCache128()
        # the native resolver of first-seen keys (quant/ecresolve.py),
        # built at the first batch whose modes it takes
        self._native: Optional[NativeKeySets] = None
        # optional per-key filter of the compact path, applied after
        # resolution: fn(u, flags, tail_cols, paired) -> set | None.  Compact
        # keys carry the filter inputs (min_range veto bits in flags; first-
        # hit block/strand and position columns in the tail), so filtering
        # per KEY equals filtering per read; per-read keys have no tail and
        # no veto bits, which makes it a no-op for them.
        self.compact_postfilter = None

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

        key layout: [rows1 (R), rows2 (R if paired), flags, tail...] where
        flags bit0 = mate1 had any k-mer hit, bit1 = mate2 did; the tail
        (compact keys only) feeds compact_postfilter.  Implements the
        non-strict paired intersection (reference: MinCollector::intersectKmers,
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
            tail = key[2 * R + 1 :]
            hits1, hits2 = bool(flags & 1), bool(flags & 2)
        else:
            rows2 = np.empty(0, np.int32)
            flags = int(key[R])
            tail = key[R + 1 :]
            hits1, hits2 = bool(flags & 1), False

        u = self.resolve_rows(rows1, hits1, rows2, hits2, paired, do_union)
        if self.compact_postfilter is not None:
            u = self.compact_postfilter(u, flags, tail, paired)
            if u is not None and u.shape[0] == 0:
                u = None
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
            if self.dfk_onlist and (
                (u1 >= self.num_onlist).any() or (u2 >= self.num_onlist).any()
            ):
                # includeDList: a shared sentinel keeps D-list-touching
                # fragments alive through the intersection
                # (reference: src/MinCollector.cpp:37-42)
                s = np.int32(self.num_onlist)
                u1 = np.union1d(u1, [s]).astype(u1.dtype)
                u2 = np.union1d(u2, [s]).astype(u2.dtype)
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
        # a no-op without D-list (off-list) pseudo-targets
        if u is not None and self.has_offlist:
            masked = u[u < self.num_onlist]
            if (self.dfk_onlist and masked.shape[0] != u.shape[0]
                    and masked.shape[0] > 0):
                # re-add the sentinel when a D-list member was stripped but
                # not every member was (reference: ProcessReads.cpp:1713-1722)
                masked = np.append(masked, np.int32(self.num_onlist))
            u = masked
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
            native = self._native_sets(do_union)
            if native is None:
                for j, qi in enumerate(new_q):
                    self._hash_cache[hkeys[qi]] = self._resolve_key(
                        keys[j], R, paired, do_union
                    )
            else:
                key_set, sets = native.resolve(keys, R, paired)
                spans.count("ec_native_keys", len(new_q))
                sets.append(None)  # key_set -1: no set
                for qi, s in zip(new_q, key_set.tolist()):
                    self._hash_cache[hkeys[qi]] = sets[s]
        uniq_sets = [self._hash_cache[kb] for kb in hkeys]
        return inverse.reshape(-1).copy(), uniq_sets

    def _native_sets(self, do_union: bool) -> Optional[NativeKeySets]:
        """The native key resolver, or None where a mode carries rules only
        the Python path applies: union, shades, --dfk-onlist's sentinel and
        a per-key filter (strand, FLD position, min_range veto bits)."""
        if (do_union or self.use_shade or self.dfk_onlist
                or self.compact_postfilter is not None):
            return None
        if self._native is None:
            self._native = NativeKeySets(self.ec_ptr, self.ec_tx,
                                         self.num_onlist, self.has_offlist)
        return self._native

    def _new_key_ecs_native(self, native: NativeKeySets, parts,
                            pid: np.ndarray, loc: np.ndarray,
                            paired: bool) -> np.ndarray:
        """EC ids (-1 = no set) of new keys at part pid / position loc, in
        global first-read order, by one native call.  A part with a slim
        fetch (rows 0-1 of each mate and the flags: the exemplar layout at
        R = 2) hands its keys over that way; only keys with a second row in
        a mate need the full exemplar.  Every part's keys are padded to the
        widest R.  New ECs are made per distinct set in first-key order,
        which numbers them as a key-by-key loop would."""
        got = []  # (positions, keys in the exemplar layout, R)
        for i, p in enumerate(parts):
            m = np.flatnonzero(pid == i)
            if not m.size:
                continue
            fslim = p[5] if paired and len(p) > 5 else None
            if fslim is not None:
                slim = fslim(loc[m])
                one = (slim[:, 1] == INT32_MAX) & (slim[:, 3] == INT32_MAX)
                got.append((m[one], slim[one], 2))
                m = m[~one]
                if not m.size:
                    continue
            got.append((m, p[3](loc[m]), p[4]))
        R = max(r for _, _, r in got)
        keys = np.full((pid.shape[0], 2 * R + 1 if paired else R + 1),
                       INT32_MAX, np.int32)
        for m, ex, r in got:
            keys[m, :r] = ex[:, :r]
            if paired:
                keys[m, R : R + r] = ex[:, r : 2 * r]
                keys[m, 2 * R] = ex[:, 2 * r]
            else:
                keys[m, R] = ex[:, r]
        key_set, sets = native.resolve(keys, R, paired)
        spans.count("ec_native_keys", pid.shape[0])
        ec_of_set = np.array([self.ec_id_for(u) for u in sets], np.int64)
        out = np.full(pid.shape[0], -1, np.int64)
        ok = key_set >= 0
        out[ok] = ec_of_set[key_set[ok]]
        return out

    def _new_key_ecs_python(self, parts, pid: np.ndarray, loc: np.ndarray,
                            paired: bool, do_union: bool) -> np.ndarray:
        """_new_key_ecs_native's result key by key through _resolve_key, for
        the modes the native call does not take."""
        sets: List[Optional[np.ndarray]] = [None] * pid.shape[0]
        for i, p in enumerate(parts):
            m = np.flatnonzero(pid == i)
            if m.size:
                for j, key in zip(m.tolist(), p[3](loc[m])):
                    sets[j] = self._resolve_key(key, p[4], paired, do_union)
        return np.array([-1 if u is None else self.ec_id_for(u)
                         for u in sets], np.int64)

    def process_compact_parts(
        self,
        parts,
        paired: bool,
        do_union: bool = False,
        return_key_ecs: bool = False,
    ):
        """Count a batch from one or more key histograms sharing one
        read-index space: a card key table, or host wave-1 keys plus the
        wave-2 slices' tables (see ops/hostprobe.py).

        parts: list of (uniq_h [K,2] int64, occ, first_idx -- GLOBAL read
        indices -- , exemplar_of, R) where exemplar_of(sel) -> [len(sel), W]
        int32 returns key content for positions `sel` into that part's own
        arrays and R is that part's per-mate row width (host wave-1 keys
        use R=16, device wave-2 keys may use a wider row budget), and an
        optional sixth entry slim_of(sel) -> [len(sel), 5] (the first two
        rows of each mate and the flags; None where the part has none).
        Keys are processed in global first-occurrence order, so EC numbering
        matches the single-stream per-read path exactly; the parts' key
        hashes live in disjoint namespaces (host vs device hash constants),
        so cross-part collisions cannot merge keys.
        """
        sizes = [p[0].shape[0] for p in parts]
        parts = [p for p in parts if p[0].shape[0]]
        if not parts:
            return [np.empty(0, np.int64)] * len(sizes) if return_key_ecs \
                else None
        hs = np.concatenate([np.ascontiguousarray(p[0]) for p in parts])
        occ = np.concatenate([np.asarray(p[1], np.int64) for p in parts])
        first = np.concatenate([np.asarray(p[2], np.int64) for p in parts])
        pid = np.concatenate(
            [np.full(p[0].shape[0], i, np.int32) for i, p in enumerate(parts)]
        )
        loc = np.concatenate(
            [np.arange(p[0].shape[0], dtype=np.int64) for p in parts]
        )
        order = np.argsort(first, kind="stable")
        h = np.ascontiguousarray(hs[order])
        vals, found = self._ec_cache.lookup(h)
        new_pos = np.flatnonzero(~found)
        spans.count("ec_cache_lookups", h.shape[0])
        spans.count("ec_cache_hits", h.shape[0] - new_pos.shape[0])
        if new_pos.size:
            with spans.span("resolve.new_keys", "resolve_new_s"):
                sel = order[new_pos]
                native = self._native_sets(do_union)
                if native is None:
                    newvals = self._new_key_ecs_python(
                        parts, pid[sel], loc[sel], paired, do_union)
                else:
                    newvals = self._new_key_ecs_native(
                        native, parts, pid[sel], loc[sel], paired)
                self._ec_cache.insert(h[new_pos], newvals)
                vals = vals.copy()
                vals[new_pos] = newvals
        occ_o = occ[order]
        m = vals >= 0
        self.counts.add_at(vals[m], occ_o[m])
        self.num_mapped += int(occ_o[m].sum())
        if return_key_ecs:
            # per-key EC ids back in concatenated-part order, split to the
            # CALLER's part list (empty parts get empty vectors) -- the
            # pseudobam fast path maps each read's key slot to its EC
            out = np.empty(vals.shape[0], np.int64)
            out[order] = vals
            res = []
            off = 0
            for n in sizes:
                res.append(out[off : off + n])
                off += n
            return res

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

    def set_ecs(self, ec_sets: List[np.ndarray], counts: np.ndarray) -> None:
        """Replace the EC table and its counts (the multi-process merge,
        parallel/multihost.py): EC i is ec_sets[i] with counts[i] reads."""
        self.ec_sets = [s.astype(np.int32) for s in ec_sets]
        self.ecmapinv = {s.tobytes(): i for i, s in enumerate(self.ec_sets)}
        self.counts = _GrowCounts()
        for c in counts:
            self.counts.append(int(c))
        self.num_mapped = int(np.sum(counts))

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
