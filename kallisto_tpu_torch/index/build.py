"""Transcriptome index construction (host side, offline).

Produces the same *semantic* content as the reference's Bifrost-based index
(reference: src/KmerIndex.cpp:247-1168): the compacted de Bruijn graph over
all transcript k-mers, the per-unitig mosaic equivalence-class (EC) blocks,
and per-(block, transcript) position payloads -- but laid out as dense,
device-friendly flat arrays instead of hash maps + Roaring bitmaps:

- a sorted uint64 table of canonical k-mers, probed on device by vectorized
  binary search (replacing Bifrost's minimizer MPHF lookup,
  ext/bifrost/src/Search.tcc:105-140),
- per-k-mer (unitig id, position, orientation, mosaic-block id),
- mosaic blocks (reference: KmerIndex::PopulateMosaicECs, KmerIndex.cpp:1110)
  as interval tables pointing into a deduplicated CSR of sorted transcript-id
  rows (replacing Node/BlockArray/SparseVector),
- CSR payload of (transcript, position|sense) per block, for the
  fragment-length position filter (KmerIndex::findPosition).

The construction itself is vectorized numpy: adjacency via sorted-array
binary search, unitig chaining via simultaneous frontier stepping.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .kmers import pack_kmers, revcomp_kmers, canonicalize
from .sanitize import sanitize_transcripts
from ..io.fastx import BASE_CODE
from ..common import INDEX_FORMAT_VERSION


@dataclass
class TpuIndex:
    """Flat, device-friendly transcriptome index."""

    k: int
    target_names: List[str]
    target_lens: np.ndarray          # [T] uint32, pre-clip lengths
    num_onlist: int                  # = T when no D-list

    # sorted canonical k-mer table
    kmer_keys: np.ndarray            # [N] uint64, sorted
    kmer_uid: np.ndarray             # [N] int32 unitig id
    kmer_pos: np.ndarray             # [N] int32 k-mer position within unitig
    kmer_fw: np.ndarray              # [N] bool: canonical k-mer lies forward in unitig
    kmer_block: np.ndarray           # [N] int32 global mosaic-block id

    # mosaic EC blocks
    block_uid: np.ndarray            # [NB] int32
    block_start: np.ndarray          # [NB] int32 (k-mer positions, inclusive)
    block_end: np.ndarray            # [NB] int32 (exclusive)
    block_ec: np.ndarray             # [NB] int32 EC content-row id, -1 = empty (wildcard)

    # deduplicated EC content rows (sorted transcript ids per row)
    ec_ptr: np.ndarray               # [NR+1] int64
    ec_tx: np.ndarray                # [nnz] int32

    # per-block (transcript, pos|sense) payload, trid-sorted.  bp_rstart /
    # bp_rstop give the covering run's unitig k-mer interval so transcript
    # coordinates can be recovered anywhere in the block
    # (reference: KmerIndex::findPosition, src/KmerIndex.cpp:2188-2292)
    bp_ptr: np.ndarray               # [NB+1] int64
    bp_tx: np.ndarray                # [bnnz] int32
    bp_pos: np.ndarray               # [bnnz] uint32  (tpos | 0x80000000 if antisense;
    #                                   minimum over covering runs, matching
    #                                   SparseVector::get(tr).minimum())
    bp_rstart: np.ndarray            # [bnnz] int32 (run of the min-pos entry)
    bp_rstop: np.ndarray             # [bnnz] int32
    bp_strand: np.ndarray            # [bnnz] uint8: 1 = sense walk, 0 = antisense,
    #                                   2 = ambiguous (both) -- the SparseVector
    #                                   strand char (SparseVector.hpp:32)

    # unitigs
    unitig_nkmers: np.ndarray        # [U] int32 (#k-mers = length - k + 1)
    unitig_seq_off: np.ndarray       # [U+1] int64 offsets into unitig_seq
    unitig_seq: np.ndarray           # [sum len] uint8 base codes

    # sanitized target sequences (base codes 0..3), for hexamer bias
    # correction (reference: KmerIndex::loadTranscriptSequences used by
    # update_eff_lens, src/weights.cpp:101)
    target_seq_off: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    target_seq: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))

    # D-list (distinguishing flanking k-mers); empty when unused
    dlist_keys: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))

    aa: bool = False                 # built from amino acids (--aa, CFC space)
    format_version: int = INDEX_FORMAT_VERSION

    @property
    def num_trans(self) -> int:
        return len(self.target_names)

    @property
    def num_kmers(self) -> int:
        return int(self.kmer_keys.shape[0])

    @property
    def num_unitigs(self) -> int:
        return int(self.unitig_nkmers.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.block_uid.shape[0])

    @property
    def num_ec_rows(self) -> int:
        return int(self.ec_ptr.shape[0] - 1)

    def ec_row(self, row: int) -> np.ndarray:
        return self.ec_tx[self.ec_ptr[row] : self.ec_ptr[row + 1]]


def _kmer_string(canon: int, k: int) -> str:
    return "".join("ACGT"[(int(canon) >> (2 * (k - 1 - j))) & 3] for j in range(k))


def shaded_target_name(name: str) -> Tuple[str, str]:
    """Split "<color>_shade_<variant>" -> (color-name, variant); ("", "")
    when the name is not a shade (reference: shadedTargetName,
    src/KmerIndex.cpp:236-244)."""
    pos = name.find("_shade_")
    if pos < 0:
        return "", ""
    return name[:pos], name[pos + len("_shade_"):]


def _atoi(s: str) -> int:
    """C atoi: leading integer prefix, 0 if none."""
    i = 0
    neg = False
    if i < len(s) and s[i] in "+-":
        neg = s[i] == "-"
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    v = int(s[i:j])
    return -v if neg else v


def _parse_distinguish(fasta_paths: Sequence[str], k: int):
    """Read a --distinguish FASTA: names are integer "colors", optionally
    with a _shade_<variant> suffix (reference: BuildDistinguishingGraph,
    src/KmerIndex.cpp:413-496).  Sequences are NOT sanitized (the reference
    re-emits them raw); k-mers containing non-ACGT are simply skipped by
    the packing stage.

    Returns (seqs, seq_color, seq_shade [-1 if none], target_names,
    target_lens, ncolors).
    """
    from ..io.fastx import read_fasta

    seqs: List[str] = []
    seq_color: List[int] = []
    seq_variant: List[str] = []
    variants_set = set()
    max_color = 0
    for path in fasta_paths:
        for header, seq in read_fasta(path):
            name = header.split()[0] if header.split() else ""
            if not name:
                continue
            tname, variant = shaded_target_name(name)
            color = _atoi(tname if tname else name)
            if variant:
                variants_set.add(f"{color}_shade_{variant}")
            max_color = max(max_color, color)
            seqs.append(seq.upper())
            seq_color.append(color)
            seq_variant.append(f"{color}_shade_{variant}" if variant else "")
    ncolors = max_color + 1
    target_names = [str(i) for i in range(ncolors)]
    # shade targets follow the colors in std::set (lexicographic) order
    variants = sorted(variants_set)
    target_names += variants
    variant_id = {v: ncolors + i for i, v in enumerate(variants)}
    seq_shade = np.array(
        [variant_id[v] if v else -1 for v in seq_variant], np.int64
    )
    target_lens = np.full(len(target_names), k, np.uint32)  # dummy lengths
    return seqs, np.array(seq_color, np.int64), seq_shade, target_names, target_lens, ncolors


def _dlist_records(dlist_paths: Sequence[str], aa: bool):
    """Yield (name, seq) D-list records; with --aa each nucleotide record
    expands to its SIX comma-free-code frames (3 forward + 3 on the
    reverse complement), named records staying named and specials special
    (reference: the aa frame-translation prologue of DListFlankingKmers,
    src/KmerIndex.cpp:790-860)."""
    from ..io.fastx import read_fasta

    for path in dlist_paths:
        for header, seq in read_fasta(path):
            name = header.split()[0] if header.split() else ""
            if not aa:
                yield name, seq
                continue
            from ..utils.cfc import nt_to_cfc_str, revcomp_str

            rc = revcomp_str(seq)
            for src in (seq, rc):
                for frame in range(3):
                    yield name, nt_to_cfc_str(src[frame:])


def _dlist_collect(
    dlist_paths: Sequence[str], keys: np.ndarray, k: int, overhang: int = 1,
    aa: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Collect D-list k-mers (reference: KmerIndex::DListFlankingKmers,
    src/KmerIndex.cpp:682-1003).

    Named sequences contribute *flanking* k-mers: the unmapped k-mers
    immediately bordering each maximal graph-covered stretch (up to
    `overhang` on each side -- -D/--d-list-overhang, reference:
    src/main.cpp:126-129 -- with the reference's exact lb>=1 / ub+k<len
    guards).  Unnamed ("special") records contribute every k-mer.
    Returns (flank_canon, special_canon) as sorted unique uint64 arrays.
    Divergence from the reference: k-mers containing 1-3 non-ACGT bases
    are dropped here (the reference keeps them with bifrost's 2-bit
    coercion), and overhang k-mers are only taken at in-bounds window
    starts (the reference's trailing loop can read past the sequence end
    for overhang > 1); coerced/out-of-bounds k-mers cannot match any
    N-free read k-mer anyway.
    """
    flank: List[np.ndarray] = []
    special: List[np.ndarray] = []
    for name, seq in _dlist_records(dlist_paths, aa):
        s = seq.upper()
        if len(s) < k:
            continue
        codes = BASE_CODE[np.frombuffer(s.encode(), dtype=np.uint8)]
        km, valid = pack_kmers(codes, k)
        canon, _ = canonicalize(km, k)
        if name == "":
            special.append(canon[valid])
            continue
        idx = np.searchsorted(keys, canon)
        idx_c = np.minimum(idx, max(keys.shape[0] - 1, 0))
        mapped = valid & (
            keys[idx_c] == canon if keys.size else np.zeros_like(valid)
        )
        n = mapped.shape[0]
        # maximal mapped runs [a, b)
        d = np.diff(np.concatenate([[0], mapped.view(np.int8), [0]]))
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        take = []
        for a, b in zip(starts, ends):
            lb = a - 1
            for i in range(min(lb, overhang)):
                if valid[lb - i]:
                    take.append(canon[lb - i])
            if b > lb and b + k < len(s):
                for i in range(min(len(s) - b, overhang)):
                    if b + i < n and valid[b + i]:
                        take.append(canon[b + i])
        if take:
            flank.append(np.array(take, np.uint64))
    fl = (
        np.unique(np.concatenate(flank)) if flank else np.empty(0, np.uint64)
    )
    sp = (
        np.unique(np.concatenate(special)) if special else np.empty(0, np.uint64)
    )
    return fl, sp


def _concat_codes(seqs: Sequence[str]):
    """Concatenate sequences into one code vector with an 'N' separator so
    windows never straddle two sequences.  Returns (codes, starts [S+1])
    where sequence j occupies codes[starts[j] : starts[j+1] - 1]."""
    total = sum(len(s) for s in seqs) + len(seqs)
    codes = np.full(total, 4, np.uint8)
    starts = np.zeros(len(seqs) + 1, np.int64)
    off = 0
    for j, s in enumerate(seqs):
        b = BASE_CODE[np.frombuffer(s.encode(), dtype=np.uint8)]
        codes[off : off + b.shape[0]] = b
        off += b.shape[0] + 1
        starts[j + 1] = off
    return codes, starts


_STREAM_CHUNK = 1 << 23  # windows per vectorized chunk (64 MB of uint64)


def _stream_kmers(codes: np.ndarray, k: int):
    """Yield (window_start, canon, is_fw, valid) over all windows of the
    concatenated code vector, in fixed-size chunks (windows overlap chunk
    boundaries by re-reading k-1 codes, so every window appears exactly
    once)."""
    from .kmers import scan_canonical

    L = codes.shape[0]
    n = L - k + 1
    for lo in range(0, max(n, 0), _STREAM_CHUNK):
        hi = min(lo + _STREAM_CHUNK, n)
        canon, is_fw, valid = scan_canonical(codes[lo : hi + k - 1], k)
        yield lo, canon, is_fw, valid


class _KmerLookup:
    """Host-side hashed k-mer membership: the numpy twin of the device
    lookup (ops/pseudoalign.py lookup_kmers): splitmix64 mix ->
    direct-address bucket -> fixed-depth branchless binary search.  ~4x
    faster than np.searchsorted over the raw sorted table at 1e8 keys
    (bounded probes, bucket-local cache behavior)."""

    _DEPTH = 6

    def __init__(self, keys: np.ndarray):
        from ..ops.pseudoalign import _mix64_np

        self.keys = keys
        mk = _mix64_np(keys)
        self.order = np.argsort(mk)
        self.mk = mk[self.order]
        N = self.mk.shape[0]
        p = min(max(int(np.ceil(np.log2(max(N, 2)))) + 1, 4), 27)
        while True:
            bid = (self.mk >> np.uint64(64 - p)).astype(np.int64)
            counts = np.bincount(bid, minlength=1 << p)
            if counts.max(initial=0) < (1 << self._DEPTH) or p >= 27:
                break
            p += 1
        if counts.max(initial=0) >= (1 << self._DEPTH):
            raise ValueError("k-mer hash bucket overflow")
        self.p = p
        self.bucket_start = np.zeros((1 << p) + 1, np.int64)
        np.cumsum(counts, out=self.bucket_start[1:])

    def find(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (idx into the ORIGINAL sorted keys array, present)."""
        from ..ops.pseudoalign import _mix64_np

        mq = _mix64_np(q)
        b = (mq >> np.uint64(64 - self.p)).astype(np.int64)
        lo = self.bucket_start[b].copy()
        n = self.bucket_start[b + 1] - lo
        N = self.mk.shape[0]
        for _ in range(self._DEPTH):
            nz = n > 0
            half = n >> 1
            m = np.minimum(lo + half, N - 1)
            go = (self.mk[m] < mq) & nz
            lo = np.where(go, m + 1, lo)
            n = np.where(go, n - half - 1, np.where(nz, half, 0))
        idx = np.minimum(lo, max(N - 1, 0))
        present = (N > 0) & (self.mk[idx] == mq)
        return self.order[idx], present


def _collect_canonical_kmers(seqs: Sequence[str], k: int) -> np.ndarray:
    codes, _ = _concat_codes(seqs)
    parts = []
    for _, canon, _fw, valid in _stream_kmers(codes, k):
        parts.append(np.unique(canon[valid]))
    if not parts:
        return np.empty(0, np.uint64)
    return np.unique(np.concatenate(parts))


def _oriented_successors(
    lookup: "_KmerLookup", oriented: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each oriented k-mer, its de Bruijn successors among the graph
    k-mers.

    Returns (outdeg [M], succ_idx [M], succ_orient [M]); succ_* are valid only
    where outdeg == 1 (the only case unitig chaining needs).
    succ_orient is 0 when the successor k-mer equals its canonical form.
    """
    mask = np.uint64((1 << (2 * k)) - 1)
    outdeg = np.zeros(oriented.shape[0], np.int32)
    succ_idx = np.full(oriented.shape[0], -1, np.int64)
    succ_orient = np.zeros(oriented.shape[0], np.uint8)
    base = (oriented << np.uint64(2)) & mask
    for b in range(4):
        cand = base | np.uint64(b)
        canon, is_fw = canonicalize(cand, k)
        idx_c, present = lookup.find(canon)
        outdeg += present
        succ_idx = np.where(present, idx_c, succ_idx)
        succ_orient = np.where(present, np.where(is_fw, 0, 1).astype(np.uint8), succ_orient)
    return outdeg, succ_idx, succ_orient


def _build_unitigs(keys: np.ndarray, k: int):
    """Compact the k-mer de Bruijn graph into unitigs (maximal non-branching
    paths), vectorized: all chains advance one step per iteration.

    Equivalent in content to Bifrost's CompactedDBG::build + unitig
    compaction (ext/bifrost/src/CompactedDBG.tcc); orientation/order of the
    unitig list is our own deterministic convention.

    Returns (kmer_uid, kmer_pos, kmer_fw, unitig_nkmers, uc_ptr, uc_k,
    uc_o): flat per-unitig chains (uc_ptr offsets into uc_k/uc_o).
    """
    N = keys.shape[0]
    if N == 0:
        z32 = np.empty(0, np.int32)
        return (
            z32, z32, np.empty(0, bool), z32,
            np.zeros(1, np.int64), np.empty(0, np.int64), np.empty(0, np.uint8),
        )
    rc = revcomp_kmers(keys, k)
    lookup = _KmerLookup(keys)

    # orientation 0 walks the canonical k-mer forward, 1 walks its twin
    outdeg = np.empty((2, N), np.int32)
    succ_idx = np.empty((2, N), np.int64)
    succ_orient = np.empty((2, N), np.uint8)
    for o, arr in ((0, keys), (1, rc)):
        outdeg[o], succ_idx[o], succ_orient[o] = _oriented_successors(lookup, arr, k)

    def is_start(i: np.ndarray, o: np.ndarray) -> np.ndarray:
        # (i,o) starts a unitig iff no simple edge enters it: either its
        # reverse side branches (indeg != 1), or its unique predecessor's
        # forward side branches
        rev_deg = outdeg[1 - o, i]
        has_unique_pred = rev_deg == 1
        q = np.where(has_unique_pred, succ_idx[1 - o, i], 0)
        qo = np.where(has_unique_pred, succ_orient[1 - o, i], 0)
        pred_out = outdeg[1 - qo, q]
        return ~has_unique_pred | (pred_out != 1)

    all_i = np.arange(N, dtype=np.int64)
    starts = []
    for o in (0, 1):
        oo = np.full(N, o, np.int64)
        s = is_start(all_i, oo)
        starts.append(np.stack([all_i[s], oo[s]], axis=1))
    starts = np.concatenate(starts, axis=0)  # [S, 2] (kmer idx, orient)

    # simultaneous chain stepping; records (chain, step) visits
    S = starts.shape[0]
    visit_chain: List[np.ndarray] = []
    visit_kmer: List[np.ndarray] = []
    visit_orient: List[np.ndarray] = []

    # compacted frontier: only still-active chains are touched each step
    # (the active set shrinks fast; full-width masks would make long
    # unitigs O(S * max_len))
    ai = np.arange(S, dtype=np.int64)
    cur_i = starts[:, 0].copy()
    cur_o = starts[:, 1].copy()
    step = 0
    chain_len = np.zeros(S, np.int64)
    while ai.size:
        visit_chain.append(ai)
        visit_kmer.append(cur_i)
        visit_orient.append(cur_o)
        chain_len[ai] += 1
        # can we extend? need outdeg==1 here and indeg==1 at the successor
        can = outdeg[cur_o, cur_i] == 1
        ni = np.where(can, succ_idx[cur_o, cur_i], 0)
        no = np.where(can, succ_orient[cur_o, cur_i], 0)
        can &= outdeg[1 - no, ni] == 1
        # never extend a unitig into its own twin (immediate hairpin)
        can &= ni != cur_i
        # a successor that is itself a unitig start would mean a cycle of
        # simple edges; linear chains never hit one (their far end branches)
        ai = ai[can]
        cur_i = ni[can]
        cur_o = no[can]
        step += 1
        if step > N + 1:
            raise RuntimeError("unitig chaining failed to terminate")

    if visit_chain:
        vc = np.concatenate(visit_chain)
        vk = np.concatenate(visit_kmer)
        vo = np.concatenate(visit_orient)
    else:
        # purely cyclic graph (e.g. a repeat-only sequence): no starts at all
        vc = np.empty(0, np.int64)
        vk = np.empty(0, np.int64)
        vo = np.empty(0, np.uint8)
    # order visits by (chain, step): steps were appended in order, and within
    # a step chains are ascending, so a stable sort by chain yields (chain, step)
    order = np.argsort(vc, kind="stable")
    vk = vk[order]
    vo = vo[order]
    chain_ptr = np.zeros(S + 1, np.int64)
    np.cumsum(chain_len, out=chain_ptr[1:])

    # each linear unitig was traversed twice (once per direction); keep the
    # traversal whose (first kmer, orient) tuple is smaller than its
    # partner's start (= last kmer, flipped orientation)
    first_i = vk[chain_ptr[:-1]]
    first_o = vo[chain_ptr[:-1]]
    last_i = vk[chain_ptr[1:] - 1]
    last_o = vo[chain_ptr[1:] - 1]
    partner_i, partner_o = last_i, 1 - last_o
    keep = (first_i < partner_i) | ((first_i == partner_i) & (first_o < partner_o))

    kmer_uid = np.full(N, -1, np.int32)
    kmer_pos = np.full(N, -1, np.int32)
    kmer_fw = np.zeros(N, bool)

    # flat chain layout for the kept traversals (vectorized over all
    # unitigs: millions at human scale)
    kept = np.flatnonzero(keep)
    klen = chain_len[kept]
    uc_ptr = np.zeros(kept.shape[0] + 1, np.int64)
    np.cumsum(klen, out=uc_ptr[1:])
    total = int(uc_ptr[-1])
    gidx = _row_take(chain_ptr, kept, klen) if kept.size else np.empty(0, np.int64)
    uc_k = vk[gidx]
    uc_o = vo[gidx]
    uid_of = np.repeat(np.arange(kept.shape[0], dtype=np.int32), klen)
    pos_of = (np.arange(total, dtype=np.int64) - uc_ptr[uid_of]).astype(np.int32)
    kmer_uid[uc_k] = uid_of
    kmer_pos[uc_k] = pos_of
    kmer_fw[uc_k] = uc_o == 0

    # cycles of simple edges (no start): walk them with a scalar loop
    # (vanishingly rare in real transcriptomes)
    extra_k: List[np.ndarray] = []
    extra_o: List[np.ndarray] = []
    n_units = kept.shape[0]
    unassigned = np.flatnonzero(kmer_uid < 0)
    while unassigned.size:
        i0 = int(unassigned[0])
        uid = n_units + len(extra_k)
        ki_list, ko_list = [], []
        i, o = i0, 0
        while True:
            ki_list.append(i)
            ko_list.append(o)
            kmer_uid[i] = uid
            kmer_pos[i] = len(ki_list) - 1
            kmer_fw[i] = o == 0
            i2, o2 = int(succ_idx[o, i]), int(succ_orient[o, i])
            if kmer_uid[i2] >= 0:
                break
            i, o = i2, o2
        extra_k.append(np.array(ki_list, np.int64))
        extra_o.append(np.array(ko_list, np.uint8))
        unassigned = np.flatnonzero(kmer_uid < 0)

    if extra_k:
        uc_k = np.concatenate([uc_k] + extra_k)
        uc_o = np.concatenate([uc_o] + extra_o)
        uc_ptr = np.concatenate([
            uc_ptr,
            uc_ptr[-1] + np.cumsum([e.shape[0] for e in extra_k]),
        ])
    unitig_nkmers = np.diff(uc_ptr).astype(np.int32)
    return kmer_uid, kmer_pos, kmer_fw, unitig_nkmers, uc_ptr, uc_k, uc_o


def _unitig_sequences(keys: np.ndarray, uc_ptr, uc_k, uc_o, k: int):
    """Reconstruct unitig base-code sequences from the flat k-mer chains
    (vectorized: first k-mer expands to k bases, every later chain step
    appends its last base)."""
    U = uc_ptr.shape[0] - 1
    if U == 0:
        return np.zeros(1, np.int64), np.empty(0, np.uint8)
    rc_all = revcomp_kmers(keys, k)
    ov = np.where(uc_o == 0, keys[uc_k], rc_all[uc_k])
    nk = np.diff(uc_ptr)
    lens = nk + k - 1
    offs = np.zeros(U + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    seqpool = np.empty(int(offs[-1]), np.uint8)
    # head: k bases of each unitig's first k-mer
    head = ov[uc_ptr[:-1]]
    for j in range(k):
        seqpool[offs[:-1] + j] = (
            (head >> np.uint64(2 * (k - 1 - j))) & np.uint64(3)
        ).astype(np.uint8)
    # tail: last base of each non-first chain k-mer
    uid_of = np.repeat(np.arange(U, dtype=np.int64), nk)
    step = np.arange(uc_k.shape[0], dtype=np.int64) - uc_ptr[uid_of]
    tail = step > 0
    seqpool[offs[uid_of[tail]] + k - 1 + step[tail]] = (
        ov[tail] & np.uint64(3)
    ).astype(np.uint8)
    return offs, seqpool


def _transcript_runs(
    seqs: Sequence[str],
    k: int,
    keys: np.ndarray,
    kmer_uid: np.ndarray,
    kmer_pos: np.ndarray,
    kmer_fw: np.ndarray,
):
    """Walk every transcript through the graph, emitting coverage runs.

    A run corresponds to one TRInfo of the reference
    (reference: src/KmerIndex.cpp:1030-1080): a maximal stretch of
    consecutive transcript k-mers advancing along one unitig in one
    direction.  Returns arrays (run_uid, run_trid, run_start, run_stop,
    run_pos) where run_pos = transcript position of the run's first k-mer
    with bit 31 set when the walk is antisense.

    Vectorized over ALL transcripts at once: the sequences are concatenated
    with N separators (separator windows are invalid, so runs cannot cross
    transcripts) and streamed through the hashed k-mer lookup in large
    chunks; runs spanning chunk boundaries are carried over.
    """
    codes, tstarts = _concat_codes(seqs)
    lookup = _KmerLookup(keys)
    outs: List[List[np.ndarray]] = [[], [], [], [], []]
    # pending (possibly continuing) last run of the previous chunk:
    # [uid, strand, p0, p1, g0, valid]
    pend = None
    prev_tail = None  # (uid, strand, upos, valid) of the previous window

    def finalize(uids, strands, p0s, p1s, g0s, valids):
        keepm = valids.astype(bool)
        if not keepm.any():
            return
        uids, strands = uids[keepm], strands[keepm]
        p0s, p1s, g0s = p0s[keepm], p1s[keepm], g0s[keepm]
        trid = np.searchsorted(tstarts, g0s, side="right") - 1
        wpos = (g0s - tstarts[trid]).astype(np.uint32)
        outs[0].append(uids.astype(np.int64))
        outs[1].append(trid.astype(np.int64))
        outs[2].append(np.minimum(p0s, p1s))
        outs[3].append(np.maximum(p0s, p1s) + 1)
        outs[4].append(
            wpos | np.where(strands, 0, 0x80000000).astype(np.uint32)
        )

    for lo, canon, is_fw, valid in _stream_kmers(codes, k):
        idx, _present = lookup.find(canon)
        uid = kmer_uid[idx]
        upos = kmer_pos[idx].astype(np.int64)
        # walking forward in the unitig iff the transcript k-mer orientation
        # matches the orientation of the canonical k-mer within the unitig
        strand = is_fw == kmer_fw[idx]
        n = canon.shape[0]
        stepv = np.where(strand, 1, -1).astype(np.int64)
        brk = np.ones(n, bool)
        if n > 1:
            brk[1:] = (
                (uid[1:] != uid[:-1])
                | (strand[1:] != strand[:-1])
                | (upos[1:] != upos[:-1] + stepv[:-1])
                # N-containing windows (separators; --aa CFC Ns) break runs
                | ~valid[1:]
                | ~valid[:-1]
            )
        if prev_tail is not None:
            pu, ps, pp, pv = prev_tail
            brk[0] = not bool(
                valid[0] and pv and uid[0] == pu and strand[0] == ps
                and upos[0] == pp + (1 if ps else -1)
            )
        prev_tail = (uid[-1], strand[-1], upos[-1], valid[-1])

        rf = np.flatnonzero(brk)
        if rf.size == 0:
            # entire chunk continues the pending run
            if pend is not None:
                pend[3] = int(upos[-1])
            continue
        if not brk[0] and pend is not None:
            pend[3] = int(upos[rf[0] - 1])
        if pend is not None:
            finalize(*(np.array([x]) for x in pend))
            pend = None
        run_last = np.empty_like(rf)
        run_last[:-1] = rf[1:] - 1
        run_last[-1] = n - 1
        # hold back the chunk's final run (it may continue)
        pend = [
            int(uid[rf[-1]]), bool(strand[rf[-1]]),
            int(upos[rf[-1]]), int(upos[n - 1]),
            int(lo + rf[-1]), bool(valid[rf[-1]]),
        ]
        rf, run_last = rf[:-1], run_last[:-1]
        if rf.size:
            finalize(
                uid[rf], strand[rf], upos[rf], upos[run_last],
                lo + rf.astype(np.int64), valid[rf],
            )
    if pend is not None:
        finalize(*(np.array([x]) for x in pend))

    if not outs[0]:
        z = np.empty(0, np.int64)
        return z, z, z, z, np.empty(0, np.uint32)
    return (
        np.concatenate(outs[0]),
        np.concatenate(outs[1]),
        np.concatenate(outs[2]),
        np.concatenate(outs[3]),
        np.concatenate(outs[4]),
    )


def _build_blocks(
    num_unitigs: int,
    unitig_nkmers: np.ndarray,
    run_uid: np.ndarray,
    run_trid: np.ndarray,
    run_start: np.ndarray,
    run_stop: np.ndarray,
    run_pos: np.ndarray,
    max_ec_size: int,
):
    """Mosaic-EC block construction (reference: PopulateMosaicECs,
    src/KmerIndex.cpp:1110-1168) + EC-content deduplication.

    Fully vectorized over all unitigs at once (the reference loops per
    unitig in C++; a Python per-unitig loop would dominate human-scale
    builds): breakpoints, (run x block) coverage expansion, per-(block,
    transcript) payload dedup and EC-content row dedup are all global
    numpy sorts/segment reductions.

    Unitigs whose run count exceeds max_ec_size (when > 0) are discarded:
    their single block gets the empty/wildcard EC
    (reference: src/KmerIndex.cpp:1047-1097).
    """
    counts = np.bincount(run_uid, minlength=num_unitigs)
    capped = (
        (counts > max_ec_size) if max_ec_size > 0
        else np.zeros(num_unitigs, bool)
    )
    degenerate = (counts == 0) | capped
    live_run = ~degenerate[run_uid]
    ruid = run_uid[live_run]
    rtrid = run_trid[live_run]
    rstart = run_start[live_run]
    rstop = run_stop[live_run]
    rpos = run_pos[live_run]

    BIG = np.int64(int(unitig_nkmers.max(initial=0)) + 2)

    # ---- breakpoints per live unitig: unique (uid, pos) over run
    #      starts+stops --------------------------------------------------
    b_key = np.concatenate([ruid * BIG + rstart, ruid * BIG + rstop])
    b_key = np.unique(b_key)
    bu = b_key // BIG
    bpos = b_key % BIG
    # every unitig k-mer comes from some transcript, so runs tile each live
    # unitig exactly (reference asserts this too, src/KmerIndex.cpp:1132-1133)
    first_of_u = np.ones(bu.shape[0], bool)
    first_of_u[1:] = bu[1:] != bu[:-1]
    last_of_u = np.ones(bu.shape[0], bool)
    last_of_u[:-1] = bu[:-1] != bu[1:]
    assert (bpos[first_of_u] == 0).all()
    assert (bpos[last_of_u] == unitig_nkmers[bu[last_of_u]]).all()

    # live blocks: consecutive breakpoints within one unitig
    same = bu[1:] == bu[:-1]
    lb_uid = bu[:-1][same]
    lb_start = bpos[:-1][same]
    lb_end = bpos[1:][same]

    # merge with degenerate single blocks, unitig-major
    dg = np.flatnonzero(degenerate)
    all_uid = np.concatenate([lb_uid, dg])
    all_start = np.concatenate([lb_start, np.zeros(dg.shape[0], np.int64)])
    all_end = np.concatenate([lb_end, unitig_nkmers[dg].astype(np.int64)])
    is_dg = np.concatenate(
        [np.zeros(lb_uid.shape[0], bool), np.ones(dg.shape[0], bool)]
    )
    bo = np.argsort(all_uid, kind="stable")
    block_uid = all_uid[bo]
    block_start = all_start[bo]
    block_end = all_end[bo]
    block_dg = is_dg[bo]
    NB = block_uid.shape[0]

    # ---- (run x covered block) expansion ------------------------------
    # breakpoint rank of a (uid, pos) = global block id of the block
    # starting there; a run [s, e) covers the consecutive blocks from
    # rank(s) to rank(e) - 1
    live_keys = block_uid * BIG + block_start  # ascending (degenerates too)
    first_blk = np.searchsorted(live_keys, ruid * BIG + rstart)
    end_rank = np.searchsorted(live_keys, ruid * BIG + rstop)
    n_cover = end_rank - first_blk
    P = int(n_cover.sum())
    pair_run = np.repeat(np.arange(ruid.shape[0]), n_cover)
    excl = np.zeros(ruid.shape[0], np.int64)
    np.cumsum(n_cover[:-1], out=excl[1:])
    within = np.arange(P, dtype=np.int64) - excl[pair_run]
    pair_block = first_blk[pair_run] + within

    # ---- per-(block, transcript) payload dedup ------------------------
    # keep the MINIMUM raw pos (SparseVector.minimum() semantics) and mark
    # the strand char ambiguous (2) when both orientations occur
    p_tx = rtrid[pair_run]
    p_pos = rpos[pair_run]
    po = np.lexsort((p_pos, p_tx, pair_block))
    p_blk = pair_block[po]
    p_tx = p_tx[po]
    p_pos = p_pos[po]
    p_rs = rstart[pair_run][po]
    p_re = rstop[pair_run][po]
    g_first = np.ones(P, bool)
    g_first[1:] = (p_blk[1:] != p_blk[:-1]) | (p_tx[1:] != p_tx[:-1])
    grp = np.cumsum(g_first) - 1
    n_grp = int(grp[-1]) + 1 if P else 0
    bits = (p_pos >> np.uint32(31)).astype(np.uint8)
    any0 = np.zeros(n_grp, np.uint8)
    any1 = np.zeros(n_grp, np.uint8)
    np.maximum.at(any0, grp, (bits == 0).astype(np.uint8))
    np.maximum.at(any1, grp, (bits == 1).astype(np.uint8))
    strand = np.where(
        any0 & any1, 2, np.where(any0, 1, 0)
    ).astype(np.uint8)
    bp_tx = p_tx[g_first].astype(np.int32)
    bp_pos = p_pos[g_first].astype(np.uint32)
    bp_rstart = p_rs[g_first].astype(np.int32)
    bp_rstop = p_re[g_first].astype(np.int32)
    bp_strand = strand
    bp_blk = p_blk[g_first]
    bp_counts = np.bincount(bp_blk, minlength=NB)
    bp_ptr = np.zeros(NB + 1, np.int64)
    np.cumsum(bp_counts, out=bp_ptr[1:])

    # ---- EC content rows: dedup sorted transcript lists across blocks
    # via order-independent 128-bit content hashes (collision odds over
    # millions of rows ~1e-20); row ids in first-seen block order --------
    mt = _mix64_content(bp_tx.astype(np.uint64))
    h1 = np.zeros(NB, np.uint64)
    h2 = np.zeros(NB, np.uint64)
    np.add.at(h1, bp_blk, mt)
    with np.errstate(over="ignore"):
        np.add.at(h2, bp_blk, mt * mt | np.uint64(1))
    content = np.stack(
        [bp_counts.astype(np.uint64), h1, h2], axis=1
    )
    content[block_dg] = 0  # degenerate: empty/wildcard row (-1)
    cv = content.view([("c", "<u8"), ("a", "<u8"), ("b", "<u8")]).reshape(-1)
    uniq, ufirst, inv = np.unique(cv, return_index=True, return_inverse=True)
    # first-seen order over non-degenerate blocks
    live_u = np.flatnonzero(
        ~np.isin(np.arange(uniq.shape[0]), inv[block_dg])
        if block_dg.any() else np.ones(uniq.shape[0], bool)
    )
    order_u = live_u[np.argsort(ufirst[live_u], kind="stable")]
    row_of_u = np.full(uniq.shape[0], -1, np.int64)
    row_of_u[order_u] = np.arange(order_u.shape[0])
    block_ec = row_of_u[inv].astype(np.int32)
    block_ec[block_dg] = -1

    # representative block per row -> ec_ptr/ec_tx (cv is per-block in
    # block order, so ufirst[u] IS the first block carrying that content)
    rep_blk = ufirst[order_u].astype(np.int64)
    sizes = bp_counts[rep_blk] if order_u.shape[0] else np.empty(0, np.int64)
    ec_ptr = np.zeros(order_u.shape[0] + 1, np.int64)
    np.cumsum(sizes, out=ec_ptr[1:])
    if ec_ptr[-1] > 0:
        ec_tx = bp_tx[_row_take(bp_ptr, rep_blk, sizes)]
    else:
        ec_tx = np.empty(0, np.int32)

    return (
        block_uid.astype(np.int32),
        block_start.astype(np.int32),
        block_end.astype(np.int32),
        block_ec,
        ec_ptr,
        ec_tx,
        bp_ptr,
        bp_tx,
        bp_pos,
        bp_rstart,
        bp_rstop,
        bp_strand,
    )


def _mix64_content(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer for content hashing."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _row_take(bp_ptr: np.ndarray, rep_blk: np.ndarray, sizes: np.ndarray):
    """Vectorized gather of [bp_ptr[b], bp_ptr[b]+size) index ranges."""
    total = int(sizes.sum())
    out_run = np.repeat(np.arange(rep_blk.shape[0]), sizes)
    excl = np.zeros(rep_blk.shape[0], np.int64)
    np.cumsum(sizes[:-1], out=excl[1:])
    within = np.arange(total, dtype=np.int64) - excl[out_run]
    return bp_ptr[rep_blk][out_run] + within


def build_index(
    fasta_paths: Sequence[str],
    k: int = 31,
    make_unique: bool = False,
    max_ec_size: int = -1,
    dlist_paths: Optional[Sequence[str]] = None,
    dlist_overhang: int = 1,
    aa: bool = False,
    distinguish: bool = False,
) -> TpuIndex:
    """Build the index with the numpy build path (no native helpers)."""
    if k % 2 == 0 or k < 3 or k > 31:
        raise ValueError("k must be odd and in [3, 31]")
    return _build_index_impl(
        fasta_paths, k, make_unique, max_ec_size, dlist_paths,
        dlist_overhang, aa, distinguish,
    )


def _build_index_impl(
    fasta_paths, k, make_unique, max_ec_size, dlist_paths,
    dlist_overhang, aa, distinguish,
) -> TpuIndex:

    seq_color = seq_shade = None
    if distinguish:
        # sequences distinguished by (integer) name: one target per color
        # plus one per shade variant; no sanitization, no EC thresholding
        # (reference: BuildDistinguishingGraph, src/KmerIndex.cpp:413-570)
        (
            base_seqs, seq_color, seq_shade, base_names, base_lens, _ncolors,
        ) = _parse_distinguish(fasta_paths, k)
        max_ec_size = -1
        san = None
    else:
        san = sanitize_transcripts(fasta_paths, make_unique=make_unique, aa=aa)
        base_seqs = san.seqs
        base_names = san.names
        base_lens = np.array(san.lens, np.uint32)
    num_targets = len(base_names)
    keys = _collect_canonical_kmers(base_seqs, k)

    # -- D-list (reference: KmerIndex::DListFlankingKmers,
    #    src/KmerIndex.cpp:682-1003): flanking k-mers of masked sequences
    #    become k-length pseudo-targets past the on-list boundary; one
    #    "dummy" k-mer joins the graph so D-list hits resolve to a
    #    sentinel EC that vetoes the read by empty intersection.
    dl_all = np.empty(0, np.uint64)
    dummy_canon = None
    if dlist_paths:
        flank, special = _dlist_collect(
            dlist_paths, keys, k, overhang=dlist_overhang, aa=aa
        )
        in_graph_fl = np.isin(flank, keys)
        dl_all = np.unique(np.concatenate([flank[~in_graph_fl], special]))
        not_in_graph = dl_all[~np.isin(dl_all, keys)]
        if not_in_graph.size:
            dummy_canon = np.uint64(not_in_graph[0])
            keys = np.unique(np.concatenate([keys, not_in_graph[:1]]))
        elif dl_all.size:
            dummy_canon = np.uint64(dl_all[0])  # special k-mer already in graph

    (
        kmer_uid, kmer_pos, kmer_fw, unitig_nkmers, uc_ptr, uc_k, uc_o,
    ) = _build_unitigs(keys, k)
    n_unitigs = unitig_nkmers.shape[0]
    useq_off, useq = _unitig_sequences(keys, uc_ptr, uc_k, uc_o, k)

    walk_seqs = list(base_seqs)
    num_seqs = len(base_seqs)
    trid_remap = (
        seq_color.copy() if distinguish
        else np.arange(num_seqs, dtype=np.int64)
    )
    dl_names: List[str] = []
    if dl_all.size:
        dl_names = [f"d_list.{j}" for j in range(dl_all.shape[0])]
        # pseudo-targets whose k-mer is in the graph participate in EC
        # construction (the reference appends them to the tmp FASTA)
        extra_ids = []
        for j, c in enumerate(dl_all):
            idx = np.searchsorted(keys, np.uint64(c))
            if idx < keys.shape[0] and keys[idx] == np.uint64(c):
                walk_seqs.append(_kmer_string(int(c), k))
                extra_ids.append(num_targets + j)
        trid_remap = np.concatenate(
            [trid_remap, np.array(extra_ids, np.int64)]
        )

    runs = _transcript_runs(walk_seqs, k, keys, kmer_uid, kmer_pos, kmer_fw)
    if distinguish and (seq_shade >= 0).any():
        # a shaded sequence contributes each run TWICE: once under its color
        # and once under its shade target (reference: src/KmerIndex.cpp:551-559)
        widx = runs[1]
        is_shaded = (widx < num_seqs) & (seq_shade[np.minimum(widx, num_seqs - 1)] >= 0)
        sh = np.flatnonzero(is_shaded)
        runs = tuple(
            np.concatenate([a, a[sh]]) for a in runs
        )
        trids = trid_remap[runs[1]]
        trids[runs[1].shape[0] - sh.shape[0]:] = seq_shade[widx[sh]]
        runs = (runs[0], trids, *runs[2:])
    else:
        runs = (runs[0], trid_remap[runs[1]], *runs[2:])
    (
        block_uid, block_start, block_end, block_ec,
        ec_ptr, ec_tx, bp_ptr, bp_tx, bp_pos, bp_rstart, bp_rstop, bp_strand,
    ) = _build_blocks(n_unitigs, unitig_nkmers, *runs, max_ec_size)

    # per-kmer block id: blocks are emitted unitig-major with ascending
    # intervals, so one global searchsorted over (uid, start) keys assigns
    # every k-mer at once
    BIG = np.int64(int(unitig_nkmers.max(initial=0)) + 2)
    bkeys = block_uid.astype(np.int64) * BIG + block_start
    kq = kmer_uid.astype(np.int64) * BIG + kmer_pos
    kmer_block = (
        np.searchsorted(bkeys, kq, side="right").astype(np.int32) - 1
    )

    if dl_all.size and dummy_canon is not None:
        di = int(np.searchsorted(keys, dummy_canon))
        d_uid = kmer_uid[di]
        d_pos = kmer_pos[di]
        d_fw = kmer_fw[di]
        d_block = kmer_block[di]
        # special k-mers living on real unitigs still veto: point their
        # table entries at the dummy/sentinel block (reference: the final
        # match() D-list scan appends a dummy hit for them regardless of
        # graph membership, src/KmerIndex.cpp:1930-1940)
        for c in dl_all:
            idx = int(np.searchsorted(keys, np.uint64(c)))
            if idx < keys.shape[0] and keys[idx] == np.uint64(c):
                kmer_uid[idx] = d_uid
                kmer_pos[idx] = d_pos
                kmer_fw[idx] = d_fw
                kmer_block[idx] = d_block
        # remaining D-list k-mers (absent from the graph) enter the lookup
        # table pointing at the dummy block (reference: match() probes the
        # d_list set and pushes {um_dummy, pos})
        absent = dl_all[~np.isin(dl_all, keys)]
        if absent.size:
            ins = np.searchsorted(keys, absent)
            keys = np.insert(keys, ins, absent)
            kmer_uid = np.insert(kmer_uid, ins, d_uid)
            kmer_pos = np.insert(kmer_pos, ins, d_pos)
            kmer_fw = np.insert(kmer_fw, ins, d_fw)
            kmer_block = np.insert(kmer_block, ins, d_block)

    return TpuIndex(
        k=k,
        target_names=base_names + dl_names,
        target_lens=np.concatenate(
            [np.asarray(base_lens, np.uint32),
             np.full(len(dl_names), k, np.uint32)]
        ),
        num_onlist=num_targets,
        kmer_keys=keys,
        kmer_uid=kmer_uid,
        kmer_pos=kmer_pos,
        kmer_fw=kmer_fw,
        kmer_block=kmer_block,
        block_uid=block_uid,
        block_start=block_start,
        block_end=block_end,
        block_ec=block_ec,
        ec_ptr=ec_ptr,
        ec_tx=ec_tx,
        bp_ptr=bp_ptr,
        bp_tx=bp_tx,
        bp_pos=bp_pos,
        bp_rstart=bp_rstart,
        bp_rstop=bp_rstop,
        bp_strand=bp_strand,
        unitig_nkmers=unitig_nkmers,
        unitig_seq_off=useq_off,
        unitig_seq=useq,
        # per-target sequences only exist when targets map 1:1 to inputs
        # (distinguish colors aggregate many sequences; bias is unsupported)
        target_seq_off=(
            np.zeros(num_targets + 1, np.int64) if distinguish
            else np.concatenate(
                [[0], np.cumsum([len(s) for s in base_seqs])]
            ).astype(np.int64)
        ),
        target_seq=(
            BASE_CODE[
                np.frombuffer("".join(base_seqs).encode(), dtype=np.uint8)
            ]
            if base_seqs and not distinguish else np.empty(0, np.uint8)
        ),
        dlist_keys=dl_all,
        aa=aa,
    )
