"""Per-read pseudoalignment on the card: k-mer -> EC-row reduction.

Port of kallisto_tpu/ops/pseudoalign.py (the reference's per-read
KmerIndex::match + MinCollector::intersectECs, evaluated with "--no-jump"
semantics over every k-mer of every read).  Each read is reduced to the
set of distinct non-empty EC rows its k-mers touch, plus its first hit;
set intersection and EC numbering happen on the host (quant/ecmap.py).

Every device function here has two implementations behind one entry
point: a CUDA tensor goes to the hand-written kernel (ops/kernels.py,
csrc/*.cu) and a CPU tensor to the plain PyTorch version in this module.
The plain versions are the CPU path and the yardstick of the kernels.

Torch has no unsigned 64-bit shift or compare on the CPU, so the plain
versions keep 64-bit hashes as int64 bit patterns: logical right shifts
are masked arithmetic shifts and unsigned compares flip the sign bit.
"""

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.spans import span
from . import kernels

INT32_MAX = 2**31 - 1

_EMPTY_SLOT = np.uint64(0xFFFFFFFFFFFFFFFF)

# Fixed probe depth: buckets are sized (by raising p) to hold < 2^DEPTH
# entries, so the lower_bound below always terminates exactly.
_BUCKET_SEARCH_DEPTH = 6

# Padded layout budget: an index whose padded bucket rows (2^p * S * 16
# bytes) fit takes the padded layout, any other the bucketed one -- the
# JAX package's rule, so both packages pick the same layout.
_PADDED_BYTES_BUDGET = 1 << 30

_SIGN = -(2**63)


def _s64(x: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= (1 << 63) else x


_MIX_C1 = _s64(0xBF58476D1CE4E5B9)
_MIX_C2 = _s64(0x94D049BB133111EB)


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (bijective) over uint64 -- uniformizes the
    biologically-skewed 2-bit k-mer bit patterns for direct addressing."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (0 < s < 64)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned less-than of int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (wrapping multiplies)."""
    x = x ^ _lshr(x, 30)
    x = x * _MIX_C1
    x = x ^ _lshr(x, 27)
    x = x * _MIX_C2
    return x ^ _lshr(x, 31)


class ProbeLayout(NamedTuple):
    """Sorted-hash layout of the index k-mers (host side)."""

    mk: np.ndarray            # [N] uint64 mixed canonical k-mers, sorted
    order: np.ndarray         # [N] permutation from index order
    p: int                    # bucket bits
    bucket_start: np.ndarray  # [2^p + 1] int64
    counts: np.ndarray        # [2^p] per-bucket sizes


def probe_layout(index) -> ProbeLayout:
    mk = _mix64_np(index.kmer_keys)
    assert not (mk == _EMPTY_SLOT).any(), "hash collided with empty sentinel"
    order = np.argsort(mk)
    mk = mk[order]
    N = mk.shape[0]
    # pick bucket bits p: avg load ~0.25, grow until max bucket fits DEPTH
    p = min(max(int(np.ceil(np.log2(max(N, 2)))) + 2, 4), 27)
    while True:
        bid = (mk >> np.uint64(64 - p)).astype(np.int64)
        counts = np.bincount(bid, minlength=1 << p)
        if counts.max() < (1 << _BUCKET_SEARCH_DEPTH) or p >= 27:
            break
        p += 1
    if counts.max() >= (1 << _BUCKET_SEARCH_DEPTH):
        raise ValueError("k-mer hash bucket overflow; index too large")
    bucket_start = np.zeros((1 << p) + 1, np.int64)
    np.cumsum(counts, out=bucket_start[1:])
    return ProbeLayout(mk, order, p, bucket_start, counts)


class DeviceIndex(NamedTuple):
    """Index tables resident on the device, bucketed sorted-hash layout.

    k-mers are stored sorted by a bijective 64-bit mix of their canonical
    2-bit encoding; a direct-addressed bucket table over the top p hash
    bits narrows each query to < 64 keys that a fixed-depth lower_bound
    resolves.  kmer_hkeys holds the uint64 keys as int64 bit patterns."""

    kmer_hkeys: torch.Tensor    # [N] int64 (uint64 bits), unsigned-sorted
    bucket_start: torch.Tensor  # [2^p + 1] int32 hash-bucket boundaries
    kmer_uid: torch.Tensor      # [N] int32 (hash order)
    kmer_pos: torch.Tensor      # [N] int32
    kmer_fw: torch.Tensor       # [N] bool
    kmer_block: torch.Tensor    # [N] int32
    kmer_ec: torch.Tensor       # [N] int32 EC row, -1 = empty/wildcard
    # [ceil((NB+9)/8), 8] int32: block_ec padded to 8-wide rows (-1 pad);
    # the anchor kernel fetches a verified stretch's ECs as two rows
    block_ec8: torch.Tensor
    p: int                      # bucket bits
    # FLD position-filter threshold tables (None unless the run needs the
    # filter; see pos_filter_rank): per-block offsets, then the sorted
    # fl-independent bases, forward table then reverse table
    pf_ptr: Optional[torch.Tensor] = None   # [NB+1] int32
    pf_base: Optional[torch.Tensor] = None  # [2*NP] int32

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in self[:8]
        )

    @property
    def device(self) -> torch.device:
        return self.kmer_hkeys.device


class PaddedDeviceIndex(NamedTuple):
    """Index tables resident on the device, padded layout (small indexes).

    Each hash bucket is one fixed-width row of 2S int64 words (uint64 bit
    patterns): its S mixed keys in ascending order, _EMPTY_SLOT padded,
    then their S EC rows in the low 32 bits (2^32 - 1 = empty), so one row
    read resolves a query.  The payloads are in slot order b * S + j, -1
    (kmer_fw False) at empty slots.  Taken when 2^p * S * 16 bytes fit
    _PADDED_BYTES_BUDGET (the JAX package's PaddedDeviceIndex)."""

    bucket_rows: torch.Tensor  # [2^p, 2S] int64: S keys, then S EC rows
    kmer_uid: torch.Tensor     # [2^p * S] int32 (slot order)
    kmer_pos: torch.Tensor     # [2^p * S] int32
    kmer_fw: torch.Tensor      # [2^p * S] bool
    kmer_block: torch.Tensor   # [2^p * S] int32
    block_ec8: torch.Tensor    # [ceil((NB+9)/8), 8] int32 (see DeviceIndex)
    p: int                     # bucket bits
    pf_ptr: Optional[torch.Tensor] = None   # see DeviceIndex
    pf_base: Optional[torch.Tensor] = None

    @property
    def S(self) -> int:
        """Slots per bucket (a power of two)."""
        return int(self.bucket_rows.shape[1]) // 2

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in self[:6]
        )

    @property
    def device(self) -> torch.device:
        return self.bucket_rows.device


def cached_probe_layout(index) -> ProbeLayout:
    """probe_layout memoized on the index object: the argsort over the
    mixed keys is shared by every run on the same loaded index."""
    lay = getattr(index, "_probe_layout_cache", None)
    if lay is None:
        lay = probe_layout(index)
        index._probe_layout_cache = lay
    return lay


def pf_probe_depth(index) -> int:
    """Fixed binary-search depth for the FLD position-filter tables: enough
    steps for the largest block's threshold list."""
    cards = np.diff(index.bp_ptr)
    maxc = int(cards.max()) if cards.shape[0] else 0
    return max(int(np.ceil(np.log2(maxc + 1))), 1) if maxc else 1


def pos_tables_from_host(index):
    """Per-block sorted FLD-position-filter base tables (+ probe depth).

    The filter's keep decision for transcript t via the first-hit k-mer in
    block b is a threshold test on one per-read scalar (g- = upos - rpos
    for forward-mapping reads, g+ = upos + rpos for reverse), with
    thresholds base(b, t) -/+ fl where base does not depend on fl (see
    quant/filters.py FldPositionFilter, reference: ProcessReads.cpp:
    1094-1136 + KmerIndex::findPosition, src/KmerIndex.cpp:2174-2292).
    Sorting each block's bases lets a fixed-depth search compute the
    read's RANK among them; reads with equal (rows, block, strand, rank)
    share the filtered set, so the rank makes the filter a per-key one.

    Returns (pf_ptr [NB+1] int32, pf_base [2*NP] int32 fw||rv, depth).
    """
    NB = index.bp_ptr.shape[0] - 1
    raw = index.bp_pos.astype(np.int64)
    t0 = raw & 0x7FFFFFFF
    trsense = (raw >> 31) == 0
    lenT = index.target_lens[index.bp_tx].astype(np.int64)
    rstart = index.bp_rstart.astype(np.int64)
    rstop = index.bp_rstop.astype(np.int64)
    k = index.k
    # forward (csense=1): keep <=> g- <= base - fl
    base_fw = np.where(trsense, lenT - (t0 - rstart) - 1, t0 + rstop - 1 + k)
    # reverse (csense=0): keep <=> g+ >= base + fl
    base_rv = np.where(trsense, -(t0 - rstart) - k, t0 + rstop - lenT)
    blk = np.repeat(np.arange(NB, dtype=np.int64), np.diff(index.bp_ptr))
    lim = np.int64(2**31 - 1)
    fw = np.clip(base_fw, -lim, lim)[np.lexsort((base_fw, blk))]
    rv = np.clip(base_rv, -lim, lim)[np.lexsort((base_rv, blk))]
    return (
        index.bp_ptr.astype(np.int32),
        np.concatenate([fw, rv]).astype(np.int32),
        pf_probe_depth(index),
    )


def padded_shape(layout: ProbeLayout) -> Tuple[int, int]:
    """(M, S) of the padded layout: 2^p buckets of S = the next power of
    two of the largest bucket's count."""
    S = 1 << max(int(np.ceil(np.log2(max(int(layout.counts.max()), 1)))), 0)
    return 1 << layout.p, S


def device_index_from_host(index, device=None,
                           with_pos_tables: bool = False) -> "AnyDeviceIndex":
    """Put the index tables on `device` (default: the card; raises without
    one unless device='cpu').  with_pos_tables adds the FLD position-filter
    tables (pf_ptr, pf_base) that the position key column reads.  Returns
    a PaddedDeviceIndex when its bucket rows fit _PADDED_BYTES_BUDGET, else
    a DeviceIndex.  In a run (utils/spans.py) the host's gathers and casts
    are the span `index_upload.prep` (timings["index_prep_s"]), each
    table's before its copy."""
    from .. import resolve_device

    dev = resolve_device(device)
    with span("index_upload.prep", "index_prep_s"):
        layout = cached_probe_layout(index)
        order = layout.order
        # anchor-kernel invariant: block ids are unitig-major and
        # consecutive ascending with position, so a verified unitig stretch
        # maps to the contiguous block-id range [block(p_lo), block(p_hi)]
        bu = index.block_uid
        if bu.shape[0] > 1:
            assert ((np.diff(bu.astype(np.int64)) > 0)
                    | (np.diff(index.block_start.astype(np.int64)) > 0)
                    ).all(), \
                "mosaic blocks must be unitig-major, position-ascending"
        NB = index.block_ec.shape[0]
        nb8 = ((NB + 9) + 7) // 8
        be8 = np.full(nb8 * 8, -1, np.int32)
        be8[:NB] = index.block_ec
        kmer_block = index.kmer_block[order].astype(np.int32)
        kmer_ec = np.where(
            kmer_block >= 0, index.block_ec[np.maximum(kmer_block, 0)], -1
        ).astype(np.int32)

    def put(make) -> torch.Tensor:
        """The host array make() returns (its gathers and casts timed as
        the preparation) copied to the device."""
        with span("index_upload.prep", "index_prep_s"):
            a = np.ascontiguousarray(make())
        return torch.from_numpy(a).to(dev)

    pf_ptr = pf_base = None
    if with_pos_tables:
        with span("index_upload.prep", "index_prep_s"):
            ptr, base, _ = pos_tables_from_host(index)
        pf_ptr, pf_base = put(lambda: ptr), put(lambda: base)
    M, S = padded_shape(layout)
    if M * S * 16 <= _PADDED_BYTES_BUDGET:
        # only the N keys and payloads cross to the device; the padded
        # tables (up to 1 GiB of rows) are filled and scattered there
        mk = layout.mk

        def slots():
            bid = (mk >> np.uint64(64 - layout.p)).astype(np.int64)
            return bid * S + (np.arange(mk.shape[0], dtype=np.int64)
                              - layout.bucket_start[bid])

        flat = put(slots)
        at = flat // S * (2 * S) + flat % S
        rows = torch.full((M * 2 * S,), -1, dtype=torch.int64, device=dev)
        rows[at] = put(lambda: mk.view(np.int64))
        rows[at + S] = put(lambda: kmer_ec).to(torch.int64) & 0xFFFFFFFF

        def scatter(make, fill):
            v = put(make)
            out = torch.full((M * S,), fill, dtype=v.dtype, device=dev)
            out[flat] = v
            return out

        return PaddedDeviceIndex(
            bucket_rows=rows.view(M, 2 * S),
            kmer_uid=scatter(
                lambda: index.kmer_uid[order].astype(np.int32), -1),
            kmer_pos=scatter(
                lambda: index.kmer_pos[order].astype(np.int32), -1),
            kmer_fw=scatter(lambda: index.kmer_fw[order].astype(bool), False),
            kmer_block=scatter(lambda: kmer_block, -1),
            block_ec8=put(lambda: be8.reshape(nb8, 8)),
            p=int(layout.p),
            pf_ptr=pf_ptr,
            pf_base=pf_base,
        )
    return DeviceIndex(
        kmer_hkeys=put(lambda: layout.mk.view(np.int64)),
        bucket_start=put(lambda: layout.bucket_start.astype(np.int32)),
        kmer_uid=put(lambda: index.kmer_uid[order].astype(np.int32)),
        kmer_pos=put(lambda: index.kmer_pos[order].astype(np.int32)),
        kmer_fw=put(lambda: index.kmer_fw[order].astype(bool)),
        kmer_block=put(lambda: kmer_block),
        kmer_ec=put(lambda: kmer_ec),
        block_ec8=put(lambda: be8.reshape(nb8, 8)),
        p=int(layout.p),
        pf_ptr=pf_ptr,
        pf_base=pf_base,
    )


# either layout: every function that takes a device index reads it
# through lookup_kmers, the slot-ordered payloads and block_ec8
AnyDeviceIndex = Union[DeviceIndex, PaddedDeviceIndex]


class SideResult(NamedTuple):
    """Per-read pseudoalignment summary for one mate."""

    rows: torch.Tensor       # [B, R] int32 sorted distinct non-empty EC rows,
    #                          INT32_MAX padded
    n_rows: torch.Tensor     # [B] int32 number of distinct non-empty EC rows
    has_hits: torch.Tensor   # [B] bool any k-mer matched the index
    overflow: torch.Tensor   # [B] bool more distinct rows than R
    # first matched k-mer info (reference: findFirstMappingKmer,
    # ProcessReads.cpp:45; KmerIndex::mapPair, KmerIndex.cpp:1622)
    f_uid: torch.Tensor      # [B] int32 unitig of first hit (-1 if none)
    f_block: torch.Tensor    # [B] int32 mosaic block of first hit
    f_upos: torch.Tensor     # [B] int32 unitig k-mer position of first hit
    f_rpos: torch.Tensor     # [B] int32 read position of first hit
    f_strand: torch.Tensor   # [B] bool read maps forward along unitig
    rng: torch.Tensor        # [B] int32 last-hit pos - first-hit pos

    def to_numpy(self) -> "SideResult":
        """Host copy of every field."""
        return SideResult(*(t.cpu().numpy() for t in self))


# ------------------------------------------------------------ plain versions


def unpack_codes(packed: torch.Tensor, nmask: torch.Tensor, L: int) -> torch.Tensor:
    """[B, L/4] packed + [B, L/8] N bitmask -> [B, L] uint8 codes (4 = N)."""
    B = packed.shape[0]
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    c = (packed[:, :, None] >> shifts[None, None, :]) & 3
    c = c.reshape(B, -1)[:, :L]
    bit = torch.arange(8, dtype=torch.uint8, device=packed.device)
    nbit = ((nmask[:, :, None] >> bit[None, None, :]) & 1).reshape(B, -1)[:, :L]
    return torch.where(nbit == 1, torch.full_like(c, 4), c)


def rolling_canonical_kmers(codes: torch.Tensor, lens: torch.Tensor, k: int):
    """[B, L] codes -> (canon [B, W] int64, is_fw [B, W] bool, valid [B, W]
    bool), W = L - k + 1.  Each window's forward and reverse-complement
    k-mers are built directly over the window axis (k column steps)."""
    B, L = codes.shape
    W = L - k + 1
    c = (codes & 3).to(torch.int64)
    f = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    r = torch.zeros_like(f)
    for d in range(k):
        cd = c[:, d : d + W]
        f = (f << 2) | cd
        r = r | ((3 - cd) << (2 * d))
    bad = (codes >= 4).to(torch.int32)
    csum = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=codes.device),
         torch.cumsum(bad, dim=1, dtype=torch.int32)], dim=1,
    )
    window_bad = csum[:, k:] - csum[:, :W]
    pos = torch.arange(W, dtype=torch.int32, device=codes.device)
    valid = (window_bad == 0) & (pos[None, :] + k <= lens[:, None])
    is_fw = f <= r
    canon = torch.where(is_fw, f, r)
    return canon, is_fw, valid


def lookup_kmers(didx: AnyDeviceIndex, canon: torch.Tensor,
                 valid: torch.Tensor):
    """K-mer lookup in either layout -> (slot [..] int64, hit bool, ec
    int32); the plain version of kernel L (and of the probe inside kernels
    A, D, I, J and K).  Invalid windows are probed with canon 0 and never
    hit.  Padded: one row of the query's bucket; a match at j gives the
    slot b * S + j and the EC row from the row's second half, a miss the
    slot b * S (JAX's argmax of an all-false row).  Bucketed: the
    fixed-depth lower_bound inside the bucket."""
    q = mix64(torch.where(valid, canon, torch.zeros_like(canon)))
    b = _lshr(q, 64 - didx.p)
    if isinstance(didx, PaddedDeviceIndex):
        S = didx.S
        flat = didx.bucket_rows.reshape(-1)
        col = torch.arange(S, dtype=torch.int64, device=q.device)
        base = (b * (2 * S))[..., None]
        match = flat[base + col] == q[..., None]
        hit = valid & match.any(dim=-1)
        j = torch.argmax(match.to(torch.int8), dim=-1)
        # the matched entry's low 32 bits, as int32 (the mixed keys are
        # distinct, so at most one slot matches a key of the index)
        meta = flat[b * (2 * S) + S + j] & 0xFFFFFFFF
        ec = ((meta ^ 0x80000000) - 0x80000000).to(torch.int32)
        ec = torch.where(hit, ec, torch.full_like(ec, -1))
        return b * S + j, hit, ec
    lo = didx.bucket_start[b].to(torch.int64)
    n = didx.bucket_start[b + 1].to(torch.int64) - lo
    N = didx.kmer_hkeys.shape[0]
    for _ in range(_BUCKET_SEARCH_DEPTH):
        nz = n > 0
        half = n >> 1
        m = torch.clamp(lo + half, max=N - 1)
        go = _ult(didx.kmer_hkeys[m], q) & nz
        lo = torch.where(go, m + 1, lo)
        n = torch.where(go, n - half - 1, torch.where(nz, half, torch.zeros_like(n)))
    idx = torch.clamp(lo, max=N - 1)
    hit = valid & (didx.kmer_hkeys[idx] == q)
    ec = torch.where(hit, didx.kmer_ec[idx], torch.full_like(didx.kmer_ec[idx], -1))
    return idx, hit, ec


def packed_entries_plain(didx: "DeviceIndex") -> torch.Tensor:
    """The packed (key, EC row) entries of a bucketed index: [N, 2] int64,
    row i = (kmer_hkeys[i], kmer_ec[i]) in slot order, so that one 16-byte
    read gives a probed key and its EC row (kernel L's bucketed table)."""
    return torch.stack([didx.kmer_hkeys, didx.kmer_ec.to(torch.int64)],
                       dim=1).contiguous()


def lookup_kmers_packed_plain(didx: "DeviceIndex", ent: torch.Tensor,
                              canon: torch.Tensor, valid: torch.Tensor):
    """lookup_kmers's bucketed search over packed entries `ent`
    (packed_entries_plain): keys from ent[:, 0], a hit's EC row from
    ent[:, 1] of its slot.  Equal to lookup_kmers in every output."""
    q = mix64(torch.where(valid, canon, torch.zeros_like(canon)))
    b = _lshr(q, 64 - didx.p)
    lo = didx.bucket_start[b].to(torch.int64)
    n = didx.bucket_start[b + 1].to(torch.int64) - lo
    N = ent.shape[0]
    keys = ent[:, 0]
    for _ in range(_BUCKET_SEARCH_DEPTH):
        nz = n > 0
        half = n >> 1
        m = torch.clamp(lo + half, max=N - 1)
        go = _ult(keys[m], q) & nz
        lo = torch.where(go, m + 1, lo)
        n = torch.where(go, n - half - 1,
                        torch.where(nz, half, torch.zeros_like(n)))
    idx = torch.clamp(lo, max=N - 1)
    e = ent[idx]
    hit = valid & (e[..., 0] == q)
    ec = torch.where(hit, e[..., 1].to(torch.int32),
                     torch.full_like(idx, -1, dtype=torch.int32))
    return idx, hit, ec


def _pseudoalign_core(didx: AnyDeviceIndex, codes: torch.Tensor,
                      lens: torch.Tensor, k: int, max_rows: int) -> SideResult:
    canon, is_fw, valid = rolling_canonical_kmers(codes, lens, k)
    B, W = canon.shape
    R = min(max_rows, W)
    idx, hit, ec_row = lookup_kmers(didx, canon, valid)

    # distinct non-empty EC rows per read, sorted ascending: R rounds of
    # masked min-reduction along the window axis
    rows = torch.where(hit & (ec_row >= 0), ec_row,
                       torch.full_like(ec_row, INT32_MAX))
    big = torch.full_like(rows, INT32_MAX)
    prev = torch.full((B,), -1, dtype=torch.int32, device=codes.device)
    slots = []
    for _ in range(R):
        cur = torch.where(rows > prev[:, None], rows, big).amin(dim=1)
        slots.append(cur)
        prev = torch.where(cur != INT32_MAX, cur, prev)
    uniq = torch.stack(slots, dim=1)
    n_rows = (uniq != INT32_MAX).sum(dim=1).to(torch.int32)

    has_hits = hit.any(dim=1)
    overflow = ((rows > prev[:, None]) & (rows != INT32_MAX)).any(dim=1)

    # first matched k-mer (leftmost read position; window 0 when none)
    first = torch.argmax(hit.to(torch.int8), dim=1)
    bidx = torch.arange(B, device=codes.device)
    kidx = idx[bidx, first]
    f_strand = is_fw[bidx, first] == didx.kmer_fw[kidx]
    neg = torch.full((B,), -1, dtype=torch.int32, device=codes.device)
    f_uid = torch.where(has_hits, didx.kmer_uid[kidx], neg)
    f_block = torch.where(has_hits, didx.kmer_block[kidx], neg)
    f_upos = torch.where(has_hits, didx.kmer_pos[kidx], neg)
    f_rpos = torch.where(has_hits, first.to(torch.int32), neg)

    pos = torch.arange(W, dtype=torch.int32, device=codes.device)[None, :]
    maxpos = torch.where(hit, pos, torch.full_like(pos, -1)).amax(dim=1)
    minpos = torch.where(hit, pos, torch.full_like(pos, 2**30)).amin(dim=1)
    rng = torch.where(has_hits, maxpos - minpos, neg).to(torch.int32)

    return SideResult(
        rows=uniq.contiguous(), n_rows=n_rows, has_hits=has_hits,
        overflow=overflow, f_uid=f_uid, f_block=f_block, f_upos=f_upos,
        f_rpos=f_rpos, f_strand=f_strand, rng=rng,
    )


def pseudoalign_batch_packed_plain(didx, packed, nmask, lens, k: int, L: int,
                                   max_rows: int = 16) -> SideResult:
    """Plain PyTorch version of kernel A (any device; the CPU path)."""
    codes = unpack_codes(packed, nmask, L)
    return _pseudoalign_core(didx, codes, lens, k, max_rows)


def _hash_columns_128(cols) -> torch.Tensor:
    """Two 64-bit FNV/splitmix column hashes -> [B, 2] int64 (uint64 bits).

    Columns are int32 values sign-extended to 64 bits (JAX's
    astype(uint64) of an int32)."""
    B = cols[0].shape[0]
    dev = cols[0].device
    h1 = torch.full((B,), _s64(0xCBF29CE484222325), dtype=torch.int64, device=dev)
    h2 = torch.full((B,), _s64(0x9E3779B97F4A7C15), dtype=torch.int64, device=dev)
    m1 = _s64(0x100000001B3)
    m2 = _s64(0xC2B2AE3D27D4EB4F)
    for c in cols:
        cu = c.to(torch.int64)
        h1 = (h1 ^ cu) * m1
        h2 = (h2 + cu) * m2
        h2 = h2 ^ _lshr(h2, 29)
    h1 = h1 ^ _lshr(h1, 33)
    h2 = h2 * m1
    return torch.stack([h1, h2], dim=1)


class KeySpec(NamedTuple):
    """What a read key carries beyond its rows and hit/overflow flags.

    min_range > 1 adds per-mate veto bits (16/32) to the flags; strand_key
    (or the position column) adds each mate's first-hit (block, strand);
    pos_fl >= 0 adds the FLD position-filter rank column, searched to
    pos_depth steps.  With every option off this is the per-read key."""

    k: int = 0
    min_range: int = 0
    strand_key: bool = False
    pos_fl: int = -1
    pos_depth: int = 0

    @property
    def pos_key(self) -> bool:
        return self.pos_fl >= 0


def _pair_flags(s1: SideResult, s2: SideResult, k: int = 0,
                min_range: int = 0) -> torch.Tensor:
    """Hit/overflow flags, plus per-mate min_range veto bits (16/32) when a
    min_range filter is active (reference: MinCollector::intersectECs range
    check, MinCollector.cpp:497)."""
    fl = (
        s1.has_hits.to(torch.int32)
        + 2 * s2.has_hits.to(torch.int32)
        + 4 * s1.overflow.to(torch.int32)
        + 8 * s2.overflow.to(torch.int32)
    )
    if min_range > 1:
        v1 = s1.has_hits & (s1.rng + k < min_range)
        v2 = s2.has_hits & (s2.rng + k < min_range)
        fl = fl + 16 * v1.to(torch.int32) + 32 * v2.to(torch.int32)
    return fl


def _single_flags(s1: SideResult, k: int = 0, min_range: int = 0) -> torch.Tensor:
    fl = s1.has_hits.to(torch.int32) + 4 * s1.overflow.to(torch.int32)
    if min_range > 1:
        v1 = s1.has_hits & (s1.rng + k < min_range)
        fl = fl + 16 * v1.to(torch.int32)
    return fl


def pos_filter_rank(didx: AnyDeviceIndex, s: SideResult, fl: int,
                    depth: int) -> torch.Tensor:
    """Rank of a read's fragment coordinate among its first-hit block's
    position-filter thresholds (-1 for reads without hits): a fixed-depth
    binary search; upper and lower bound meet through the integer identity
    #{x <= t} = #{x < t + 1}.  Plain version of the rank kernel B computes
    in the same thread as the key."""
    NP = didx.pf_base.shape[0] // 2
    b = torch.clamp(s.f_block, min=0).to(torch.int64)
    lo0 = didx.pf_ptr[b]
    hi = didx.pf_ptr[b + 1]
    off = torch.where(s.f_strand, 0, NP)
    target = torch.where(
        s.f_strand,
        s.f_upos - s.f_rpos + fl,       # rank = #{base < g- + fl}
        s.f_upos + s.f_rpos - fl + 1,   # rank = #{base <= g+ - fl}
    )
    lo = lo0
    for _ in range(depth):
        cond = lo < hi
        mid = (lo + hi) >> 1
        v = didx.pf_base[torch.clamp(mid + off, max=2 * NP - 1).to(torch.int64)]
        right = cond & (v < target)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(cond & ~right, mid, hi)
    return torch.where(s.has_hits, lo - lo0, -1).to(torch.int32)


def pos_col_pair(didx: AnyDeviceIndex, s1: SideResult, s2: SideResult, fl: int,
                 depth: int) -> torch.Tensor:
    """Pair position column: the filter applies only when exactly one mate
    mapped (reference: ProcessReads.cpp:1094, `!paired || v1.empty() ||
    v2.empty()`); other pairs get -1 so their keys stay unsplit."""
    applies = s1.has_hits ^ s2.has_hits
    r1 = pos_filter_rank(didx, s1, fl, depth)
    r2 = pos_filter_rank(didx, s2, fl, depth)
    return torch.where(applies, torch.where(s1.has_hits, r1, r2), -1)


def key_columns(s1: SideResult, s2: Optional[SideResult], spec: KeySpec,
                didx: Optional[AnyDeviceIndex] = None):
    """(key columns in hash order, flag column): rows1, rows2 (paired),
    flags, then the [f_block, f_strand] tail of each mate when strand_key
    or the position column is on, then the position rank."""
    cols = [s1.rows[:, i] for i in range(s1.rows.shape[1])]
    sides = [s1]
    if s2 is not None:
        cols += [s2.rows[:, i] for i in range(s2.rows.shape[1])]
        sides.append(s2)
        flags = _pair_flags(s1, s2, spec.k, spec.min_range)
    else:
        flags = _single_flags(s1, spec.k, spec.min_range)
    cols.append(flags)
    if spec.strand_key or spec.pos_key:
        for s in sides:
            cols += [s.f_block, s.f_strand.to(torch.int32)]
    if spec.pos_key:
        if s2 is not None:
            cols.append(pos_col_pair(didx, s1, s2, spec.pos_fl, spec.pos_depth))
        else:
            cols.append(pos_filter_rank(didx, s1, spec.pos_fl, spec.pos_depth))
    return cols, flags


def key_hash_plain(s1: SideResult, s2: Optional[SideResult], spec: KeySpec,
                   didx: Optional[AnyDeviceIndex] = None):
    """Plain version of kernel B's key: (h [B, 2] int64, flags [B] int32)."""
    cols, flags = key_columns(s1, s2, spec, didx)
    return _hash_columns_128(cols), flags


def pair_fragment_lengths_plain(s1: SideResult, s2: SideResult, k: int) -> torch.Tensor:
    """mapPair fragment length, -1 when not inferable (reference:
    KmerIndex::mapPair, src/KmerIndex.cpp:1622-1693).  Block ids are
    global (unitig-major), so equal f_block implies the same unitig."""
    p1 = torch.where(s1.f_strand, s1.f_upos - s1.f_rpos, s1.f_upos + k + s1.f_rpos)
    p2 = torch.where(s2.f_strand, s2.f_upos - s2.f_rpos, s2.f_upos + k + s2.f_rpos)
    ok = (
        s1.has_hits & s2.has_hits
        & (s1.f_block == s2.f_block)
        & (s1.f_strand != s2.f_strand)
    )
    return torch.where(ok, (p1 - p2).abs(), torch.full_like(p1, -1)).to(torch.int32)


def read_keys_plain(s1: SideResult, s2: Optional[SideResult], k: int):
    """Plain PyTorch version of kernel B on the per-read key: (h [B, 2]
    int64, tl [B] int32 or None for single-end)."""
    h, _ = key_hash_plain(s1, s2, KeySpec())
    return h, None if s2 is None else pair_fragment_lengths_plain(s1, s2, k)


def key_histogram_plain(h: torch.Tensor, flags: torch.Tensor, K: int,
                        with_slots: bool = False):
    """Plain version of kernel E: dedup B read keys on h[:, 0] alone into
    the flat [K+1, 5] int64 table; with_slots also each read's row in it
    ([B] int32: the 0-based rank of its key's row, capped at K - 1 as JAX's
    _compact_read_slots caps its segment id), as (ck, slots).

    Row 0 is the meta row [n_uniq, n_fail = 0, 0, 0, 0]; rows 1..min(n_uniq,
    K) hold [h0, h1, occ, first_idx, flags] of each distinct key in
    ascending first_idx (read) order, the rest is zero.  Reads equal in h0
    share a key (h0 is already a hash of every key column); a key's row
    takes both hash words and its flags from its first read, found as the
    minimum of the payload idx * 128 + flags.  The anchor route writes its
    wave-2 count into n_fail afterwards (ops/anchor.py)."""
    B = h.shape[0]
    dev = h.device
    uniq, inv = torch.unique(h[:, 0], return_inverse=True)
    n = int(uniq.shape[0])
    pay = torch.arange(B, dtype=torch.int64, device=dev) * 128 + flags.to(torch.int64)
    firstpay = torch.full((n,), 2**63 - 1, dtype=torch.int64, device=dev)
    firstpay = firstpay.scatter_reduce(0, inv, pay, "amin")
    occ = torch.bincount(inv, minlength=n)
    order = torch.argsort(firstpay)
    first = (firstpay >> 7)[order]
    ck = torch.zeros((K + 1, 5), dtype=torch.int64, device=dev)
    ck[0, 0] = n
    m = min(n, K)
    rows = torch.stack(
        [h[first, 0], h[first, 1], occ[order], first, (firstpay & 127)[order]],
        dim=1,
    )
    ck[1 : m + 1] = rows[:m]
    if not with_slots:
        return ck
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, dtype=torch.int64, device=dev)
    return ck, torch.clamp(rank[inv], max=K - 1).to(torch.int32)


def unflatten_ck_host(arr: np.ndarray):
    """Host view of a flat key table: (uniq_h [K, 2] int64, occ int32,
    first_idx int32, flags int32, n_uniq int)."""
    meta, rows = arr[0], arr[1:]
    return (
        np.ascontiguousarray(rows[:, :2]),
        rows[:, 2].astype(np.int32),
        rows[:, 3].astype(np.int32),
        rows[:, 4].astype(np.int32),
        int(meta[0]),
    )


def ck_n_fail(arr: np.ndarray) -> int:
    """The anchor kernel's wave-2 read count from a key table's meta row
    (0 for other tables)."""
    return int(arr[0, 1])


def gather_exemplars_plain(idx: torch.Tensor, s1: SideResult,
                           s2: Optional[SideResult], spec: KeySpec) -> torch.Tensor:
    """Plain version of kernel F: the int32 key rows of reads `idx` in the
    layout the host resolver reads (quant/ecmap.py _resolve_key): rows1,
    rows2 (paired), flags with the veto bits, the [f_block, f_strand] tail
    per mate with strand_key or the position key, the [f_upos, f_rpos]
    tail per mate with the position key."""
    sides = [SideResult(*(t[idx] for t in s1))]
    if s2 is not None:
        sides.append(SideResult(*(t[idx] for t in s2)))
        flags = _pair_flags(sides[0], sides[1], spec.k, spec.min_range)
    else:
        flags = _single_flags(sides[0], spec.k, spec.min_range)
    cols = [s.rows for s in sides] + [flags[:, None]]
    if spec.strand_key or spec.pos_key:
        for s in sides:
            cols += [s.f_block[:, None], s.f_strand.to(torch.int32)[:, None]]
    if spec.pos_key:
        for s in sides:
            cols += [s.f_upos[:, None], s.f_rpos[:, None]]
    return torch.cat(cols, dim=1).to(torch.int32)


def gather_slim_plain(idx: torch.Tensor, s1: SideResult,
                      s2: SideResult) -> torch.Tensor:
    """Plain version of kernel F's slim layout (JAX pipeline.py
    _gather_pair_slim :466): [n, 5] int32 rows (rows1[:, 0], rows1[:, 1],
    rows2[:, 0], rows2[:, 1], has_hits1 + 2 has_hits2 + 4 overflow1 + 8
    overflow2) of the pair reads idx."""
    a = SideResult(*(t[idx] for t in s1))
    b = SideResult(*(t[idx] for t in s2))
    return torch.stack([a.rows[:, 0], a.rows[:, 1], b.rows[:, 0],
                        b.rows[:, 1], _pair_flags(a, b)], dim=1).to(torch.int32)


class LongResult(NamedTuple):
    """Per-read long-read pseudoalignment summary (JAX ops/pseudoalign.py
    LongResult).

    rows/n_rows/has_hits/overflow as SideResult with a wider row budget
    (R = min(64, W)); n_rows counts every distinct row, past R too.
    unmapped = valid k-mers without an index hit (the reference's
    match_long empty_count, evaluated exhaustively: --no-jump semantics,
    src/KmerIndex.cpp:1945-2172); groups = the ordered (unitig, EC row)
    groups of the read's hits (what MinCollector::modeECs scans), -2
    padded, with n_groups counting past G."""

    rows: torch.Tensor        # [B, R] int32 sorted distinct non-empty EC rows
    n_rows: torch.Tensor      # [B] int32
    has_hits: torch.Tensor    # [B] bool
    overflow: torch.Tensor    # [B] bool n_rows > R
    unmapped: torch.Tensor    # [B] int32
    groups: torch.Tensor      # [B, G] int32 EC row per group (-1 = empty EC)
    n_groups: torch.Tensor    # [B] int32
    g_overflow: torch.Tensor  # [B] bool n_groups > G

    def to_numpy(self) -> "LongResult":
        """Host copy of every field."""
        return LongResult(*(t.cpu().numpy() for t in self))


def pseudoalign_long_plain(didx, packed, nmask, lens, k: int, L: int,
                           max_rows: int = 64,
                           max_groups: int = 128) -> LongResult:
    """Plain PyTorch version of kernel J (JAX pseudoalign_long_packed,
    ops/pseudoalign.py:1082-1151): every window of every read is looked
    up; the distinct rows come from a sort and adjacent differences, the
    groups from a running maximum of hit positions (a hit opens a group
    when its unitig or EC row differs from the previous HIT's) and a
    scatter of each group's EC row to its index."""
    codes = unpack_codes(packed, nmask, L)
    canon, _, valid = rolling_canonical_kmers(codes, lens, k)
    del codes
    B, W = canon.shape
    R = min(max_rows, W)
    G = max_groups
    dev = canon.device
    idx, hit, ec_row = lookup_kmers(didx, canon, valid)
    del canon
    unmapped = (valid.sum(dim=1) - hit.sum(dim=1)).to(torch.int32)
    uid = torch.where(hit, didx.kmer_uid[idx], torch.full_like(ec_row, -1))
    del idx, valid

    rows = torch.where(hit & (ec_row >= 0), ec_row,
                       torch.full_like(ec_row, INT32_MAX))
    rows = torch.sort(rows, dim=1).values
    isnew = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev),
         rows[:, 1:] != rows[:, :-1]], dim=1) & (rows != INT32_MAX)
    uniq = torch.where(isnew, rows, torch.full_like(rows, INT32_MAX))
    uniq = torch.sort(uniq, dim=1).values[:, :R].contiguous()
    n_rows = isnew.sum(dim=1).to(torch.int32)
    del rows, isnew

    pos = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    hp = torch.where(hit, pos, torch.full_like(pos, -1))
    cm = torch.cummax(hp, dim=1).values
    prev_pos = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int64, device=dev), cm[:, :-1]],
        dim=1)
    del hp, cm
    has_prev = prev_pos >= 0
    pp = torch.clamp(prev_pos, min=0)
    prev_uid = torch.gather(uid, 1, pp)
    prev_row = torch.gather(ec_row, 1, pp)
    boundary = hit & (~has_prev | (uid != prev_uid) | (ec_row != prev_row))
    del prev_pos, has_prev, pp, prev_uid, prev_row, uid
    gid = torch.cumsum(boundary.to(torch.int64), dim=1) - 1
    n_groups = boundary.sum(dim=1).to(torch.int32)
    bidx = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    flat = torch.where(boundary & (gid < G), bidx * G + torch.clamp(gid, min=0),
                       torch.full_like(gid, B * G))
    groups = torch.full((B * G + 1,), -2, dtype=torch.int32, device=dev)
    groups = groups.scatter_(0, flat.reshape(-1),
                             ec_row.reshape(-1).to(torch.int32))
    groups = groups[: B * G].reshape(B, G)
    return LongResult(
        rows=uniq, n_rows=n_rows, has_hits=hit.any(dim=1),
        overflow=n_rows > R, unmapped=unmapped, groups=groups,
        n_groups=n_groups, g_overflow=n_groups > G,
    )


class BiasTables(NamedTuple):
    """Device tables for 5' hexamer extraction (bias correction)."""

    block_start: torch.Tensor  # [NB] int32 first k-mer pos of mosaic block
    block_end: torch.Tensor    # [NB] int32 exclusive end
    useq: torch.Tensor         # [sum len] uint8 unitig base codes
    useq_off: torch.Tensor     # [U+1] int64


def bias_tables_from_host(index, device=None) -> BiasTables:
    """The bias tables on `device` (default: the card; raises without one
    unless device='cpu'); uploaded only for --bias runs."""
    from .. import resolve_device

    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    # unitig_seq's storage runs to the next multiple of 8 bytes (zeros),
    # so that kernel H reads it as aligned 8-byte words; useq is the view
    # of its S bases
    seq = np.asarray(index.unitig_seq, np.uint8)
    S = int(seq.shape[0])
    padded = np.zeros(-(-S // 8) * 8, np.uint8)
    padded[:S] = seq
    return BiasTables(
        block_start=put(index.block_start, np.int32),
        block_end=put(index.block_end, np.int32),
        useq=put(padded, np.uint8)[:S],
        useq_off=put(index.unitig_seq_off, np.int64),
    )


def bias_hexamers_plain(bt: BiasTables, s1: SideResult, valid: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Plain PyTorch version of kernel H: per-read upstream hexamer id (or
    -1), from mate 1's first hit.

    reference: MinCollector::countBias getPreSeq (src/MinCollector.cpp:
    684-721): fragment-start context on the unitig, pre=2/post=4; the
    forward case reads the 6-mer reverse-complemented, the reverse case
    forward (hexamerToInt revcomp flag)."""
    pre, post = 2, 4
    blk = torch.clamp(s1.f_block, min=0).to(torch.int64)
    cstart = bt.block_start[blk]
    clen = bt.block_end[blk] - cstart
    pos = s1.f_upos - cstart
    p = s1.f_rpos
    base = bt.useq_off[torch.clamp(s1.f_uid, min=0).to(torch.int64)]
    fw_ok = s1.f_strand & (pos - p >= pre)
    rc_ok = (~s1.f_strand) & (clen - 1 - pos - p >= pre)
    start_fw = base + (s1.f_upos - p - pre)
    start_rc = base + (s1.f_upos + p + k - post)
    start = torch.where(fw_ok, start_fw, start_rc)
    start = torch.clamp(start, 0, bt.useq.shape[0] - 6)
    hex_fw = torch.zeros_like(s1.f_upos)
    hex_rc = torch.zeros_like(s1.f_upos)
    for m in range(6):
        c = bt.useq[start + m].to(torch.int32)
        hex_fw = hex_fw | ((3 - c) << (2 * m))       # revcomp read
        hex_rc = hex_rc | (c << (2 * (5 - m)))       # forward read
    ok = valid & s1.has_hits
    neg = torch.full_like(hex_fw, -1)
    return torch.where(ok & fw_ok, hex_fw,
                       torch.where(ok & rc_ok, hex_rc, neg))


# ------------------------------------------------------------ entry points


def bias_hexamers(bt: BiasTables, s1: SideResult, valid: torch.Tensor,
                  k: int) -> torch.Tensor:
    """5' hexamer id [B] int32 of each read (see bias_hexamers_plain).  On
    the card kernel H runs only as kernel B's epilogue, whose valid is mate
    2's has_hits: the launch takes mate 1 as both mates with `valid` as
    the second one's has_hits (its key and fragment length are dropped)."""
    if s1.f_block.is_cuda:
        return kernels.read_keys(s1, s1._replace(has_hits=valid), k,
                                 bias=bt)[2]
    return bias_hexamers_plain(bt, s1, valid, k)



def pseudoalign_batch_packed(didx: AnyDeviceIndex, packed: torch.Tensor,
                             nmask: torch.Tensor, lens: torch.Tensor,
                             k: int, L: int, max_rows: int = 16) -> SideResult:
    """One mate's packed batch -> SideResult.  R = min(max_rows, L - k + 1)
    where L is the batch's PADDED length (the row count is part of the read
    key)."""
    R = min(max_rows, L - k + 1)
    if packed.is_cuda:
        return SideResult(*kernels.pseudoalign_side(
            didx, packed, nmask, lens, k, L, R)[0])
    return pseudoalign_batch_packed_plain(didx, packed, nmask, lens, k, L, max_rows)


def pseudoalign_batch(didx: AnyDeviceIndex, codes: torch.Tensor,
                      lens: torch.Tensor, k: int,
                      max_rows: int = 16) -> SideResult:
    """[B, L] uint8 base codes (0-3; a code above 3 is an N and makes its
    windows invalid) with lens [B] int32 -> SideResult (JAX
    pseudoalign_batch, ops/pseudoalign.py:493): kernel A on unpacked codes
    for tensors on the card (two waves: the anchors verify whole reads,
    the covered-interval core takes the rest; anchor.codes_waves_plain is
    the same split in plain PyTorch), _pseudoalign_core on the CPU.  Any
    L >= k; R = min(max_rows, L - k + 1)."""
    L = int(codes.shape[1])
    if L < k:
        raise ValueError(f"reads of {L} columns have no {k}-mer window")
    if codes.is_cuda:
        return SideResult(*kernels.pseudoalign_codes(
            didx, codes, lens, k, min(max_rows, L - k + 1))[0])
    return _pseudoalign_core(didx, codes, lens, k, max_rows)


def pseudoalign_long_packed(didx: AnyDeviceIndex, packed: torch.Tensor,
                            nmask: torch.Tensor, lens: torch.Tensor, k: int,
                            L: int, max_rows: int = 64,
                            max_groups: int = 128) -> LongResult:
    """One packed batch of long reads -> LongResult: kernel J for tensors
    on the card, the plain version for tensors on the CPU.  L is the
    batch's padded length: R = min(max_rows, L - k + 1), G = max_groups."""
    if packed.is_cuda:
        R = min(max_rows, L - k + 1)
        return LongResult(*kernels.pseudoalign_long(
            didx, packed, nmask, lens, k, L, R, max_groups))
    return pseudoalign_long_plain(didx, packed, nmask, lens, k, L, max_rows,
                                  max_groups)


def read_keys(s1: SideResult, s2: Optional[SideResult], k: int,
              bias: Optional[BiasTables] = None):
    """(128-bit read keys [B, 2] int64, fragment lengths [B] int32 or None,
    5' hexamer ids [B] int32 or None): kernel B on the card, with bias
    (BiasTables) kernel H in the same launch; on the CPU read_keys_plain
    and bias_hexamers_plain (valid: mate 2's has_hits, or every
    single-end read)."""
    if s1.rows.is_cuda:
        return kernels.read_keys(s1, s2, k, bias=bias)
    h, tl = read_keys_plain(s1, s2, k)
    hx = None
    if bias is not None:
        valid = s2.has_hits if s2 is not None else torch.ones_like(
            s1.has_hits)
        hx = bias_hexamers_plain(bias, s1, valid, k)
    return h, tl, hx


def gather_exemplars(idx: torch.Tensor, s1: SideResult,
                     s2: Optional[SideResult], spec: KeySpec) -> torch.Tensor:
    """Key rows of first-seen keys' exemplar reads (see
    gather_exemplars_plain); idx may name any row of the SideResult,
    padding rows included."""
    if s1.rows.is_cuda:
        return kernels.gather_exemplars(idx, s1, s2, spec)
    return gather_exemplars_plain(idx, s1, s2, spec)


def gather_slim(idx: torch.Tensor, s1: SideResult,
                s2: SideResult) -> torch.Tensor:
    """Slim exemplar rows [n, 5] of pair reads (see gather_slim_plain)."""
    if s1.rows.is_cuda:
        return kernels.gather_slim(idx, s1, s2)
    return gather_slim_plain(idx, s1, s2)


def pair_key_hash(s1: SideResult, s2: SideResult) -> torch.Tensor:
    """128-bit key of (rows1, rows2, hit/overflow flags) per pair."""
    return read_keys(s1, s2, 0)[0]


def single_key_hash(s1: SideResult) -> torch.Tensor:
    return read_keys(s1, None, 0)[0]


def pair_fragment_lengths(s1: SideResult, s2: SideResult, k: int) -> torch.Tensor:
    return read_keys(s1, s2, k)[1]


def _need_pos_tables(spec: KeySpec, didx: Optional[AnyDeviceIndex]):
    """The compact key's CPU branch refuses what kernels.compact_keys
    refuses on the card: the position column without pos tables."""
    if spec.pos_key and (didx is None or didx.pf_ptr is None):
        raise ValueError("the position key column needs didx with pos tables")


def compact_pair_keys(s1: SideResult, s2: SideResult, max_keys: int = 16384,
                      k: int = 0, min_range: int = 0, strand_key: bool = False,
                      didx: Optional[AnyDeviceIndex] = None,
                      pos_fl: int = -1, pos_depth: int = 0,
                      with_slots: bool = False):
    """Per-batch key table of pairs, flat [max_keys+1, 5] int64.  With
    min_range/strand_key/pos_fl the key carries the filter inputs (veto
    bits, first-hit block+strand, position rank), so per-read filters
    become per-key operations on the host.  with_slots also returns each
    read's row in the table, as (ck, slots)."""
    spec = KeySpec(k, min_range, strand_key, pos_fl, pos_depth)
    if s1.rows.is_cuda:
        ck, slots, _, _ = kernels.compact_keys(s1, s2, spec, max_keys,
                                               with_slots, didx)
        return (ck, slots) if with_slots else ck
    _need_pos_tables(spec, didx)
    h, flags = key_hash_plain(s1, s2, spec, didx)
    return key_histogram_plain(h, flags, max_keys, with_slots)


def compact_single_keys(s1: SideResult, max_keys: int = 16384, k: int = 0,
                        min_range: int = 0, strand_key: bool = False,
                        didx: Optional[AnyDeviceIndex] = None,
                        pos_fl: int = -1,
                        pos_depth: int = 0) -> torch.Tensor:
    spec = KeySpec(k, min_range, strand_key, pos_fl, pos_depth)
    if s1.rows.is_cuda:
        return kernels.compact_keys(s1, None, spec, max_keys, didx=didx)[0]
    _need_pos_tables(spec, didx)
    h, flags = key_hash_plain(s1, None, spec, didx)
    return key_histogram_plain(h, flags, max_keys)


def pseudoalign_pair_compact_packed(didx: AnyDeviceIndex, p1, n1, l1, p2,
                                    n2, l2, k: int, L: int, max_rows: int = 16,
                                    max_keys: int = 16384, min_range: int = 0,
                                    strand_key: bool = False, pos_fl: int = -1,
                                    pos_depth: int = 0):
    """Steady-state pair step on bitmask batches (the route for batches
    with more Ns than the aux vector holds): kernel A on each mate, then
    the key table.  Returns (r1, r2, ck [max_keys+1, 5])."""
    r1 = pseudoalign_batch_packed(didx, p1, n1, l1, k, L, max_rows)
    r2 = pseudoalign_batch_packed(didx, p2, n2, l2, k, L, max_rows)
    ck = compact_pair_keys(r1, r2, max_keys, k, min_range, strand_key, didx,
                           pos_fl, pos_depth)
    return r1, r2, ck


def pseudoalign_single_compact_packed(didx: AnyDeviceIndex, p1, n1, l1, k: int,
                                      L: int, max_rows: int = 16,
                                      max_keys: int = 16384, min_range: int = 0,
                                      strand_key: bool = False,
                                      pos_fl: int = -1, pos_depth: int = 0):
    r1 = pseudoalign_batch_packed(didx, p1, n1, l1, k, L, max_rows)
    ck = compact_single_keys(r1, max_keys, k, min_range, strand_key, didx,
                             pos_fl, pos_depth)
    return r1, ck


def upload_batch(batch, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packed, nmask, lens) of a PackedBatch as tensors on `device`."""
    return (to_device(batch.packed, device, np.uint8),
            to_device(batch.nmask, device, np.uint8),
            to_device(batch.lens, device, np.int32))


def to_device(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on `device` (through pinned memory and an
    asynchronous copy on the card)."""
    dev = torch.device(device)
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t
