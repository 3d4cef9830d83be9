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

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import kernels

INT32_MAX = 2**31 - 1

_EMPTY_SLOT = np.uint64(0xFFFFFFFFFFFFFFFF)

# Fixed probe depth: buckets are sized (by raising p) to hold < 2^DEPTH
# entries, so the lower_bound below always terminates exactly.
_BUCKET_SEARCH_DEPTH = 6

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
    p: int                      # bucket bits

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in self[:7]
        )


def cached_probe_layout(index) -> ProbeLayout:
    """probe_layout memoized on the index object: the argsort over the
    mixed keys is shared by every run on the same loaded index."""
    lay = getattr(index, "_probe_layout_cache", None)
    if lay is None:
        lay = probe_layout(index)
        index._probe_layout_cache = lay
    return lay


def device_index_from_host(index, device=None) -> DeviceIndex:
    """Put the index tables on `device` (default: the card; raises without
    one unless device='cpu')."""
    from .. import resolve_device

    dev = resolve_device(device)
    layout = cached_probe_layout(index)
    order = layout.order
    kmer_block = index.kmer_block[order].astype(np.int32)
    kmer_ec = np.where(
        kmer_block >= 0, index.block_ec[np.maximum(kmer_block, 0)], -1
    ).astype(np.int32)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return DeviceIndex(
        kmer_hkeys=put(layout.mk.view(np.int64)),
        bucket_start=put(layout.bucket_start.astype(np.int32)),
        kmer_uid=put(index.kmer_uid[order].astype(np.int32)),
        kmer_pos=put(index.kmer_pos[order].astype(np.int32)),
        kmer_fw=put(index.kmer_fw[order].astype(bool)),
        kmer_block=put(kmer_block),
        kmer_ec=put(kmer_ec),
        p=int(layout.p),
    )


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


def lookup_kmers(didx: DeviceIndex, canon: torch.Tensor, valid: torch.Tensor):
    """Bucketed k-mer lookup -> (slot [..] int64, hit bool, ec int32)."""
    q = mix64(torch.where(valid, canon, torch.zeros_like(canon)))
    b = _lshr(q, 64 - didx.p)
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


def _pseudoalign_core(didx: DeviceIndex, codes: torch.Tensor,
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

    Columns are non-negative int32 values widened to int64."""
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


def _pair_flags(s1: SideResult, s2: SideResult) -> torch.Tensor:
    return (
        s1.has_hits.to(torch.int32)
        + 2 * s2.has_hits.to(torch.int32)
        + 4 * s1.overflow.to(torch.int32)
        + 8 * s2.overflow.to(torch.int32)
    )


def _single_flags(s1: SideResult) -> torch.Tensor:
    return s1.has_hits.to(torch.int32) + 4 * s1.overflow.to(torch.int32)


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
    """Plain PyTorch version of kernel B: (h [B, 2] int64, tl [B] int32 or
    None for single-end)."""
    if s2 is None:
        cols = [s1.rows[:, i] for i in range(s1.rows.shape[1])]
        return _hash_columns_128(cols + [_single_flags(s1)]), None
    cols = (
        [s1.rows[:, i] for i in range(s1.rows.shape[1])]
        + [s2.rows[:, i] for i in range(s2.rows.shape[1])]
        + [_pair_flags(s1, s2)]
    )
    return _hash_columns_128(cols), pair_fragment_lengths_plain(s1, s2, k)


# ------------------------------------------------------------ entry points


def pseudoalign_batch_packed(didx: DeviceIndex, packed: torch.Tensor,
                             nmask: torch.Tensor, lens: torch.Tensor,
                             k: int, L: int, max_rows: int = 16) -> SideResult:
    """One mate's packed batch -> SideResult.  R = min(max_rows, L - k + 1)
    where L is the batch's PADDED length (the row count is part of the read
    key)."""
    R = min(max_rows, L - k + 1)
    if packed.is_cuda:
        return SideResult(*kernels.pseudoalign_side(
            didx, packed, nmask, lens, k, L, R))
    return pseudoalign_batch_packed_plain(didx, packed, nmask, lens, k, L, max_rows)


def read_keys(s1: SideResult, s2: Optional[SideResult], k: int):
    """(128-bit read keys [B, 2] int64, fragment lengths [B] int32 or None)."""
    if s1.rows.is_cuda:
        return kernels.read_keys(s1, s2, k)
    return read_keys_plain(s1, s2, k)


def pair_key_hash(s1: SideResult, s2: SideResult) -> torch.Tensor:
    """128-bit key of (rows1, rows2, hit/overflow flags) per pair."""
    return read_keys(s1, s2, 0)[0]


def single_key_hash(s1: SideResult) -> torch.Tensor:
    return read_keys(s1, None, 0)[0]


def pair_fragment_lengths(s1: SideResult, s2: SideResult, k: int) -> torch.Tensor:
    return read_keys(s1, s2, k)[1]


def upload_batch(batch, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packed, nmask, lens) of a PackedBatch as tensors on `device`."""
    dev = torch.device(device)
    nb = dev.type == "cuda"

    def put(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
        if nb:
            t = t.pin_memory()
        return t.to(dev, non_blocking=nb)

    return (put(batch.packed, np.uint8), put(batch.nmask, np.uint8),
            put(batch.lens, np.int32))
