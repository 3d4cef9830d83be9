"""Two-wave anchor pseudoalignment of uniform-length turbo batches.

Port of kallisto_tpu/ops/anchor.py.  Kernel D (ops/turbo.py) looks up
every k-mer window of every read; the reference resolves most reads with a
handful of lookups by jumping along unitig stretches (src/KmerIndex.cpp:
1776-1887).  The anchor evaluation is the data-parallel form of that jump:

wave 1 -- look up n_anchors windows per read, w_j = (wlast * j) //
(n_anchors - 1) with wlast = max(rlen - k, 0), so consecutive anchors are
at most k apart.  If every anchor hits one unitig on one strand at exactly
the interpolated positions (upos_j == upos_0 + sgn * w_j), the anchors'
overlapping windows chain into read[0 : wlast + k] == that unitig stretch,
so every window of the read hits it.  The read's distinct EC rows are then
the block ECs of the contiguous block-id range [blo, bhi] (blocks are
unitig-major and position-ascending, asserted when the index is put on
the device), read from two 8-wide rows of block_ec8; its first hit is
anchor 0 with f_rpos = 0 and rng = wlast.

wave 2 -- every other real read at least k long is evaluated window by
window, as kernel D evaluates it.  n_fail counts them and goes to the key
table's meta row.  In the JAX package wave 2 is a fixed-size sub-batch
for the TPU's static shapes: failures past its capacity mark the table
overflowed and the caller redoes the batch through kernel D.  Here wave 1
lists the failing reads on the card and wave 2 takes the whole list, so
every read gets its real result and no table is marked; JAX's wave2_cap
/ wave2_denom arguments are not taken.

Row width: a verified read has R = max_rows slots; the wave-2 core gives
min(max_rows, W) with W = Lc - k + 1.  JAX merges the two by broadcasting,
which works when they are equal or the core has one slot (that slot fills
every slot) and raises ValueError ("Incompatible shapes for broadcasting")
otherwise, i.e. for k + 1 < Lc < k + max_rows - 1.  These functions do the
same (`row_width_ok` says which lengths have an anchor route).

On the card wave 1 and wave 2 are kernel I's two launches
(csrc/pseudoalign.cu pseudoalign_anchor, then pseudoalign_anchor_wave2 on
the reads wave 1 listed), followed by kernel E (the compact keys and the
table in one C call); on the CPU each is its plain PyTorch version.

The same anchors serve inside a read: skip_core_plain models the
covered-interval core (csrc/pseudoalign.cu: kt_core_skip in A on codes'
wave 2, kt_skip_anchors and kt_skip_finish in kernel K), which looks up
only the windows that no pair of adjacent agreeing anchors covers;
codes_waves_plain is A on codes' two waves on top of it, side_waves_plain
kernel A's on the dense core.
"""

from typing import NamedTuple, Tuple

import torch

from . import kernels
from .pseudoalign import (
    INT32_MAX,
    AnyDeviceIndex,
    SideResult,
    _pseudoalign_core,
    compact_pair_keys,
    compact_single_keys,
    lookup_kmers,
    rolling_canonical_kmers,
    unpack_codes,
)
from .turbo import _split, codes_and_lens_plain


def n_anchors_for(Lp: int, k: int) -> int:
    """Anchor count: interior anchors keep every gap <= k."""
    span = max(Lp - k, 0)
    return max(2, -(-span // k) + 1)


def row_width_ok(Lc: int, k: int, max_rows: int = 16) -> bool:
    """Whether reads of Lc code columns have an anchor route: the wave-2
    row width min(max_rows, Lc - k + 1) is max_rows or 1."""
    return Lc >= k and min(max_rows, Lc - k + 1) in (1, max_rows)


def _check_row_width(Lc: int, k: int, max_rows: int) -> int:
    Rc = min(max_rows, Lc - k + 1)
    if not row_width_ok(Lc, k, max_rows):
        raise ValueError(
            f"Incompatible shapes for broadcasting: wave-2 rows {Rc} and "
            f"verified rows {max_rows} (Lc={Lc}, k={k})")
    return Rc


def _anchor_canon(codes: torch.Tensor, w: int, k: int):
    """Canonical k-mer of the window at column w of every read: (canon
    int64, is_fw, clean = window free of N codes)."""
    sl = codes[:, w : w + k]
    c = (sl & 3).to(torch.int64)
    f = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    r = torch.zeros_like(f)
    for d in range(k):
        f = (f << 2) | c[:, d]
        r = r | ((3 - c[:, d]) << (2 * d))
    is_fw = f <= r
    return torch.where(is_fw, f, r), is_fw, ~(sl >= 4).any(dim=1)


class Wave1(NamedTuple):
    """Wave 1 of every read: the verified flag and the anchors' lookups
    ([B2, n_anchors] each, anchor j at column ws[j])."""

    ok: torch.Tensor
    ws: list
    valid: torch.Tensor
    hit: torch.Tensor
    uid: torch.Tensor
    upos: torch.Tensor
    strand: torch.Tensor
    blk: torch.Tensor


def anchor_wave1_plain(didx: AnyDeviceIndex, codes: torch.Tensor, rlen: int,
                       real: torch.Tensor, k: int, n_anchors: int) -> Wave1:
    """Plain version of kernel I's wave 1 (JAX _anchor_side :88-123)."""
    wlast = max(rlen - k, 0)
    ws = [(wlast * j) // (n_anchors - 1) for j in range(n_anchors)]
    parts = [_anchor_canon(codes, w, k) for w in ws]
    canA = torch.stack([p[0] for p in parts], dim=1)
    fwA = torch.stack([p[1] for p in parts], dim=1)
    long_enough = rlen >= k
    validA = torch.stack([p[2] for p in parts], dim=1) & long_enough \
        & real[:, None]
    idxA, hitA, _ = lookup_kmers(didx, canA, validA)
    neg1 = torch.full_like(idxA, -1, dtype=torch.int32)
    zero = torch.zeros_like(neg1)
    uidA = torch.where(hitA, didx.kmer_uid[idxA], neg1)
    uposA = torch.where(hitA, didx.kmer_pos[idxA], zero)
    strandA = fwA == didx.kmer_fw[idxA]
    blkA = torch.where(hitA, didx.kmer_block[idxA], zero)

    ok = hitA.all(dim=1)
    ok &= (uidA == uidA[:, :1]).all(dim=1)
    ok &= (strandA == strandA[:, :1]).all(dim=1)
    sgn = torch.where(strandA[:, 0], 1, -1).to(torch.int32)
    for j in range(1, n_anchors):
        ok &= uposA[:, j] == uposA[:, 0] + sgn * ws[j]
    blo = blkA.amin(dim=1)
    bhi = blkA.amax(dim=1)
    r0 = blo >> 3
    ok &= (bhi >> 3) <= r0 + 1   # candidates fit in two 8-wide rows
    ok &= blo >= 0
    ok &= real & long_enough
    return Wave1(ok, ws, validA, hitA, uidA, uposA, strandA, blkA)


def _verified_rows(didx: AnyDeviceIndex, blo: torch.Tensor,
                   bhi: torch.Tensor, R: int):
    """A verified read's rows: the distinct sorted block ECs over [blo,
    bhi] from two 8-wide rows of block_ec8, R slots (min(R, 16) filled),
    and whether more distinct ECs are left.  Returns (rows [B2, R],
    overflow [B2])."""
    B2, dev = blo.shape[0], blo.device
    r0 = blo >> 3
    nb8 = didx.block_ec8.shape[0]
    rc = torch.clamp(r0, 0, nb8 - 2).to(torch.int64)  # rows of ok reads
    cand = torch.cat([didx.block_ec8[rc], didx.block_ec8[rc + 1]], dim=1)
    fid = (r0 * 8)[:, None] + torch.arange(16, dtype=torch.int32, device=dev)
    inr = (fid >= blo[:, None]) & (fid <= bhi[:, None])
    big = torch.full_like(cand, INT32_MAX)
    vr = torch.where(inr & (cand >= 0), cand, big)
    slots = []
    prev = torch.full((B2,), -1, dtype=torch.int32, device=dev)
    for _ in range(min(R, 16)):
        cur = torch.where(vr > prev[:, None], vr, big).amin(dim=1)
        slots.append(cur)
        prev = torch.where(cur != INT32_MAX, cur, prev)
    while len(slots) < R:
        slots.append(torch.full((B2,), INT32_MAX, dtype=torch.int32,
                                device=dev))
    ovf = ((vr > prev[:, None]) & (vr != INT32_MAX)).any(dim=1)
    return torch.stack(slots, dim=1), ovf


def anchor_side_plain(didx: AnyDeviceIndex, codes: torch.Tensor, rlen: int,
                      real: torch.Tensor, k: int, max_rows: int,
                      n_anchors: int) -> Tuple[SideResult, torch.Tensor]:
    """Plain version of kernel I on decoded codes [B2, Lc] (JAX
    _anchor_side, every wave-2 read evaluated).  Returns (SideResult with
    max_rows slots, n_fail [1] int64)."""
    B2, Lc = codes.shape
    dev = codes.device
    R = max_rows
    Rc = _check_row_width(Lc, k, R)
    wlast = max(rlen - k, 0)
    long_enough = rlen >= k
    w1 = anchor_wave1_plain(didx, codes, rlen, real, k, n_anchors)
    ok, uidA, uposA, strandA, blkA = w1.ok, w1.uid, w1.upos, w1.strand, w1.blk
    rows_v, ovf_v = _verified_rows(didx, blkA.amin(dim=1), blkA.amax(dim=1),
                                   R)

    neg = torch.full((B2,), -1, dtype=torch.int32, device=dev)
    rows = torch.where(ok[:, None], rows_v, torch.full_like(rows_v, INT32_MAX))
    n_rows = torch.where(ok, (rows_v != INT32_MAX).sum(dim=1).to(torch.int32),
                         torch.zeros_like(neg))
    out = SideResult(
        rows=rows, n_rows=n_rows, has_hits=ok.clone(), overflow=ok & ovf_v,
        f_uid=torch.where(ok, uidA[:, 0], neg),
        f_block=torch.where(ok, blkA[:, 0], neg),
        f_upos=torch.where(ok, uposA[:, 0], neg),
        f_rpos=torch.where(ok, torch.zeros_like(neg), neg),
        f_strand=strandA[:, 0].clone(),
        rng=torch.where(ok, torch.full_like(neg, wlast), neg),
    )

    # wave 2: every failing read, in read order, through the full core
    fail = (~ok) & real & long_enough
    sel = torch.nonzero(fail).squeeze(1)
    if sel.numel():
        lens = torch.full((sel.shape[0],), rlen, dtype=torch.int32, device=dev)
        core = _pseudoalign_core(didx, codes[sel], lens, k, R)
        for name, a, b in zip(SideResult._fields, out, core):
            if name == "rows" and Rc < R:
                b = b.expand(-1, R)   # a one-slot core row fills every slot
            a[sel] = b
    n_fail = fail.sum().reshape(1).to(torch.int64)
    return out, n_fail


def _wave1_plain(didx: AnyDeviceIndex, codes: torch.Tensor,
                 lens: torch.Tensor, k: int, max_rows: int):
    """Wave 1 of kernel A (packed rows or unpacked codes) on codes [B, L]:
    anchor_wave1_plain on the reads of each length from k to L, at that
    length (n_anchors_for(len, k) anchors, wlast = len - k), a code above
    3 failing any anchor whose window holds it; a verified read, whose
    block range also holds at most R candidates where R = min(max_rows,
    L - k + 1) < 16, takes the block ECs of its range and its first hit
    from anchor 0, as anchor_side_plain writes it.  Returns (SideResult
    with the verified reads filled, the rest as reads without hits;
    verified [B] bool)."""
    B, L = codes.shape
    dev = codes.device
    R = min(max_rows, L - k + 1)
    i32 = dict(dtype=torch.int32, device=dev)
    out = SideResult(
        rows=torch.full((B, R), INT32_MAX, **i32),
        n_rows=torch.zeros(B, **i32),
        has_hits=torch.zeros(B, dtype=torch.bool, device=dev),
        overflow=torch.zeros(B, dtype=torch.bool, device=dev),
        f_uid=torch.full((B,), -1, **i32), f_block=torch.full((B,), -1, **i32),
        f_upos=torch.full((B,), -1, **i32), f_rpos=torch.full((B,), -1, **i32),
        f_strand=torch.zeros(B, dtype=torch.bool, device=dev),
        rng=torch.full((B,), -1, **i32))
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    lens64 = lens.to(torch.int64)
    for ln in torch.unique(lens64[(lens64 >= k) & (lens64 <= L)]).tolist():
        sel = torch.nonzero(lens64 == ln).squeeze(1)
        real = torch.ones(sel.shape[0], dtype=torch.bool, device=dev)
        w1 = anchor_wave1_plain(didx, codes[sel], ln, real, k,
                                n_anchors_for(ln, k))
        blo, bhi = w1.blk.amin(dim=1), w1.blk.amax(dim=1)
        okg = w1.ok & ((bhi - blo < R) if R < 16 else True)
        rows_v, _ = _verified_rows(didx, blo, bhi, R)
        v = sel[okg]
        ok[v] = True
        out.rows[v] = rows_v[okg]
        out.n_rows[v] = (rows_v[okg] != INT32_MAX).sum(dim=1).to(torch.int32)
        out.has_hits[v] = True
        out.f_uid[v] = w1.uid[okg, 0]
        out.f_block[v] = w1.blk[okg, 0]
        out.f_upos[v] = w1.upos[okg, 0]
        out.f_rpos[v] = 0
        out.f_strand[v] = w1.strand[okg, 0]
        out.rng[v] = ln - k
    return out, ok


def side_waves_plain(didx: AnyDeviceIndex, packed: torch.Tensor,
                     nmask: torch.Tensor, lens: torch.Tensor, k: int, L: int,
                     max_rows: int = 16) -> Tuple[SideResult, torch.Tensor]:
    """Kernel A's two waves in plain PyTorch, on one mate's packed batch
    (csrc/pseudoalign.cu pseudoalign_side_kernel, then
    pseudoalign_side_wave2_kernel).
    Wave 1: _wave1_plain on the unpacked codes (the N bitmask makes code
    4).  Wave 2: every other read through _pseudoalign_core.  The result
    equals pseudoalign_batch_packed_plain's in every field (the premise
    of kernel A's design, which the tests hold).  Returns (SideResult,
    fail [B] bool: the reads of wave 2)."""
    codes = unpack_codes(packed, nmask, L)
    out, ok = _wave1_plain(didx, codes, lens, k, max_rows)
    fail = ~ok
    sel = torch.nonzero(fail).squeeze(1)
    if sel.numel():
        core = _pseudoalign_core(didx, codes[sel], lens[sel], k, max_rows)
        for a, b in zip(out, core):
            a[sel] = b
    return out, fail


def skip_core_plain(didx: AnyDeviceIndex, codes: torch.Tensor,
                    lens: torch.Tensor, k: int,
                    max_rows: int = 16) -> Tuple[SideResult, torch.Tensor]:
    """The covered-interval core in plain PyTorch (csrc/pseudoalign.cu
    kt_core_skip, A on codes' wave 2, and kt_skip_anchors +
    kt_skip_finish, kernel K's failed mates), on codes [B, L] (a code
    above 3 is an N) and lens [B].

    A read of le = min(len, L) >= k columns has na = n_anchors_for(le, k)
    anchors at w_j = (wlast * j) // (na - 1), wlast = le - k, at most k
    apart; one shorter than k has one, window 0.  Every anchor is looked
    up (window 0 also when invalid: its slot gives f_strand of a read
    without hits).  Interval [w_j, w_j+1] is covered when both anchors
    hit one unitig on one strand at positions w_j+1 - w_j apart and the
    block range of the two lies within two 8-wide rows of block_ec8: then
    read[w_j, w_j+1 + k) is that stretch of the unitig, every window
    between them hits it, and their EC rows are the block ECs of the
    blocks strictly between the two anchors' (the anchors give their own).
    Every other interval is open, and its valid windows are looked up.
    So a read's first and last hits are looked-up windows, and its
    distinct rows come from the looked-up hits and the covered intervals'
    block ECs.  Returns (SideResult with R = min(max_rows, L - k + 1)
    slots, equal in every field to _pseudoalign_core's; probed [B, W]
    bool: the windows looked up)."""
    B, L = codes.shape
    dev = codes.device
    canon, is_fw, valid = rolling_canonical_kmers(codes, lens, k)
    W = canon.shape[1]
    R = min(max_rows, W)
    pos = torch.arange(W, device=dev)
    le = torch.clamp(lens.to(torch.int64), max=L)
    wl = le - k
    na = torch.where(wl >= 0, torch.clamp((wl + k - 1) // k + 1, min=2),
                     torch.ones_like(wl))
    NA = int(na.max()) if B else 1
    j = torch.arange(NA, device=dev)[None, :]
    am = j < na[:, None]
    ws = torch.where(am, (wl.clamp(min=0)[:, None] * j)
                     // (na[:, None] - 1).clamp(min=1), W)
    wsc = ws.clamp(max=W - 1)

    # the anchors' lookups and payloads
    val_a = valid.gather(1, wsc) & am
    idx_a, hit_a, _ = lookup_kmers(didx, canon.gather(1, wsc), val_a)
    zero = torch.zeros_like(idx_a, dtype=torch.int32)
    uid = torch.where(hit_a, didx.kmer_uid[idx_a], zero - 1)
    upos = torch.where(hit_a, didx.kmer_pos[idx_a], zero)
    blk = torch.where(hit_a, didx.kmer_block[idx_a], zero)
    strand = is_fw.gather(1, wsc) == didx.kmer_fw[idx_a]

    # covered intervals [w_j, w_j+1], j < na - 1 (a False column pads the
    # last anchor's)
    sgn = torch.where(strand[:, :-1], 1, -1)
    blo = torch.minimum(blk[:, :-1], blk[:, 1:])
    bhi = torch.maximum(blk[:, :-1], blk[:, 1:])
    cov = (am[:, 1:] & hit_a[:, :-1] & hit_a[:, 1:]
           & (uid[:, :-1] == uid[:, 1:]) & (strand[:, :-1] == strand[:, 1:])
           & (upos[:, 1:] == upos[:, :-1] + sgn * (ws[:, 1:] - ws[:, :-1]))
           & (blo >= 0) & ((bhi >> 3) <= (blo >> 3) + 1))
    cov = torch.cat([cov, torch.zeros((B, 1), dtype=torch.bool, device=dev)],
                    dim=1)

    # the windows looked up: the anchors and the valid windows strictly
    # inside an open interval, and window 0 always
    wpos = pos[None, :].expand(B, W).contiguous()
    iv = torch.searchsorted(ws.contiguous(), wpos, right=True) - 1
    iv = iv.clamp(min=0)
    anchor_w = (ws.gather(1, iv) == wpos) & (wpos <= wl[:, None])
    inside = (wpos <= wl[:, None]) & ~anchor_w
    open_in = inside & ~cov.gather(1, iv)
    probed = ((anchor_w | open_in) & valid) | (wpos == 0)

    idx, hit, ec = lookup_kmers(didx, canon, valid & probed)
    big = torch.full_like(ec, INT32_MAX)
    vals = [torch.where(hit & (ec >= 0), ec, big)]
    # a covered interval's blocks strictly between its anchors' blocks
    if NA > 1:
        nb8 = didx.block_ec8.shape[0]
        r0 = (blo >> 3).to(torch.int64)
        cand = torch.cat([didx.block_ec8[r0.clamp(0, nb8 - 1)],
                          didx.block_ec8[(r0 + 1).clamp(0, nb8 - 1)]],
                         dim=2)
        fid = (r0 * 8)[:, :, None] + torch.arange(16, device=dev)
        inr = (cov[:, :-1, None] & (fid > blo[:, :, None])
               & (fid < bhi[:, :, None]) & (cand >= 0))
        vals.append(torch.where(inr, cand, torch.full_like(cand, INT32_MAX))
                    .reshape(B, -1))
    rows = torch.cat(vals, dim=1)

    prev = torch.full((B,), -1, dtype=torch.int32, device=dev)
    slots = []
    for _ in range(R):
        cur = torch.where(rows > prev[:, None], rows,
                          torch.full_like(rows, INT32_MAX)).amin(dim=1)
        slots.append(cur)
        prev = torch.where(cur != INT32_MAX, cur, prev)
    uniq = torch.stack(slots, dim=1)
    has_hits = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.int8), dim=1)
    kidx = idx.gather(1, first[:, None])[:, 0]
    neg = torch.full((B,), -1, dtype=torch.int32, device=dev)
    last = torch.where(hit, pos[None, :], -1).amax(dim=1)
    return SideResult(
        rows=uniq.contiguous(),
        n_rows=(uniq != INT32_MAX).sum(dim=1).to(torch.int32),
        has_hits=has_hits,
        overflow=((rows > prev[:, None]) & (rows != INT32_MAX)).any(dim=1),
        f_uid=torch.where(has_hits, didx.kmer_uid[kidx], neg),
        f_block=torch.where(has_hits, didx.kmer_block[kidx], neg),
        f_upos=torch.where(has_hits, didx.kmer_pos[kidx], neg),
        f_rpos=torch.where(has_hits, first.to(torch.int32), neg),
        f_strand=is_fw.gather(1, first[:, None])[:, 0]
        == didx.kmer_fw[kidx],
        rng=torch.where(has_hits, (last - first).to(torch.int32), neg),
    ), probed


def codes_waves_plain(didx: AnyDeviceIndex, codes: torch.Tensor,
                      lens: torch.Tensor, k: int, max_rows: int = 16):
    """Kernel A on codes' two waves in plain PyTorch (csrc/pseudoalign.cu
    pseudoalign_codes_kernel, then pseudoalign_codes_wave2_kernel), on
    codes [B, L] uint8 (a code above 3 is an N) and lens [B].  Wave 1:
    _wave1_plain.  Wave 2: every other read through skip_core_plain.  The
    result equals _pseudoalign_core's in every field.  Returns
    (SideResult, fail [B] bool: the reads of wave 2, probed [B, W] bool:
    the windows wave 2 looked up)."""
    out, ok = _wave1_plain(didx, codes, lens, k, max_rows)
    fail = ~ok
    W = codes.shape[1] - k + 1
    probed = torch.zeros((codes.shape[0], W), dtype=torch.bool,
                         device=codes.device)
    sel = torch.nonzero(fail).squeeze(1)
    if sel.numel():
        core, probed[sel] = skip_core_plain(didx, codes[sel], lens[sel], k,
                                            max_rows)
        for a, b in zip(out, core):
            a[sel] = b
    return out, fail, probed


def _real_rows(aux: torch.Tensor, B: int, ns: int) -> torch.Tensor:
    side_idx = torch.arange(ns * B, dtype=torch.int64, device=aux.device) % B
    return side_idx < aux[1]


def anchor_sides(didx: AnyDeviceIndex, sides, aux: torch.Tensor, k: int,
                 L: int, max_rows: int, n_anchors: int,
                 rl: int = 0) -> Tuple[SideResult, torch.Tensor]:
    """Kernel I (or its plain version): the SideResult of every read of the
    concatenated mates ([ns * Bp] rows, max_rows slots) and n_fail."""
    if sides[0].is_cuda:
        out, n_fail = kernels.pseudoalign_anchor(didx, sides, aux, k, L, rl,
                                                 max_rows, n_anchors)
        return SideResult(*out), n_fail
    codes, _ = codes_and_lens_plain(sides, aux, None, L, rl)
    real = _real_rows(aux, sides[0].shape[0], len(sides))
    return anchor_side_plain(didx, codes, int(aux[0]), real, k, max_rows,
                             n_anchors)


def _with_n_fail(ck: torch.Tensor, n_fail: torch.Tensor) -> torch.Tensor:
    ck[0, 1:2].copy_(n_fail)  # meta row: [n_uniq, n_fail, 0, 0, 0]
    return ck


def pseudoalign_pair_anchor(
    didx: AnyDeviceIndex, p1: torch.Tensor, p2: torch.Tensor,
    aux: torch.Tensor, k: int, L: int, max_rows: int = 16,
    max_keys: int = 32768, n_anchors: int = 2, min_range: int = 0, strand_key: bool = False,
    rl: int = 0, pos_fl: int = -1, pos_depth: int = 0,
):
    """Uniform-length pair batch through the anchor kernel, then kernel E's
    compact keys and table.  Returns (r1, r2, ck [max_keys+1,
    5]) with n_fail in ck[0, 1]."""
    B = p1.shape[0]
    side, n_fail = anchor_sides(didx, (p1, p2), aux, k, L, max_rows,
                                n_anchors, rl)
    r1, r2 = _split(side, B)
    ck = compact_pair_keys(r1, r2, max_keys, k, min_range, strand_key, didx,
                           pos_fl, pos_depth)
    return r1, r2, _with_n_fail(ck, n_fail)


def pseudoalign_single_anchor(
    didx: AnyDeviceIndex, p1: torch.Tensor, aux: torch.Tensor, k: int, L: int,
    max_rows: int = 16, max_keys: int = 32768, n_anchors: int = 2,
    min_range: int = 0, strand_key: bool = False, rl: int = 0,
    pos_fl: int = -1, pos_depth: int = 0,
):
    """Single-end twin of pseudoalign_pair_anchor: (r1, ck)."""
    side, n_fail = anchor_sides(didx, (p1,), aux, k, L, max_rows, n_anchors,
                                rl)
    ck = compact_single_keys(side, max_keys, k, min_range, strand_key, didx,
                             pos_fl, pos_depth)
    return side, _with_n_fail(ck, n_fail)
