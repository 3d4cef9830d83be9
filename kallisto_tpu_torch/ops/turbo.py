"""Turbo steady-state pseudoalignment: padded batches reduced to a key table.

Port of kallisto_tpu/ops/turbo.py.  A turbo batch differs from a per-read
one in its upload:

- **aux vector** instead of a per-read N bitmask: one int64 vector carries
  the uniform read length, the real-read count (batches are padded up to a
  bucketed size; padding reads get length 0, give the no-hit key and are
  never counted) and the sparse in-read N positions, ascending.
- **both mates in one launch**, and the batch reduced on the card to its
  key table (ops/pseudoalign.py compact_pair_keys), so the host fetches one
  small table instead of per-read arrays.

On the card the decode and the pseudoalignment are kernel D
(csrc/pseudoalign.cu pseudoalign_turbo), the keys and the table kernel E
(csrc/compact.cu compact_keys); on the CPU each is its plain PyTorch
version.

The half-fail wave 2 of host wave 1 (ops/hostprobe.py) is kernel K
(csrc/pseudoalign.cu pseudoalign_halffail): pairs of which one mate failed
the host probe send only that mate's codes, with the other mate's 8-byte
summary; halffail_core is its plain version.  K runs the failed mate
through the covered-interval core (anchors first, then only the windows
that no pair of agreeing anchors covers; ops/anchor.py skip_core_plain is
its plain model).  The wave-2 slices also ask
kernel E for each read's row in the table (with_slots).  Semantics are the
reference's --no-jump evaluation of every k-mer (reference:
src/KmerIndex.cpp:1698-1940).
"""

from typing import Optional

import numpy as np
import torch

from . import kernels
from .pseudoalign import (
    INT32_MAX,
    AnyDeviceIndex,
    SideResult,
    _pseudoalign_core,
    compact_pair_keys,
    compact_single_keys,
)

AUX_HEADER = 4
EXC_CAP = 65536


def make_aux(n_real: int, rlen: int, exc: Optional[np.ndarray],
             cap: int = EXC_CAP) -> Optional[np.ndarray]:
    """Host-side aux vector: [rlen, n_real, 0, 0, exc ascending..., pad].

    exc are flat indices into the row-major [n_sides * Bp, Lp] code matrix
    of the padded, concatenated mates; the pad is INT64_MAX.  Returns None
    when there are more than `cap` (caller takes the bitmask route)."""
    n = 0 if exc is None else int(exc.shape[0])
    if n > cap:
        return None
    aux = np.full(AUX_HEADER + cap, np.iinfo(np.int64).max, np.int64)
    aux[0] = rlen
    aux[1] = n_real
    aux[2] = 0
    aux[3] = 0
    if n:
        aux[AUX_HEADER : AUX_HEADER + n] = np.sort(exc)
    return aux


def _codes_from_packed(packed: torch.Tensor, L: int) -> torch.Tensor:
    """2-bit unpack without an N bitmask."""
    B = packed.shape[0]
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    c = (packed[:, :, None] >> shifts[None, None, :]) & 3
    return c.reshape(B, -1)[:, :L]


def codes_and_lens_plain(sides, aux: torch.Tensor, lens: Optional[torch.Tensor],
                         L: int, rl: int = 0):
    """Plain version of kernel D's decode: unpack the mates, mark the N
    exceptions, trim to rl columns when 0 < rl < L, and mask the lengths
    of padding reads to 0.  Returns (codes [ns*B, L'] uint8, lens [ns*B]
    int32).

    Exception indices address the padded [ns*B, L] matrix (row stride L,
    not rl): an exception at a column >= rl is dropped by the trim."""
    B = sides[0].shape[0]
    ns = len(sides)
    codes = torch.cat([_codes_from_packed(p, L) for p in sides], dim=0)
    exc = aux[AUX_HEADER:]
    exc = exc[(exc >= 0) & (exc < ns * B * L)]
    flat = codes.reshape(-1).clone()
    flat[exc] = 4
    codes = flat.reshape(ns * B, L)
    if 0 < rl < L:
        codes = codes[:, :rl]
    side_idx = torch.arange(ns * B, dtype=torch.int64, device=codes.device) % B
    real = side_idx < aux[1]
    full = aux[0].to(torch.int32) if lens is None else lens.to(torch.int32)
    lens_v = torch.where(real, full, torch.zeros((), dtype=torch.int32,
                                                 device=codes.device))
    return codes, lens_v


def turbo_sides(didx: AnyDeviceIndex, sides, aux: torch.Tensor,
                lens: Optional[torch.Tensor], k: int, L: int, max_rows: int,
                rl: int = 0) -> SideResult:
    """Kernel D (or its plain version): the SideResult of every read of the
    concatenated mates, [ns * Bp] rows.  R = min(max_rows, Lc - k + 1) with
    Lc = rl when the batch is trimmed, else L."""
    Lc = rl if 0 < rl < L else L
    R = min(max_rows, Lc - k + 1)
    if sides[0].is_cuda:
        return SideResult(*kernels.pseudoalign_turbo(
            didx, sides, aux, lens, k, L, rl, R))
    codes, lens_v = codes_and_lens_plain(sides, aux, lens, L, rl)
    return _pseudoalign_core(didx, codes, lens_v, k, max_rows)


def _split(r: SideResult, B: int):
    return SideResult(*(a[:B] for a in r)), SideResult(*(a[B:] for a in r))


def _pair_keys(didx, r1, r2, k, max_keys, min_range, strand_key, pos_fl,
               pos_depth, with_slots):
    out = compact_pair_keys(r1, r2, max_keys, k, min_range, strand_key, didx,
                            pos_fl, pos_depth, with_slots)
    return (r1, r2, *out) if with_slots else (r1, r2, out)


def pair_turbo_core(didx, p1, p2, aux, lens, k: int, L: int, max_rows: int,
                    max_keys: int, min_range: int = 0, strand_key: bool = False,
                    rl: int = 0, pos_fl: int = -1, pos_depth: int = 0,
                    with_slots: bool = False):
    """Both mates through kernel D in one launch, then kernel E's compact
    keys and table.  Returns (r1, r2, ck [max_keys+1, 5]), with
    with_slots also each read's row in ck ([Bp] int32)."""
    r1, r2 = _split(turbo_sides(didx, (p1, p2), aux, lens, k, L, max_rows, rl),
                    p1.shape[0])
    return _pair_keys(didx, r1, r2, k, max_keys, min_range, strand_key,
                      pos_fl, pos_depth, with_slots)


def pseudoalign_pair_turbo(didx, p1, p2, aux, k: int, L: int,
                           max_rows: int = 16, max_keys: int = 32768,
                           min_range: int = 0, strand_key: bool = False,
                           rl: int = 0, pos_fl: int = -1, pos_depth: int = 0,
                           with_slots: bool = False):
    """Uniform-length pair batch: the length travels in aux[0]."""
    return pair_turbo_core(didx, p1, p2, aux, None, k, L, max_rows, max_keys,
                           min_range, strand_key, rl, pos_fl, pos_depth,
                           with_slots)


def verified_side_plain(didx: AnyDeviceIndex, vsum: torch.Tensor, R: int,
                        lens_v: torch.Tensor, k: int) -> SideResult:
    """A host-verified mate's SideResult from its 8-byte summary (JAX
    _verified_side_from_summary, turbo.py:153): rows = the distinct sorted
    block ECs of [blo, blo + span] from two block_ec8 rows, min(R, 16)
    rounds of a masked minimum, the rest INT32_MAX; padding rows (lens_v
    == 0) stay no-hit."""
    blo, meta = vsum[:, 0], vsum[:, 1]
    real = lens_v > 0
    strand = (meta & 1) == 1
    bhi = blo + ((meta >> 1) & 15)
    upos0 = meta >> 5
    B2 = blo.shape[0]
    dev = vsum.device
    r0 = (torch.clamp(blo, min=0) >> 3).to(torch.int64)
    nb8 = didx.block_ec8.shape[0]
    cand = torch.cat([didx.block_ec8[torch.clamp(r0, max=nb8 - 1)],
                      didx.block_ec8[torch.clamp(r0 + 1, max=nb8 - 1)]], dim=1)
    fid = (r0 * 8)[:, None] + torch.arange(16, dtype=torch.int64, device=dev)
    inr = (fid >= blo[:, None]) & (fid <= bhi[:, None]) & real[:, None]
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
    rows = torch.stack(slots, dim=1)
    neg = torch.full((B2,), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(neg)
    return SideResult(
        rows=rows,
        n_rows=(rows != INT32_MAX).sum(dim=1).to(torch.int32),
        has_hits=real,
        overflow=torch.zeros(B2, dtype=torch.bool, device=dev),
        f_uid=torch.where(real, zero, neg),
        f_block=torch.where(real, torch.where(strand, blo, bhi), neg),
        f_upos=torch.where(real, upos0, neg),
        f_rpos=torch.where(real, zero, neg),
        f_strand=strand,
        rng=torch.where(real, lens_v - k, neg).to(torch.int32),
    )


def halffail_core(didx: AnyDeviceIndex, pkf: torch.Tensor, vsum: torch.Tensor,
                  sidev: torch.Tensor, aux: torch.Tensor, k: int, L: int,
                  max_rows: int, rl: int = 0):
    """Plain version of kernel K (JAX halffail_core, turbo.py:203): the
    failed mates through the per-read core, the verified mates rebuilt from
    their summaries with the core's row width (the core clamps max_rows to
    the window count), each pair's mates picked by sidev (1: mate 1
    failed).  Returns (r1, r2)."""
    codes, lens_v = codes_and_lens_plain((pkf,), aux, None, L, rl)
    rf = _pseudoalign_core(didx, codes, lens_v, k, max_rows)
    rv = verified_side_plain(didx, vsum, int(rf.rows.shape[1]), lens_v, k)
    m1 = sidev == 1

    def sel(a, b):
        return torch.where(m1[:, None] if a.dim() == 2 else m1, a, b)

    return (SideResult(*(sel(f, v) for f, v in zip(rf, rv))),
            SideResult(*(sel(v, f) for f, v in zip(rf, rv))))


def pseudoalign_pair_halffail(didx, pkf, vsum, sidev, aux, k: int, L: int,
                              max_rows: int = 16, max_keys: int = 32768,
                              min_range: int = 0, strand_key: bool = False,
                              rl: int = 0, pos_fl: int = -1,
                              pos_depth: int = 0, with_slots: bool = False):
    """Wave 2 of the pairs of which exactly one mate failed host wave 1
    (JAX pseudoalign_pair_halffail, turbo.py:244): kernel K (or its plain
    version), then kernel E's compact keys and table.  pkf [Bp,
    L/4] uint8, vsum [Bp, 2] int32, sidev [Bp] int32.  Returns (r1, r2, ck)
    and with with_slots the per-read rows."""
    if pkf.is_cuda:
        Lc = rl if 0 < rl < L else L
        R = min(max_rows, Lc - k + 1)
        o1, o2 = kernels.pseudoalign_halffail(didx, pkf, vsum, sidev, aux, k,
                                              L, rl, R)
        r1, r2 = SideResult(*o1), SideResult(*o2)
    else:
        r1, r2 = halffail_core(didx, pkf, vsum, sidev, aux, k, L, max_rows, rl)
    return _pair_keys(didx, r1, r2, k, max_keys, min_range, strand_key,
                      pos_fl, pos_depth, with_slots)


def pseudoalign_pair_turbo_varlen(didx, p1, p2, aux, lens, k: int, L: int,
                                  max_rows: int = 16, max_keys: int = 32768,
                                  min_range: int = 0, strand_key: bool = False,
                                  pos_fl: int = -1, pos_depth: int = 0):
    """Mixed-length pair batch: lens [2 * Bp] uint16, mate 1 then mate 2."""
    return pair_turbo_core(didx, p1, p2, aux, lens, k, L, max_rows, max_keys,
                           min_range, strand_key, 0, pos_fl, pos_depth)


def single_turbo_core(didx, p1, aux, lens, k: int, L: int, max_rows: int,
                      max_keys: int, min_range: int = 0,
                      strand_key: bool = False, rl: int = 0, pos_fl: int = -1,
                      pos_depth: int = 0):
    r1 = turbo_sides(didx, (p1,), aux, lens, k, L, max_rows, rl)
    return r1, compact_single_keys(r1, max_keys, k, min_range, strand_key,
                                   didx, pos_fl, pos_depth)


def pseudoalign_single_turbo(didx, p1, aux, k: int, L: int, max_rows: int = 16,
                             max_keys: int = 32768, min_range: int = 0,
                             strand_key: bool = False, rl: int = 0,
                             pos_fl: int = -1, pos_depth: int = 0):
    return single_turbo_core(didx, p1, aux, None, k, L, max_rows, max_keys,
                             min_range, strand_key, rl, pos_fl, pos_depth)


def pseudoalign_single_turbo_varlen(didx, p1, aux, lens, k: int, L: int,
                                    max_rows: int = 16, max_keys: int = 32768,
                                    min_range: int = 0, strand_key: bool = False,
                                    pos_fl: int = -1, pos_depth: int = 0):
    return single_turbo_core(didx, p1, aux, lens, k, L, max_rows, max_keys,
                             min_range, strand_key, 0, pos_fl, pos_depth)
