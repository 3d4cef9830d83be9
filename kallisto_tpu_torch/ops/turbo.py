"""Turbo steady-state pseudoalignment: padded batches reduced to a key table.

Port of kallisto_tpu/ops/turbo.py (without the half-fail wave 2, which
comes with host wave 1).  A turbo batch differs from a per-read one in its
upload:

- **aux vector** instead of a per-read N bitmask: one int64 vector carries
  the uniform read length, the real-read count (batches are padded up to a
  bucketed size; padding reads get length 0, give the no-hit key and are
  never counted) and the sparse in-read N positions, ascending.
- **both mates in one launch**, and the batch reduced on the card to its
  key table (ops/pseudoalign.py key_histogram), so the host fetches one
  small table instead of per-read arrays.

On the card the decode and the pseudoalignment are kernel D
(csrc/pseudoalign.cu pseudoalign_turbo), the keys kernel B and the table
kernel E; on the CPU each is its plain PyTorch version.  Semantics are the
reference's --no-jump evaluation of every k-mer (reference:
src/KmerIndex.cpp:1698-1940).
"""

from typing import Optional

import numpy as np
import torch

from . import kernels
from .pseudoalign import (
    DeviceIndex,
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


def turbo_sides(didx: DeviceIndex, sides, aux: torch.Tensor,
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


def pair_turbo_core(didx, p1, p2, aux, lens, k: int, L: int, max_rows: int,
                    max_keys: int, min_range: int = 0, strand_key: bool = False,
                    rl: int = 0, pos_fl: int = -1, pos_depth: int = 0):
    """Both mates through kernel D in one launch, then kernel B's compact
    keys and kernel E's table.  Returns (r1, r2, ck [max_keys+1, 5])."""
    r1, r2 = _split(turbo_sides(didx, (p1, p2), aux, lens, k, L, max_rows, rl),
                    p1.shape[0])
    return r1, r2, compact_pair_keys(r1, r2, max_keys, k, min_range,
                                     strand_key, didx, pos_fl, pos_depth)


def pseudoalign_pair_turbo(didx, p1, p2, aux, k: int, L: int,
                           max_rows: int = 16, max_keys: int = 32768,
                           min_range: int = 0, strand_key: bool = False,
                           rl: int = 0, pos_fl: int = -1, pos_depth: int = 0):
    """Uniform-length pair batch: the length travels in aux[0]."""
    return pair_turbo_core(didx, p1, p2, aux, None, k, L, max_rows, max_keys,
                           min_range, strand_key, rl, pos_fl, pos_depth)


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
