"""The reference's k-mer map: every canonical k-mer of the transcripts,
the set of transcripts that hold it (its equivalence class), and where each
transcript holds it, with the block of the compacted de Bruijn graph it
lies in.  Plain PyTorch on any device.

Blocks.  kallisto cuts each unitig of the compacted graph into blocks at
every point where a transcript starts or stops covering it, and infers a
pair's fragment length only when both mates' first k-mers lie in one block
(KmerIndex::mapPair).  A block is a stretch of k-mers that a transcript
holding it holds in one piece, so the reference finds blocks along each
transcript: two consecutive k-mers of a transcript are in one block when
the step between them is a unitig edge (the first has one successor in the
graph, the second one predecessor) and they have the same transcript set.
A k-mer that a transcript holds twice is taken at its first place.
"""

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch


def _rolling(codes: torch.Tensor, k: int):
    """Forward and reverse-complement k-mer values of every window start
    of a [..., n] code tensor (codes 0..3): ([..., n - k + 1] int64) x 2."""
    c = codes.to(torch.int64)
    W = c.shape[-1] - k + 1
    f = torch.zeros(c.shape[:-1] + (W,), dtype=torch.int64, device=c.device)
    r = torch.zeros_like(f)
    for d in range(k):
        cd = c[..., d:d + W]
        f = (f << 2) | cd
        r = r | ((3 - cd) << (2 * d))
    return f, r


def _fingerprint(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The top bits of a multiplicative hash (wrapping int64 product)."""
    h = x * -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
    return (h >> (64 - bits)) & ((1 << bits) - 1)


def _member(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    i = torch.searchsorted(sorted_keys, q).clamp(max=sorted_keys.shape[0] - 1)
    return sorted_keys[i] == q


@dataclass
class RefIndex:
    k: int
    names: List[str]
    lens: np.ndarray          # [T] target lengths (unclipped)
    kmers: torch.Tensor       # [K] sorted canonical k-mers, int64
    kec: torch.Tensor         # [K] EC of each k-mer, int64
    ec_sets: torch.Tensor     # [E, M] sorted transcript ids, padded with T
    occ_key: torch.Tensor     # [O] sorted kidx * T + t of each (k-mer, t)
    occ_pos: torch.Tensor     # [O] k-mer start in t (first place), int64
    occ_fw: torch.Tensor      # [O] t's forward k-mer is the canonical one
    occ_run: torch.Tensor     # [O] block run along t, int64
    # the control's lookup by a fingerprint of fp_bits bits of each k-mer
    # (a false hit where a k-mer outside the index shares one)
    fp_bits: int = 0
    fp_sorted: Optional[torch.Tensor] = None
    fp_perm: Optional[torch.Tensor] = None

    @property
    def T(self) -> int:
        return len(self.names)

    @property
    def M(self) -> int:
        return int(self.ec_sets.shape[1])

    @property
    def device(self) -> torch.device:
        return self.kmers.device

    def fingerprinted(self, bits: int) -> "RefIndex":
        """This map with k-mers looked up by a bits-bit fingerprint."""
        fp, perm = torch.sort(_fingerprint(self.kmers, bits))
        return replace(self, fp_bits=bits, fp_sorted=fp, fp_perm=perm)

    def lookup(self, canon: torch.Tensor, valid: torch.Tensor):
        """(kidx, hit) of canonical k-mers; kidx is meaningful where hit."""
        if self.fp_bits:
            q = _fingerprint(canon, self.fp_bits)
            i = torch.searchsorted(self.fp_sorted, q)
            i = i.clamp(max=self.fp_sorted.shape[0] - 1)
            return self.fp_perm[i], valid & (self.fp_sorted[i] == q)
        kidx = torch.searchsorted(self.kmers, canon)
        kidx = kidx.clamp(max=self.kmers.shape[0] - 1)
        return kidx, valid & (self.kmers[kidx] == canon)

    def occurrence(self, kidx: torch.Tensor, t: torch.Tensor):
        """(found, pos, fw, run) of k-mer kidx in transcript t."""
        q = kidx * self.T + t
        i = torch.searchsorted(self.occ_key, q)
        i = i.clamp(max=self.occ_key.shape[0] - 1)
        return (self.occ_key[i] == q, self.occ_pos[i], self.occ_fw[i],
                self.occ_run[i])


def build_ref_index(names, seqs, lens, k: int = 31, device="cpu") -> RefIndex:
    """The map of the transcripts `seqs` (code arrays, after clipping)."""
    dev = torch.device(device)
    T = len(seqs)
    n = np.array([s.shape[0] for s in seqs], np.int64)
    allc = torch.from_numpy(np.concatenate(seqs)).to(dev)
    f, r = _rolling(allc, k)
    off = np.zeros(T + 1, np.int64)
    np.cumsum(n, out=off[1:])
    nw = np.maximum(n - k + 1, 0)
    # window starts in (transcript, position) order
    wt = np.repeat(np.arange(T, dtype=np.int64), nw)
    wq = np.arange(int(nw.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(nw) - nw, nw)
    wt_d = torch.from_numpy(wt).to(dev)
    wq_d = torch.from_numpy(wq).to(dev)
    start = torch.from_numpy(off[:-1]).to(dev)[wt_d] + wq_d
    f, r = f[start], r[start]
    del allc, start
    fw = f <= r
    canon = torch.where(fw, f, r)
    other = torch.where(fw, r, f)
    kmers, kidx = torch.unique(canon, return_inverse=True)
    K = kmers.shape[0]

    # transcript set of each k-mer, padded to the largest set
    pair = torch.unique(kidx * T + wt_d)
    pk, pt = pair // T, pair % T
    size = torch.bincount(pk, minlength=K)
    M = int(size.max())
    first = torch.cumsum(size, 0) - size
    slot = torch.arange(pair.shape[0], device=dev) - first[pk]
    mat = torch.full((K, M), T, dtype=torch.int64, device=dev)
    mat[pk, slot] = pt
    ec_sets, kec = torch.unique(mat, dim=0, return_inverse=True)
    del mat, pair, pk, pt, slot

    # degrees of each k-mer read forward (canonical orientation)
    rc_of = torch.zeros(K, dtype=torch.int64, device=dev)
    rc_of[kidx] = other
    mask = (1 << (2 * k)) - 1
    top = 2 * (k - 1)
    outdeg = torch.zeros(K, dtype=torch.int64, device=dev)
    indeg = torch.zeros(K, dtype=torch.int64, device=dev)
    for b in range(4):
        s_f = ((kmers << 2) | b) & mask
        s_r = (rc_of >> 2) | ((3 - b) << top)
        outdeg += _member(kmers, torch.minimum(s_f, s_r))
        p_f = (kmers >> 2) | (b << top)
        p_r = ((rc_of << 2) | (3 - b)) & mask
        indeg += _member(kmers, torch.minimum(p_f, p_r))
    del rc_of

    # block runs along each transcript
    x, y = kidx[:-1], kidx[1:]
    ox, oy = fw[:-1], fw[1:]
    out_x = torch.where(ox, outdeg[x], indeg[x])
    in_y = torch.where(oy, indeg[y], outdeg[y])
    cont = ((wt_d[:-1] == wt_d[1:]) & (out_x == 1) & (in_y == 1) & (x != y)
            & (kec[x] == kec[y]))
    brk = torch.ones(kidx.shape[0], dtype=torch.int64, device=dev)
    brk[1:] = (~cont).to(torch.int64)
    run = torch.cumsum(brk, 0)
    del outdeg, indeg, cont, brk

    # (k-mer, transcript) -> first place; stable sort keeps positions in order
    key = kidx * T + wt_d
    key_s, perm = torch.sort(key, stable=True)
    keep = torch.ones_like(key_s, dtype=torch.bool)
    keep[1:] = key_s[1:] != key_s[:-1]
    perm = perm[keep]
    return RefIndex(
        k=k, names=list(names), lens=np.asarray(lens, np.int64),
        kmers=kmers, kec=kec, ec_sets=ec_sets, occ_key=key_s[keep],
        occ_pos=wq_d[perm], occ_fw=fw[perm], occ_run=run[perm],
    )
