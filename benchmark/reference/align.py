"""Reads -> equivalence classes, the fragment-length histogram and the
strand filter, after kallisto 0.51.1 (ProcessReads.cpp, MinCollector.cpp,
KmerIndex::mapPair), in plain PyTorch on any device.

A class is carried as a row of M sorted transcript ids padded with T (the
number of transcripts); an empty row has no transcript."""

from typing import NamedTuple

import torch

from .kmers import RefIndex, _rolling

MAX_FRAG_LEN = 1000   # kallisto's fragment-length histogram size
FLD_GOAL = 10000      # pairs that make the estimate (ProcessReads.cpp:985)


class Side(NamedTuple):
    rows: torch.Tensor     # [B, M] the intersection of the hit k-mers' sets
    hits: torch.Tensor     # [B] some k-mer of the read is in the index
    fk: torch.Tensor       # [B] the first hit k-mer (by read position)
    ffw: torch.Tensor      # [B] the read's window there is the canonical one
    fpos: torch.Tensor     # [B] its read position
    kmers: torch.Tensor    # distinct hit k-mers of the batch


def _compact(rows: torch.Tensor, keep: torch.Tensor, T: int) -> torch.Tensor:
    return torch.sort(torch.where(keep, rows, torch.full_like(rows, T)),
                      dim=1).values


def side(ref: RefIndex, codes: torch.Tensor, lens: torch.Tensor) -> Side:
    """Pseudoalign one read per row of codes [B, L] (4 = N) of lengths
    lens [B]."""
    k, T = ref.k, ref.T
    B, L = codes.shape
    W = L - k + 1
    f, r = _rolling(codes & 3, k)
    bad = torch.cumsum((codes >= 4).to(torch.int32), dim=1)
    bad = torch.cat([torch.zeros_like(bad[:, :1]), bad], dim=1)
    pos = torch.arange(W, device=codes.device)
    valid = ((bad[:, k:] - bad[:, :W]) == 0) & (pos[None] + k <= lens[:, None])
    fw = f <= r
    kidx, hit = ref.lookup(torch.where(fw, f, r), valid)
    del f, r, bad, valid
    ec = torch.where(hit, ref.kec[kidx], torch.full_like(kidx, -1))
    hits = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.int8), dim=1)
    b = torch.arange(B, device=codes.device)
    fk, ffw = kidx[b, first], fw[b, first]
    cand = ref.ec_sets[torch.where(hits, ec[b, first], 0)]
    cand = torch.where(hits[:, None], cand, torch.full_like(cand, T))
    # every window whose class differs from the window before it
    prev = torch.cat([torch.full_like(ec[:, :1], -1), ec[:, :-1]], dim=1)
    rr, ww = torch.nonzero(hit & (ec != prev), as_tuple=True)
    member = (cand[rr][:, :, None] == ref.ec_sets[ec[rr, ww]][:, None, :]
              ).any(dim=2)
    miss = torch.zeros(cand.shape, dtype=torch.int64, device=codes.device)
    miss.index_add_(0, rr, (~member).to(torch.int64))
    rows = _compact(cand, (miss == 0) & (cand < T), T)
    return Side(rows, hits, fk, ffw, first, torch.unique(kidx[hit]))


def pair(ref: RefIndex, s1: Side, s2: Side) -> torch.Tensor:
    """The pair's class by kallisto's non-strict rule (MinCollector::
    intersectKmers): a mate with hits but an empty intersection vetoes the
    pair, a mate without hits defers to the other."""
    T = ref.T
    e1, e2 = s1.rows[:, 0] == T, s2.rows[:, 0] == T
    both = (s1.rows[:, :, None] == s2.rows[:, None, :]).any(dim=2)
    inter = _compact(s1.rows, both & (s1.rows < T), T)
    empty = torch.full_like(s1.rows, T)
    out = torch.where((~e1 & ~e2)[:, None], inter, empty)
    out = torch.where((e1 & ~e2 & ~s1.hits)[:, None], s2.rows, out)
    return torch.where((~e1 & e2 & ~s2.hits)[:, None], s1.rows, out)


def fragment_lengths(ref: RefIndex, s1: Side, s2: Side,
                     rows: torch.Tensor) -> torch.Tensor:
    """[B] the fragment length mapPair infers for pairs whose class is one
    transcript, -1 where it infers none or the length is outside
    (0, MAX_FRAG_LEN): both mates' first k-mers in one block, the mates
    on opposite strands of it."""
    T, k = ref.T, ref.k
    single = (rows[:, 0] < T) & (rows[:, 1:] == T).all(dim=1) \
        if rows.shape[1] > 1 else rows[:, 0] < T
    t = torch.where(single, rows[:, 0], torch.zeros_like(rows[:, 0]))
    ok = single & s1.hits & s2.hits
    p, sense, run = [], [], []
    for s in (s1, s2):
        found, q, ofw, rn = ref.occurrence(s.fk, t)
        ok = ok & found
        sn = s.ffw == ofw
        p.append(torch.where(sn, q - s.fpos, q + k + s.fpos))
        sense.append(sn)
        run.append(rn)
    ok = ok & (run[0] == run[1]) & (sense[0] != sense[1])
    tl = (p[0] - p[1]).abs()
    ok = ok & (tl > 0) & (tl < MAX_FRAG_LEN)
    return torch.where(ok, tl, torch.full_like(tl, -1))


def strand_fr(ref: RefIndex, s: Side, rows: torch.Tensor) -> torch.Tensor:
    """kallisto's --fr-stranded filter on a single read: keep the
    transcripts on which the read's first hit k-mer reads forward."""
    T = ref.T
    keep = rows < T
    for j in range(rows.shape[1]):
        t = torch.where(keep[:, j], rows[:, j], torch.zeros_like(rows[:, j]))
        found, _, ofw, _ = ref.occurrence(s.fk, t)
        keep[:, j] &= found & (s.ffw == ofw)
    return _compact(rows, keep, T)
