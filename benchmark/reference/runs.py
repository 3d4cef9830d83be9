"""The reference's answer for one `quant` sample and one `bus` library
slice, computed in blocks of reads on the reference's device."""

from typing import Any, NamedTuple

import numpy as np
import torch

from . import align
from .em import effective_lengths, run_em
from .kmers import RefIndex

BLOCK = 1 << 18


def _rows_to_classes(rows: torch.Tensor, T: int, into: dict) -> None:
    if rows.shape[0] == 0:
        return
    u, c = torch.unique(rows, dim=0, return_counts=True)
    for row, n in zip(u.cpu().numpy().tolist(), c.cpu().numpy().tolist()):
        key = tuple(x for x in row if x < T)
        into[key] = into.get(key, 0) + n


class QuantAnswer(NamedTuple):
    n: int
    classes: dict          # {transcripts: fragments}
    flens: np.ndarray      # [MAX_FRAG_LEN] int64
    est_counts: np.ndarray  # [T] f64
    distinct_kmers: int    # distinct indexed k-mers of the sample's reads
    boot: Any = None       # bootstrap.Replicates where the run draws them


def _to(a: np.ndarray, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def quant(ref: RefIndex, c1, l1, c2, l2, em_dtype=torch.float64) -> QuantAnswer:
    """Paired reads (codes [n, L] uint8, lengths [n]) -> kallisto's answer
    with the fragment-length distribution estimated from the pairs."""
    dev, T = ref.device, ref.T
    classes, kms, tls = {}, [], []
    n = c1.shape[0]
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        s1 = align.side(ref, _to(c1[lo:hi], dev), _to(l1[lo:hi], dev))
        s2 = align.side(ref, _to(c2[lo:hi], dev), _to(l2[lo:hi], dev))
        rows = align.pair(ref, s1, s2)
        mapped = rows[:, 0] < T
        _rows_to_classes(rows[mapped], T, classes)
        tl = align.fragment_lengths(ref, s1, s2, rows)
        tls.append(tl[tl >= 0].cpu().numpy())
        kms += [s1.kmers, s2.kmers]
    tl = np.concatenate(tls)[: align.FLD_GOAL]
    flens = np.bincount(tl, minlength=align.MAX_FRAG_LEN).astype(np.int64)
    eff = effective_lengths(ref.lens, flens)
    est = run_em(classes, T, eff, dtype=em_dtype)
    distinct = int(torch.unique(torch.cat(kms)).shape[0])
    return QuantAnswer(n, classes, flens, est, distinct)


def pack_dna(codes: np.ndarray):
    """2-bit big-endian value of each row (N as G) and kallisto's flag:
    min(N count, 3) | first N position << 2 (BUSData.cpp stringToBinary)."""
    L = codes.shape[1]
    v = np.zeros(codes.shape[0], np.uint64)
    for j in range(L):
        c = np.where(codes[:, j] >= 4, 2, codes[:, j]).astype(np.uint64)
        v = (v << np.uint64(2)) | c
    isn = codes >= 4
    num = np.minimum(isn.sum(axis=1), 3).astype(np.uint32)
    first = np.where(isn.any(axis=1), isn.argmax(axis=1), 0).astype(np.uint32)
    return v, np.where(num > 0, num | ((first & 31) << 2), 0).astype(np.uint32)


class BusAnswer(NamedTuple):
    n: int
    classes: dict          # {transcripts: reads}
    records: np.ndarray    # sorted (barcode, UMI, class id, count, flags)
    class_ids: dict        # {transcripts: class id} used in records
    distinct_kmers: int


REC = np.dtype([("barcode", "<u8"), ("UMI", "<u8"), ("cls", "<i8"),
                ("count", "<u4"), ("flags", "<u4")])


def bus(ref: RefIndex, bc_codes, umi_codes, cdna, lens, strand: str = "fr",
        fingerprint_bits=None):
    """One record per pseudoaligned read (barcode, UMI, its class, count 1,
    the barcode's and UMI's N flags), kallisto bus on a single-end cDNA
    read with the technology's strand filter.  fingerprint_bits: the
    control, k-mers looked up by a fingerprint of that many bits."""
    if strand != "fr":
        raise ValueError(f"strand {strand!r}: the reference models fr only")
    if fingerprint_bits:
        ref = ref.fingerprinted(fingerprint_bits)
    dev, T = ref.device, ref.T
    classes, kms, rows_all = {}, [], []
    n = cdna.shape[0]
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        s = align.side(ref, _to(cdna[lo:hi], dev), _to(lens[lo:hi], dev))
        rows = align.strand_fr(ref, s, s.rows)
        rows_all.append(rows)
        kms.append(s.kmers)
    rows = torch.cat(rows_all)
    keep = rows[:, 0] < T
    _rows_to_classes(rows[keep], T, classes)
    ids = {c: i for i, c in enumerate(sorted(classes))}
    u, inv = torch.unique(rows[keep], dim=0, return_inverse=True)
    uid = np.array([ids[tuple(x for x in row if x < T)]
                    for row in u.cpu().numpy().tolist()], np.int64)
    mapped = keep.cpu().numpy()
    bc, bcf = pack_dna(bc_codes[mapped])
    um, umf = pack_dna(umi_codes[mapped])
    rec = np.zeros(int(mapped.sum()), REC)
    rec["barcode"], rec["UMI"] = bc, um
    rec["cls"] = uid[inv.cpu().numpy()] if uid.size else 0
    rec["count"] = 1
    rec["flags"] = bcf | (umf << 8)
    rec.sort(order=["barcode", "UMI", "cls", "count", "flags"])
    distinct = int(torch.unique(torch.cat(kms)).shape[0])
    return BusAnswer(n, classes, rec, ids, distinct)
