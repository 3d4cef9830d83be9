"""Comma-free code (CFC) translation for --aa mode.

The reference reverse-translates amino acids to a fixed 3-nt comma-free
code (reference: cfc_aa_map, src/common.cpp:8-34) and translates
nucleotide reads codon-by-codon through the standard genetic code to the
same CFC alphabet (reference: cfc_map + nn_to_cfc, src/KmerIndex.cpp:
19-138, 125-138 in common).  Stop codons and anything containing non-ACGT
map to NNN (never matched).
"""

from typing import Tuple

import numpy as np

# amino acid -> comma-free 3-nt code (reference: src/common.cpp:8-34)
CFC_AA = {
    "F": "ACC", "L": "ACA", "I": "ATA", "M": "ATC", "V": "ATT",
    "S": "CTA", "P": "CTC", "T": "CTT", "A": "AGA", "Y": "AGC",
    "H": "AGT", "Q": "AGG", "N": "CGA", "K": "CGC", "D": "CGT",
    "E": "CGG", "C": "TGA", "W": "TGC", "R": "TGT", "G": "TGG",
    "X": "NNN", "B": "CGT", "J": "ACA", "Z": "CGG",
}

# standard genetic code: codon -> amino acid ('*' = stop -> NNN)
_GENCODE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "AGT": "S", "AGC": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}
_CODE = "ACGT"


def _cfc_codes(cfc: str) -> list:
    return [4 if c == "N" else _BASE[c] for c in cfc]


# codon id (c0*16 + c1*4 + c2; 64 = invalid) -> 3 CFC base codes
CODON_CFC = np.full((65, 3), 4, np.uint8)
for _codon, _aa in _GENCODE.items():
    if _aa == "*":
        continue
    _cid = _BASE[_codon[0]] * 16 + _BASE[_codon[1]] * 4 + _BASE[_codon[2]]
    CODON_CFC[_cid] = _cfc_codes(CFC_AA[_aa])


def aa_to_cfc(aa_seq: str) -> str:
    """Reverse-translate an amino-acid string to CFC nucleotides
    (reference: AA_to_cfc, src/KmerIndex.cpp:96-123); unknown AAs -> NNN."""
    return "".join(CFC_AA.get(c.upper(), "NNN") for c in aa_seq)


def nt_to_cfc_codes(
    codes: np.ndarray, lens: np.ndarray, frame: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Translate nucleotide base-code reads to CFC base codes in `frame`.

    codes: [B, L] uint8 (4 = N/pad); returns (cfc [B, 3*nc] uint8,
    cfc_lens [B] int32) where nc = (L - frame) // 3; incomplete trailing
    codons become NNN and are excluded from cfc_lens
    (reference: nn_to_cfc, src/common.cpp).
    """
    B, L = codes.shape
    nc = max((L - frame) // 3, 0)
    if nc == 0:
        return np.full((B, 0), 4, np.uint8), np.zeros(B, np.int32)
    c = codes[:, frame : frame + 3 * nc].reshape(B, nc, 3).astype(np.int64)
    bad = (c >= 4).any(axis=2)
    cid = np.where(bad, 64, c[:, :, 0] * 16 + c[:, :, 1] * 4 + c[:, :, 2])
    out = CODON_CFC[cid].reshape(B, 3 * nc)
    cfc_lens = 3 * (np.maximum(lens - frame, 0) // 3).astype(np.int32)
    return out, cfc_lens


_CHAR_CODE = np.full(256, 4, np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CHAR_CODE[ord(_ch)] = _v
    _CHAR_CODE[ord(_ch.lower())] = _v
_OUT_CHARS = np.frombuffer(b"ACGTN", np.uint8)


def nt_to_cfc_str(s: str) -> str:
    """Translate a nucleotide string codon-by-codon to a CFC string
    (full codons only; stops/invalid -> NNN).  String-level counterpart
    of nt_to_cfc_codes (reference: nn_to_cfc, src/KmerIndex.cpp:118-138);
    used for --aa D-list frame expansion."""
    b = np.frombuffer(s.encode(), np.uint8)
    c = _CHAR_CODE[b]
    nc = c.shape[0] // 3
    if nc == 0:
        return ""
    c3 = c[: 3 * nc].reshape(nc, 3).astype(np.int64)
    bad = (c3 >= 4).any(axis=1)
    cid = np.where(bad, 64, c3[:, 0] * 16 + c3[:, 1] * 4 + c3[:, 2])
    return bytes(_OUT_CHARS[CODON_CFC[cid].reshape(-1)]).decode()


def revcomp_str(s: str) -> str:
    """Reverse complement with non-ACGT -> N (reference: revcomp,
    src/common.cpp:36-53)."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A",
            "a": "T", "c": "G", "g": "C", "t": "A"}
    return "".join(comp.get(ch, "N") for ch in reversed(s))


def revcomp_codes(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-read reverse complement of a padded code matrix (pads stay 4)."""
    B, L = codes.shape
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    out = np.full_like(codes, 4)
    pos = np.arange(L)[None, :]
    src = lens[:, None] - 1 - pos
    take = src >= 0
    rowi = np.broadcast_to(np.arange(B)[:, None], src.shape)
    out[take] = comp[rowi[take], src[take]]
    return out
