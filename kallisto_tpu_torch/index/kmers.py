"""Vectorized (numpy, host-side) k-mer packing utilities.

Conventions match Bifrost's 2-bit packing (ext/bifrost/src/Kmer.cpp:95-130):
A=0, C=1, G=2, T=3, first base in the most-significant bits, so unsigned
integer comparison of packed k-mers equals lexicographic comparison and the
canonical representative rep() = min(kmer, revcomp(kmer)).

k <= 31 fits one uint64 (the reference's default MAX_KMER_SIZE build).
"""

import numpy as np


def pack_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All forward k-mers of a code vector.

    codes: [L] uint8 in {0..4}.
    Returns (kmers [L-k+1] uint64, valid [L-k+1] bool); a k-mer is valid when
    its window contains no non-ACGT code.
    """
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool)
    c = codes.astype(np.uint64)
    km = np.zeros(n, np.uint64)
    for d in range(k):
        km = (km << np.uint64(2)) | c[d : d + n]
    bad = (codes >= 4).astype(np.int32)
    w = np.convolve(bad, np.ones(k, np.int32), mode="valid")
    return km, w == 0


def revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (numpy bit-twiddling)."""
    x = ~kmers  # complement: A<->T, C<->G under the 2-bit code
    # reverse 2-bit groups within 64 bits
    x = ((x & np.uint64(0x3333333333333333)) << np.uint64(2)) | (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333)
    )
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | (
        (x >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
    )
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | (
        (x >> np.uint64(8)) & np.uint64(0x00FF00FF00FF00FF)
    )
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | (
        (x >> np.uint64(16)) & np.uint64(0x0000FFFF0000FFFF)
    )
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    # packed k-mers occupy the LOW 2k bits in our layout; after a full 64-bit
    # reverse the k-mer sits in the HIGH bits -> shift back down
    return x >> np.uint64(64 - 2 * k)


def canonicalize(kmers: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (canonical kmers, is_forward) where is_forward marks kmers
    already in canonical orientation (fw <= rc)."""
    rc = revcomp_kmers(kmers, k)
    fw = kmers <= rc
    return np.where(fw, kmers, rc), fw


def kmer_to_string(kmer: int, k: int) -> str:
    return "".join("ACGT"[(int(kmer) >> (2 * (k - 1 - i))) & 3] for i in range(k))


def string_to_kmer(s: str) -> int:
    v = 0
    for ch in s:
        v = (v << 2) | "ACGT".index(ch)
    return v


def seq_kmers_canonical(codes: np.ndarray, k: int):
    """(canonical kmers, valid mask, is_forward) for one sequence."""
    km, valid = pack_kmers(codes, k)
    canon, fw = canonicalize(km, k)
    return canon, valid, fw


def scan_canonical(codes: np.ndarray, k: int):
    """All windows of a code vector -> (canonical kmers, is_fw, valid).

    numpy pack + canonicalize over the whole vector.
    """
    km, valid = pack_kmers(codes, k)
    canon, is_fw = canonicalize(km, k)
    return canon, is_fw, valid
