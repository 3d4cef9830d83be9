"""FASTA and FASTQ parsing for the reference (plain Python and NumPy)."""

import gzip

import numpy as np

N_CODE = 4
_CODE = np.full(256, N_CODE, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i


def _open(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    return gzip.open(path, "rb") if magic == b"\x1f\x8b" else open(path, "rb")


def codes_of(seq: bytes) -> np.ndarray:
    """Bases -> codes 0..3 (A, C, G, T), 4 for any other character."""
    return _CODE[np.frombuffer(seq, np.uint8)]


def read_transcripts(path):
    """(names, sequences as code arrays, lengths) of a transcript FASTA,
    sanitized as kallisto's index does: upper case, U read as T, a poly-A
    tail of 10 or more bases clipped (the length stays the unclipped one),
    the name cut at the first space.  kallisto fills other characters with
    seeded random bases; the reference refuses them instead."""
    names, seqs, lens = [], [], []
    name, parts = None, []

    def flush():
        s = b"".join(parts).upper().replace(b"U", b"T")
        c = codes_of(s)
        if (c == N_CODE).any():
            raise ValueError(f"{name}: a base other than A, C, G, T, U")
        lens.append(len(s))
        if len(s) >= 10 and s.endswith(b"A" * 10):
            c = c[: len(s.rstrip(b"A"))]
        names.append(name)
        seqs.append(c)

    with _open(path) as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    flush()
                name, parts = line[1:].split(b" ", 1)[0].decode(), []
            elif line:
                parts.append(line)
    if name is not None:
        flush()
    return names, seqs, np.array(lens, np.int64)


def read_fastq(path):
    """(codes [n, Lmax] uint8 padded with 4, lens [n] int64) of a FASTQ."""
    seqs = []
    with _open(path) as f:
        while True:
            head = f.readline()
            if not head:
                break
            if not head.strip():
                continue
            seqs.append(f.readline().rstrip(b"\r\n"))
            f.readline()
            f.readline()
    lens = np.array([len(s) for s in seqs], np.int64)
    out = np.full((len(seqs), int(lens.max(initial=1))), N_CODE, np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = codes_of(s)
    return out, lens
