"""FASTA/FASTQ streaming readers (kseq equivalent, host side).

The reference streams 8 MB read batches through kseq + zlib
(reference: src/kseq.h, src/ProcessReads.cpp:3128-3267).  Here the host
pipeline parses FASTQ into padded uint8 code matrices ready for device
transfer; parsing is vectorized with numpy over whole decompressed chunks
rather than per-record.  `quant` reads its packed batches through the
native reader (io/native.py) instead; this reader serves `bus` (comments),
the BAM replay (qualities) and the tests, as the plain version.

Base coding: A=0, C=1, G=2, T=3 (matching the 2-bit packing of the index),
anything else (incl. N) = 4.
"""

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

# char -> code lookup (uppercase+lowercase ACGT; everything else 4)
BASE_CODE = np.full(256, 4, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    BASE_CODE[ord(_c)] = _v
    BASE_CODE[ord(_c.lower())] = _v


def _open_maybe_gz(path: str, buffering: int = 1 << 20):
    f = open(path, "rb", buffering=buffering)
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=buffering)
    return f


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (header, sequence) records from a (gzipped) FASTA file."""
    name = None
    chunks: List[bytes] = []
    with _open_maybe_gz(path) as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks).decode()
                name = line[1:].decode()
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks).decode()


@dataclass
class ReadBatch:
    """A padded batch of reads ready for device transfer.

    codes: [n, max_len] uint8 in {0..4}; positions >= lens[i] are 4.
    lens:  [n] int32 read lengths.
    names: read names (only read with keep_names); quals: the raw quality
    lines (only read with keep_quals, for BAM output); comments: the FASTQ
    header after its first space or tab, per read (only read with
    keep_comments).
    """

    codes: np.ndarray
    lens: np.ndarray
    names: Optional[List[bytes]] = None
    quals: Optional[List[bytes]] = None
    comments: Optional[List[bytes]] = None

    @property
    def n(self) -> int:
        return int(self.codes.shape[0])


class FastqStream:
    """Streaming FASTQ parser producing numpy record arrays.

    Parses whole decompressed chunks at once: finds newline offsets with
    numpy, slices sequence lines, and encodes them into a padded uint8
    matrix.  Orders of magnitude faster than per-record Python loops.
    """

    def __init__(self, path: str, keep_names: bool = False,
                 keep_quals: bool = False, keep_comments: bool = False):
        self.path = path
        self.keep_names = keep_names
        self.keep_quals = keep_quals
        self.keep_comments = keep_comments
        self._fh = _open_maybe_gz(path)
        self._tail = b""       # the partial line after the last newline
        self._lines: List[bytes] = []  # complete lines not yet handed out
        self._eof = False
        self._records_out = 0

    def close(self):
        self._fh.close()

    def _read_lines(self, n_records: int) -> List[bytes]:
        """Return up to 4*n_records complete lines (joined across chunks),
        whole records only; lines read beyond that wait for the next call,
        so every batch but the last holds exactly n_records."""
        need = 4 * n_records
        while len(self._lines) < need and not self._eof:
            chunk = self._fh.read(1 << 22)
            if not chunk:
                self._eof = True
                if self._tail:
                    self._lines.extend(self._tail.split(b"\n"))
                    self._tail = b""
                break
            parts = (self._tail + chunk).split(b"\n")
            self._tail = parts.pop()
            self._lines.extend(parts)
        if self._eof:
            # drop trailing empty line fragments and a truncated record
            while self._lines and self._lines[-1] == b"":
                self._lines.pop()
            del self._lines[len(self._lines) - len(self._lines) % 4:]
        take = min(need, len(self._lines) - len(self._lines) % 4)
        lines = self._lines[:take]
        del self._lines[:take]
        return lines

    def next_batch(self, n_records: int) -> Optional[ReadBatch]:
        lines = self._read_lines(n_records)
        if not lines:
            return None
        # format guard (reference kseq silently mis-parses; we fail with a
        # clear message). kseq skips leading junk until it sees '@' (so e.g.
        # a "\\@name" header is accepted, src/kseq.h record-start scan); we
        # accept only NON-ALPHANUMERIC junk before the '@' ('@' is quality
        # char Q31, so "contains '@'" would silently pass a phase-shifted
        # file whose header slot holds a quality line) and require '+'
        # separators.
        headers = lines[0::4]
        seps = lines[2::4]

        def _bad(h: bytes) -> bool:
            if h.startswith(b"@"):
                return False
            i = h.find(b"@")
            return i < 0 or any(chr(c).isalnum() for c in h[:i])

        bad_h = next((i for i, h in enumerate(headers) if _bad(h)), None)
        bad_s = next(
            (i for i, p in enumerate(seps) if not p.startswith(b"+")), None
        )
        if bad_h is not None or bad_s is not None:
            i = bad_h if bad_h is not None else bad_s
            what = "header" if bad_h is not None else "separator"
            raise ValueError(
                f"malformed FASTQ record in {self.path} (record "
                f"~{self._records_out + i}: bad {what} line)"
            )
        self._records_out += len(headers)
        seqs = lines[1::4]
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=len(seqs))
        max_len = int(lens.max()) if len(lens) else 0
        buf = np.full((len(seqs), max_len), 4, dtype=np.uint8)
        for i, s in enumerate(seqs):
            buf[i, : lens[i]] = BASE_CODE[np.frombuffer(s, dtype=np.uint8)]
        names = None
        if self.keep_names:
            names = [ln[1:].split(b" ", 1)[0].split(b"\t", 1)[0]
                     for ln in headers]
        quals = lines[3::4] if self.keep_quals else None
        comments = None
        if self.keep_comments:
            # kseq semantics: comment = header after the first whitespace
            # (reference: FastqSequenceReader comments path,
            # src/ProcessReads.cpp:3216-3245)
            comments = []
            for ln in headers:
                sp = ln.find(b" ")
                tb = ln.find(b"\t")
                cut = min(x for x in (sp, tb, len(ln)) if x >= 0)
                comments.append(ln[cut + 1:] if cut < len(ln) else b"")
        return ReadBatch(codes=buf, lens=lens, names=names, quals=quals,
                         comments=comments)


def single_batches(path: str, batch_reads: int, keep_names: bool = False,
                   keep_quals: bool = False,
                   keep_comments: bool = False) -> Iterator[ReadBatch]:
    s = FastqStream(path, keep_names=keep_names, keep_quals=keep_quals,
                    keep_comments=keep_comments)
    try:
        while True:
            b = s.next_batch(batch_reads)
            if b is None:
                return
            yield b
    finally:
        s.close()


class PackedBatch:
    """A batch of reads already in device upload format.

    packed: [n, Lp//4] uint8 2-bit codes; nmask: [n, Lp//8] uint8 N/pad
    bits (little bit order); lens: [n] int32; Lp: padded read length;
    names, quals: per-read names and raw quality lines when the reader was
    asked for them (BAM output), else None.
    """

    __slots__ = ("packed", "nmask", "lens", "Lp", "names", "quals")

    def __init__(self, packed, nmask, lens, Lp, names=None, quals=None):
        self.packed = packed
        self.nmask = nmask
        self.lens = lens
        self.Lp = int(Lp)
        self.names = names
        self.quals = quals

    @property
    def n(self) -> int:
        return int(self.lens.shape[0])

    def row_codes(self, i: int) -> np.ndarray:
        """Decode one read back to uint8 base codes (0..3, 4=N/pad) --
        used only for rare host-fallback re-resolution."""
        pk = np.unpackbits(self.packed[i], bitorder="little").reshape(-1, 2)
        codes = (pk[:, 0] | (pk[:, 1] << 1)).astype(np.uint8)
        nm = np.unpackbits(self.nmask[i], bitorder="little")[: codes.shape[0]]
        return np.where(nm == 1, np.uint8(4), codes)


def pack_codes_host(codes: np.ndarray):
    """Host-side 2-bit packing + N bitmask (cuts host->device bytes ~2.5x).

    Returns (packed [B, ceil(L/4)] uint8, nmask [B, ceil(L/8)] uint8, L).
    """
    B, L = codes.shape
    L4 = (L + 3) // 4
    c = np.where(codes >= 4, 0, codes).astype(np.uint8)
    if L4 * 4 != L:
        c = np.concatenate([c, np.zeros((B, L4 * 4 - L), np.uint8)], axis=1)
    c = c.reshape(B, L4, 4)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    nmask = np.packbits(codes >= 4, axis=1, bitorder="little")
    return packed, nmask, L


def _read_batch_to_packed(rb: ReadBatch, k: int, pad_to: int = 8):
    """Pad + 2-bit pack a ReadBatch: Lp = max(L, k) rounded up to pad_to,
    with padding positions marked as N."""
    B, L = rb.codes.shape
    Lp = max(((max(L, k) + pad_to - 1) // pad_to) * pad_to, pad_to)
    codes = rb.codes
    if Lp > L:
        codes = np.concatenate(
            [codes, np.full((B, Lp - L), 4, np.uint8)], axis=1
        )
    packed, nmask, _ = pack_codes_host(codes)
    return PackedBatch(packed, nmask, rb.lens, Lp, rb.names, rb.quals)


def packed_single_batches(path: str, batch_reads: int, k: int,
                          keep_names: bool = False, keep_quals: bool = False):
    """Yield PackedBatch objects from the native reader (io/native.py:
    inflate, parse and pack on native threads, batches prefetched; 4 I/O
    threads, as in JAX).
    keep_quals takes the Python reader, as in JAX (the quality lines serve
    only the BAM replay)."""
    if keep_quals:
        for rb in single_batches(path, batch_reads, keep_names, True):
            yield _read_batch_to_packed(rb, k)
        return
    from .native import NativeFastqReader

    r = NativeFastqReader(path, batch_reads, pad_to=8, min_len=k,
                          keep_names=keep_names)
    try:
        while True:
            b = r.next_batch()
            if b is None:
                return
            yield b
    finally:
        r.close()


def packed_paired_batches(path1: str, path2: str, batch_reads: int, k: int,
                          keep_names: bool = False, keep_quals: bool = False):
    """Yield aligned (PackedBatch, PackedBatch) pairs."""
    s1 = packed_single_batches(path1, batch_reads, k, keep_names, keep_quals)
    s2 = packed_single_batches(path2, batch_reads, k, keep_names, keep_quals)
    while True:
        b1 = next(s1, None)
        b2 = next(s2, None)
        if b1 is None or b2 is None:
            if (b1 is None) != (b2 is None):
                raise ValueError("paired FASTQ files have different record counts")
            return
        if b1.n != b2.n:
            raise ValueError("paired FASTQ files have different record counts")
        yield b1, b2

