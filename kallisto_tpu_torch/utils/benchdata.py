"""Synthetic benchmark data generators: paired-end short reads, 10x read
1 barcodes, long cDNA reads.

Simulates DISTINCT reads from the bundled test transcriptome (fragment
sampling + sequencing errors), so throughput benchmarks are not flattered
by duplicate-read artifacts (tiling a small FASTQ produces every read
260x, which any dedup/caching layer would exploit).  Deterministic
(seeded) and vectorized; 10M pairs generate in ~1 min and are cached.

No reference-code counterpart: the reference repo benchmarks on real
sequencing data (README.md:7-9); this generator stands in for it offline.
"""

import gzip
import os
import zlib

import numpy as np

CODE_BASE = np.frombuffer(b"ACGTN", np.uint8)
BASE_CODE = np.full(256, 4, np.uint8)
for _c, _v in ((65, 0), (67, 1), (71, 2), (84, 3)):
    BASE_CODE[_c] = _v
    BASE_CODE[_c + 32] = _v


def _load_transcripts(fasta_path):
    from ..io.fastx import read_fasta

    seqs = []
    rng = np.random.default_rng(7)
    for _, s in read_fasta(fasta_path):
        c = BASE_CODE[np.frombuffer(s.encode(), np.uint8)]
        # replace non-ACGT with random bases: code 4 would underflow the
        # revcomp (3 - c) and error-injection arithmetic below
        n = c >= 4
        if n.any():
            c = c.copy()
            c[n] = rng.integers(0, 4, int(n.sum()), dtype=np.uint8)
        seqs.append(c)
    return seqs


def _write_fastq_gz(path, codes, prefix, qual=b"I", level=1):
    """codes: [n, L] uint8 base codes -> BGZF-framed gzipped FASTQ.

    BGZF (bgzip framing: gzip members carrying the BC block-size extra
    subfield) is readable by every gzip consumer AND lets the native
    reader decompress block-parallel (kallisto_tpu/native/ktio.cpp); plain
    single-stream zlib caps at ~170 MB/s on one core, far below what a
    TPU-fed pipeline needs."""
    n, L = codes.shape
    name_w = 12  # "@r%010d"
    rec = name_w + 1 + L + 1 + 2 + L + 1
    chunk = 1 << 18
    comp_f = open(path, "wb")
    ids = np.arange(n)
    digits = np.empty((n, 10), np.uint8)
    x = ids.copy()
    for d in range(9, -1, -1):
        digits[:, d] = 48 + (x % 10)
        x //= 10
    MAX = 0xFF00

    def emit_block(payload: bytes):
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        bsize = len(comp) + 25 + 1
        comp_f.write(
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + b"\x06\x00\x42\x43\x02\x00"
            + (bsize - 1).to_bytes(2, "little")
            + comp
            + zlib.crc32(payload).to_bytes(4, "little")
            + len(payload).to_bytes(4, "little")
        )

    pending = bytearray()
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m = hi - lo
        buf = np.empty((m, rec), np.uint8)
        buf[:, 0] = ord("@")
        buf[:, 1] = ord(prefix)
        buf[:, 2:12] = digits[lo:hi]
        buf[:, 12] = 10
        buf[:, 13 : 13 + L] = CODE_BASE[codes[lo:hi]]
        buf[:, 13 + L] = 10
        buf[:, 14 + L] = ord("+")
        buf[:, 15 + L] = 10
        buf[:, 16 + L : 16 + 2 * L] = qual[0]
        buf[:, 16 + 2 * L] = 10
        pending += buf.tobytes()
        while len(pending) >= MAX:
            emit_block(bytes(pending[:MAX]))
            del pending[:MAX]
    if pending:
        emit_block(bytes(pending))
    emit_block(b"")  # BGZF EOF marker
    comp_f.close()


def generate_paired(
    fasta_path: str,
    out1: str,
    out2: str,
    n_pairs: int,
    read_len: int = 50,
    frag_mean: float = 180.0,
    frag_sd: float = 20.0,
    error_rate: float = 0.005,
    seed: int = 20260820,
):
    """Simulate n_pairs distinct fragments; write FASTQ.gz mates."""
    rng = np.random.default_rng(seed)
    seqs = _load_transcripts(fasta_path)
    lens = np.array([s.shape[0] for s in seqs])
    usable = np.flatnonzero(lens >= read_len + 10)
    w = lens[usable].astype(np.float64)
    w /= w.sum()
    pool = np.concatenate([seqs[i] for i in usable])
    off = np.zeros(usable.shape[0] + 1, np.int64)
    np.cumsum(lens[usable], out=off[1:])

    tx = rng.choice(usable.shape[0], n_pairs, p=w)
    tlen = lens[usable][tx]
    flen = np.clip(
        rng.normal(frag_mean, frag_sd, n_pairs).astype(np.int64),
        read_len, None,
    )
    flen = np.minimum(flen, tlen)
    start = (rng.random(n_pairs) * (tlen - flen + 1)).astype(np.int64)
    base = off[tx] + start

    idx1 = base[:, None] + np.arange(read_len)[None, :]
    r1 = pool[idx1]
    idx2 = base[:, None] + (flen - 1)[:, None] - np.arange(read_len)[None, :]
    r2 = 3 - pool[idx2]  # reverse complement

    for r in (r1, r2):
        nerr = rng.binomial(n_pairs * read_len, error_rate)
        pos = rng.integers(0, n_pairs * read_len, nerr)
        r.reshape(-1)[pos] = (
            r.reshape(-1)[pos] + rng.integers(1, 4, nerr).astype(np.uint8)
        ) % 4

    _write_fastq_gz(out1, r1, "a")
    _write_fastq_gz(out2, r2, "b")


def generate_10x_r1(path: str, n: int, n_barcodes: int = 4096,
                    seed: int = 11):
    """10xv2-shaped read 1 for `bus -x 10xv2`: a 16 bp barcode drawn from
    a pool of n_barcodes (a whitelist-like set of cells) followed by a
    10 bp random UMI, for n reads (port of bench_bus.py's R1 maker)."""
    rng = np.random.default_rng(seed)
    bcs = rng.integers(0, 4, (n_barcodes, 16), dtype=np.uint8)
    bc = bcs[rng.integers(0, bcs.shape[0], n)]
    umi = rng.integers(0, 4, (n, 10), dtype=np.uint8)
    _write_fastq_gz(path, np.concatenate([bc, umi], axis=1), "c")


def _long_piece(rng, seqs, min_len: int, max_len: int) -> np.ndarray:
    """A whole or 5'-truncated transcript (the 3' end kept, as oligo-dT
    primed cDNA is), min_len..max_len bases (shorter transcripts whole)."""
    s = seqs[int(rng.integers(len(seqs)))]
    hi = min(max_len, s.shape[0])
    lo = min(min_len, hi)
    n = hi if rng.random() < 0.3 else int(rng.integers(lo, hi + 1))
    return s[s.shape[0] - n:].copy()


def generate_long_reads(fasta_path: str, out_path: str, n_reads: int,
                        seed: int = 5, novel_frac: float = 0.0,
                        chimera_frac: float = 0.0, mosaic_frac: float = 0.0,
                        short_frac: float = 0.0, n_rate: float = 0.0):
    """Long cDNA reads shaped like an Iso-Seq or ONT cDNA run, as one
    gzipped FASTQ: whole or 5'-truncated transcripts of 600-5,500 bases
    (shorter transcripts whole) with 1 % substitutions, half of them
    reverse-complemented, and N at n_rate per base; a novel_frac share of
    random sequence (reads no index should place), a chimera_frac share
    joining 3-8 transcripts (each piece on its own strand), a mosaic_frac
    share joining 140-180 pieces of 60-120 bases of random transcripts
    (reads past 128 groups, and past 64 distinct EC rows on a
    transcriptome with enough of them) and a short_frac share shorter than
    31 bases.  Returns the 0-based indices of the random reads."""
    min_len, max_len, sub_rate = 600, 5500, 0.01
    rng = np.random.default_rng(seed)
    seqs = _load_transcripts(fasta_path)
    p_tx = 1.0 - novel_frac - chimera_frac - mosaic_frac - short_frac
    kinds = rng.choice(5, n_reads, p=[p_tx, novel_frac, chimera_frac,
                                      short_frac, mosaic_frac])

    def mutate(r):
        sub = rng.random(r.shape[0]) < sub_rate
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        return (3 - r)[::-1] if rng.random() < 0.5 else r

    with gzip.open(out_path, "wb", compresslevel=1) as f:
        buf = []
        for i in range(n_reads):
            kind = kinds[i]
            if kind == 1:
                r = rng.integers(0, 4, int(rng.integers(min_len, max_len + 1)),
                                 dtype=np.uint8)
            elif kind == 2:
                r = np.concatenate([
                    mutate(_long_piece(rng, seqs, min_len, max_len))
                    for _ in range(int(rng.integers(3, 9)))])
            elif kind == 4:
                r = np.concatenate([
                    mutate(_long_piece(rng, seqs, 60, 120))
                    for _ in range(int(rng.integers(140, 181)))])
            else:
                r = mutate(_long_piece(rng, seqs, min_len, max_len))
                if kind == 3:
                    r = r[: int(rng.integers(1, 31))]
            c = CODE_BASE[r]
            if n_rate > 0:
                c[rng.random(c.shape[0]) < n_rate] = ord("N")
            buf.append(b"@l%d\n%s\n+\n%s\n" % (i, c.tobytes(),
                                               b"I" * c.shape[0]))
            if len(buf) >= 1024:
                f.write(b"".join(buf))
                buf = []
        f.write(b"".join(buf))
    return np.flatnonzero(kinds == 1)


def ensure_bench_data(cache_dir: str, fasta_path: str, n_pairs: int):
    """Create (or reuse) the benchmark dataset; returns (r1, r2) paths."""
    os.makedirs(cache_dir, exist_ok=True)
    tag = f"{n_pairs}b"  # 'b': BGZF-framed cache generation
    r1 = os.path.join(cache_dir, f"bench_{tag}_1.fastq.gz")
    r2 = os.path.join(cache_dir, f"bench_{tag}_2.fastq.gz")
    if not (os.path.exists(r1) and os.path.exists(r2)):
        generate_paired(fasta_path, r1 + ".tmp", r2 + ".tmp", n_pairs)
        os.rename(r1 + ".tmp", r1)
        os.rename(r2 + ".tmp", r2)
    return r1, r2
