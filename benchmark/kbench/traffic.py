"""The benchmark's data generators, NumPy only: the transcriptome of a
configuration and the reads of a traffic mix.

Frozen copies, so that later changes to the program's own generators
(kallisto_tpu_torch/utils/simtx.py and utils/benchdata.py) leave the
benchmark's inputs as they are.  The sequences are those generators'; how
fragments are spread over the transcripts (expression) and along them
(positions) is a model named in the workload file, with its parameters.
The FASTQ's BGZF blocks are compressed on a few threads (zlib releases the
interpreter lock), which gives the same bytes in less set-up time.
"""

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np

CODE_BASE = np.frombuffer(b"ACGTN", np.uint8)
_BGZF_MAX = 0xFF00
_CHUNK = 1 << 18


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream (a sample, the warm-up) of a run."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def transcriptome(path: str, n_genes: int, isoforms_per_gene: int,
                  exons_per_gene: int, exon_len_mean: int, seed: int) -> int:
    """Write a gzipped FASTA of genes as exon backbones and isoforms as exon
    subsets, so that the isoforms of a gene share long stretches (simtx's
    generate_transcriptome); returns the number of transcripts."""
    rng = np.random.default_rng(seed)
    co = zlib.compressobj(1, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    n_tx = 0
    buf = bytearray()
    with open(path, "wb") as f:
        for g in range(n_genes):
            n_ex = int(rng.integers(max(exons_per_gene - 3, 2),
                                    exons_per_gene + 4))
            ex_lens = rng.integers(exon_len_mean // 2, exon_len_mean * 2, n_ex)
            exons = [CODE_BASE[rng.integers(0, 4, n)] for n in ex_lens]
            n_iso = int(rng.integers(1, isoforms_per_gene + 1))
            for i in range(n_iso):
                keep = rng.random(n_ex) > 0.25
                keep[0] = keep[-1] = True
                seq = np.concatenate([e for e, kp in zip(exons, keep) if kp])
                if seq.shape[0] < 100:
                    continue
                buf += b">G%06d.%d\n" % (g, i)
                buf += seq.tobytes()
                buf += b"\n"
                n_tx += 1
            if len(buf) > (1 << 22):
                f.write(co.compress(bytes(buf)))
                buf.clear()
        f.write(co.compress(bytes(buf)))
        f.write(co.flush())
    return n_tx


@dataclass
class Sample:
    """One input of the closed loop: its files, its size in fragments and
    the arrays the reference reads (the benchmark's own inputs)."""
    files: list
    n: int
    data: Tuple[Any, ...]


class Pool:
    """The transcripts as one code array, for sampling fragments."""

    def __init__(self, seqs):
        self.lens = np.array([s.shape[0] for s in seqs], np.int64)
        self.codes = np.concatenate(seqs)
        self.off = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(self.lens, out=self.off[1:])


def abundances(n_tx: int, expression: dict) -> np.ndarray:
    """Each transcript's relative abundance under the workload's expression
    model, fixed by the model's own seed (the deployment's profile; the run's
    --seed draws only the reads):

    - {"model": "uniform"}: every transcript alike;
    - {"model": "lognormal", "sigma": s, "seed": n}: exp(s * N(0, 1)) a
      transcript, in the pool's order.
    """
    model = expression.get("model", "uniform")
    if model == "uniform":
        return np.ones(n_tx)
    if model == "lognormal":
        z = np.random.default_rng(int(expression["seed"])).standard_normal(n_tx)
        return np.exp(float(expression["sigma"]) * z)
    raise ValueError(f"no expression model {model!r}")


def fragments(pool: Pool, rng, n: int, read_len: int, frag_mean: float,
              frag_sd: float, expression=None, positions=None):
    """(start offset in the pool, fragment length) of n fragments from
    transcripts of at least read_len + 10 bases, each transcript drawn with
    weight abundance x length (as a library's fragments are), its length
    N(frag_mean, frag_sd) within [read_len, the transcript's length], and
    its place by the workload's position model:

    - {"model": "uniform"}: anywhere on the transcript;
    - {"model": "three_prime"}: ending at the transcript's 3' end, as a 3'
      tag library's cDNA fragments do (a 10x 3' R2 reads from the
      fragment's start towards the poly(A)).
    """
    usable = np.flatnonzero(pool.lens >= read_len + 10)
    w = abundances(pool.lens.shape[0], expression or {})[usable] \
        * pool.lens[usable].astype(np.float64)
    w /= w.sum()
    tx = usable[rng.choice(usable.shape[0], n, p=w)]
    tlen = pool.lens[tx]
    flen = np.clip(rng.normal(frag_mean, frag_sd, n).astype(np.int64),
                   read_len, None)
    flen = np.minimum(flen, tlen)
    model = (positions or {}).get("model", "uniform")
    if model == "uniform":
        start = (rng.random(n) * (tlen - flen + 1)).astype(np.int64)
    elif model == "three_prime":
        start = tlen - flen
    else:
        raise ValueError(f"no position model {model!r}")
    return pool.off[tx] + start, flen


def _errors(rng, r: np.ndarray, rate: float) -> None:
    nerr = rng.binomial(r.size, rate)
    pos = rng.integers(0, r.size, nerr)
    flat = r.reshape(-1)
    flat[pos] = (flat[pos] + rng.integers(1, 4, nerr).astype(np.uint8)) % 4


def paired(pool: Pool, rng, n: int, read_len: int, frag_mean: float,
           frag_sd: float, error_rate: float, expression=None,
           positions=None):
    """n distinct fragments as mates [n, read_len] uint8 codes: mate 1 the
    fragment's start on the sense strand, mate 2 its end reverse-
    complemented, each base changed at error_rate (benchdata's
    generate_paired), the fragments as fragments() draws them."""
    base, flen = fragments(pool, rng, n, read_len, frag_mean, frag_sd,
                           expression, positions)
    ar = np.arange(read_len)[None, :]
    r1 = pool.codes[base[:, None] + ar]
    r2 = 3 - pool.codes[base[:, None] + (flen - 1)[:, None] - ar]
    for r in (r1, r2):
        _errors(rng, r, error_rate)
    return r1, r2


def sense(pool: Pool, rng, n: int, read_len: int, frag_mean: float,
          frag_sd: float, error_rate: float, expression=None,
          positions=None) -> np.ndarray:
    """n sense-strand reads (a 10x 3' library's cDNA read): each
    fragment's first read_len bases, as paired's mate 1."""
    base, _ = fragments(pool, rng, n, read_len, frag_mean, frag_sd,
                        expression, positions)
    r = pool.codes[base[:, None] + np.arange(read_len)[None, :]]
    _errors(rng, r, error_rate)
    return r


def barcode_pool(n_barcodes: int, bc_len: int, seed: int) -> np.ndarray:
    """The cells' barcodes, fixed by the configuration."""
    return np.random.default_rng(seed).integers(
        0, 4, (n_barcodes, bc_len), dtype=np.uint8)


def barcode_reads(bcs: np.ndarray, rng, n: int, umi_len: int) -> np.ndarray:
    """Read 1 of n reads: a barcode drawn from bcs, then a random UMI
    (benchdata's generate_10x_r1)."""
    bc = bcs[rng.integers(0, bcs.shape[0], n)]
    umi = rng.integers(0, 4, (n, umi_len), dtype=np.uint8)
    return np.concatenate([bc, umi], axis=1)


def _bgzf_block(payload: bytes, level: int = 1) -> bytes:
    comp = zlib.compress(payload, level, wbits=-15)
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + b"\x06\x00\x42\x43\x02\x00"
            + (len(comp) + 25).to_bytes(2, "little")
            + comp
            + zlib.crc32(payload).to_bytes(4, "little")
            + len(payload).to_bytes(4, "little"))


def write_fastq(path: str, codes: np.ndarray, prefix: bytes,
                threads: int = 4) -> None:
    """codes [n, L] -> a BGZF FASTQ (gzip members with the BC extra field,
    which every gzip reader reads and block-parallel readers split), read
    names @<prefix><10 digits>, qualities all 'I'."""
    n, L = codes.shape
    rec = 12 + 1 + L + 1 + 2 + L + 1
    with open(path, "wb") as f, ThreadPoolExecutor(threads) as ex:
        pending = b""
        for lo in range(0, n, _CHUNK):
            hi = min(lo + _CHUNK, n)
            ids = np.arange(lo, hi)
            buf = np.empty((hi - lo, rec), np.uint8)
            buf[:, 0] = ord("@")
            buf[:, 1] = prefix[0]
            for d in range(9, -1, -1):
                buf[:, 2 + d] = 48 + ids % 10
                ids = ids // 10
            buf[:, 12] = 10
            buf[:, 13:13 + L] = CODE_BASE[codes[lo:hi]]
            buf[:, 13 + L] = 10
            buf[:, 14 + L] = ord("+")
            buf[:, 15 + L] = 10
            buf[:, 16 + L:16 + 2 * L] = ord("I")
            buf[:, 16 + 2 * L] = 10
            data = pending + buf.tobytes()
            cut = len(data) - len(data) % _BGZF_MAX
            if hi == n:
                cut = len(data)
            blocks = [data[i:i + _BGZF_MAX] for i in range(0, cut, _BGZF_MAX)]
            pending = data[cut:]
            for b in ex.map(_bgzf_block, blocks):
                f.write(b)
        f.write(_bgzf_block(b""))  # BGZF end-of-file marker
        # on disk before the window opens: no writeback of set-up's files
        # competes with the measured work
        f.flush()
        os.fsync(f.fileno())
