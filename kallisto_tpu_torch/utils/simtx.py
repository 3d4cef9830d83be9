"""Synthetic human-scale transcriptome generator.

Builds a deterministic ~100k-target transcriptome with realistic isoform
structure: genes are exon backbones and isoforms are exon subsets, so
transcripts of one gene share long identical stretches (the mosaic-EC /
shared-k-mer structure that makes real transcriptomes hard).  Scale
matches GENCODE-class inputs (~1e5 targets, ~1.5e8 bases, ~1e8 distinct
k-mers), where the reference builds its index in minutes
(reference: README.md:9-10 of the reference kallisto source).

No reference-code counterpart; this stands in for a human FASTA offline.
"""

import gzip
import os
import zlib

import numpy as np

CODE_BASE = np.frombuffer(b"ACGT", np.uint8)


def generate_transcriptome(
    out_path: str,
    n_genes: int = 20000,
    isoforms_per_gene: int = 5,
    exons_per_gene: int = 8,
    exon_len_mean: int = 250,
    seed: int = 42,
) -> int:
    """Write a gzipped FASTA; returns the number of transcripts."""
    rng = np.random.default_rng(seed)
    f = open(out_path, "wb")
    co = zlib.compressobj(1, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    n_tx = 0
    buf = bytearray()
    for g in range(n_genes):
        n_ex = int(rng.integers(max(exons_per_gene - 3, 2), exons_per_gene + 4))
        ex_lens = rng.integers(
            exon_len_mean // 2, exon_len_mean * 2, n_ex
        )
        exons = [CODE_BASE[rng.integers(0, 4, l)] for l in ex_lens]
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
    f.close()
    return n_tx


def ensure_transcriptome(cache_dir: str, n_genes: int = 20000) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"simtx_{n_genes}.fasta.gz")
    if not os.path.exists(path):
        generate_transcriptome(path + ".tmp", n_genes=n_genes)
        os.rename(path + ".tmp", path)
    return path
