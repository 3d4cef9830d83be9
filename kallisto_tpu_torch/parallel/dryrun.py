"""Dry run of `quant` over n shards: the port's counterpart of
__graft_entry__.py::dryrun_multichip.

    python -m kallisto_tpu_torch.parallel.dryrun N [cuda|cpu]

Builds a tiny synthetic transcriptome (8 targets of 300 bp, two sharing
half their sequence) and 16 * n pairs sampled from it, then runs
`run_quant` on one device and over an n-shard mesh, twice: with the
fragment-length distribution learned (every batch per read: kernel A
sharded) and with `-l 180 -s 20` (every batch `cmesh`: kernels A and E
per shard).  Asserts equal processed counts, EC counts, EC order and
bitwise est_counts.
"""

import os
import shutil
import sys
import tempfile

import numpy as np


def _tiny_inputs(tmpdir: str, n_reads: int, n_targets: int = 8,
                 tlen: int = 300, read_len: int = 100):
    """(transcripts FASTA, mate-1 FASTQ, mate-2 FASTQ) from a fixed seed:
    each pair is a read_len window of a target, mate 2 the reverse
    complement of its second half."""
    rng = np.random.default_rng(0)
    bases = np.array(list("ACGT"))
    seqs = ["".join(rng.choice(bases, size=tlen)) for _ in range(n_targets)]
    seqs[1] = seqs[0][:150] + seqs[1][150:]  # a multi-target EC
    fasta = os.path.join(tmpdir, "tx.fasta")
    with open(fasta, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">t{i}\n{s}\n")
    f1 = os.path.join(tmpdir, "r1.fastq")
    f2 = os.path.join(tmpdir, "r2.fastq")
    half = read_len // 2
    comp = str.maketrans("ACGT", "TGCA")
    with open(f1, "w") as o1, open(f2, "w") as o2:
        for r in range(n_reads):
            start = int(rng.integers(0, tlen - read_len))
            seq = seqs[r % n_targets][start : start + read_len]
            rc = seq[half:][::-1].translate(comp)
            o1.write(f"@r{r}\n{seq[:half]}\n+\n{'I' * half}\n")
            o2.write(f"@r{r}\n{rc}\n+\n{'I' * len(rc)}\n")
    return fasta, f1, f2


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the real quant pipeline on one device and over n_devices
    shards of `device` and assert equal results; returns the sharded
    runs' batch counts by route."""
    from ..common import Options
    from ..index import build_index
    from ..quant.pipeline import run_quant

    tmpdir = tempfile.mkdtemp(prefix="kt_dryrun_")
    try:
        fasta, f1, f2 = _tiny_inputs(tmpdir, 16 * n_devices)
        index = build_index([fasta], k=31)
        routes = {}
        for tag, kw in (("fld", {}), ("l180", dict(fld_mean=180.0,
                                                    fld_sd=20.0))):
            ref, got = (run_quant(Options(files=[f1, f2], n_devices=n,
                                          batch_size=8 * n_devices, **kw),
                                  index=index, device=device)
                        for n in (1, n_devices))
            assert got.num_processed == ref.num_processed, tag
            assert np.array_equal(got.counts, ref.counts), \
                f"{tag}: EC counts diverge"
            assert len(got.ec_sets) == len(ref.ec_sets), tag
            for a, b in zip(got.ec_sets, ref.ec_sets):
                assert np.array_equal(a, b), f"{tag}: EC order diverges"
            assert np.array_equal(got.est_counts, ref.est_counts), \
                f"{tag}: est_counts diverge"
            assert got.counts.sum() > 0, tag
            routes[tag] = {r: got.timings[r] for r in ("full", "cmesh")}
        assert routes["fld"]["full"] > 0 and routes["l180"]["cmesh"] > 0, \
            routes
        return routes
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    print(dryrun_multichip(n, sys.argv[2] if len(sys.argv) > 2 else "cuda"))
