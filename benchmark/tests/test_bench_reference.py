"""The plain reference reproduces reference kallisto 0.51.1's own outputs
on the bundled data (tests/golden, made by the kallisto binary): so its
rules are kallisto's and not the program's."""

import os
import struct

import numpy as np
import pytest
import torch

from kbench import harness
from reference import em, kmers, runs, seqio

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "tests", "data")
GOLD = os.path.join(ROOT, "tests", "golden")
Bus = harness.load_file(os.path.join(harness.BENCH_DIR, "entries", "bus.py"),
                        "benchmark_entry_").Entry


@pytest.fixture(scope="module")
def ref():
    names, seqs, lens = seqio.read_transcripts(
        os.path.join(DATA, "transcripts.fasta.gz"))
    return kmers.build_ref_index(names, seqs, lens)


def _sig6(x):
    return float(f"{x:.6g}")


def test_quant_paired_matches_kallisto(ref):
    c1, l1 = seqio.read_fastq(os.path.join(DATA, "reads_1.fastq.gz"))
    c2, l2 = seqio.read_fastq(os.path.join(DATA, "reads_2.fastq.gz"))
    ans = runs.quant(ref, c1, l1, c2, l2)
    info = open(os.path.join(GOLD, "quant_paired", "run_info.json")).read()
    assert f'"n_processed": {ans.n},' in info
    assert f'"n_pseudoaligned": {sum(ans.classes.values())},' in info
    unique = sum(c for s, c in ans.classes.items() if len(s) == 1)
    assert f'"n_unique": {unique},' in info
    rows = [line.split("\t") for line in open(
        os.path.join(GOLD, "quant_paired", "abundance.tsv")).read()
        .splitlines()[1:]]
    assert [r[0] for r in rows] == ref.names
    # abundance.tsv prints 6 significant digits
    eff = em.effective_lengths(ref.lens, ans.flens)
    assert [_sig6(x) for x in eff] == [float(r[2]) for r in rows]
    assert [_sig6(x) for x in ans.est_counts] == [float(r[3]) for r in rows]


def test_em_in_float32_departs_from_float64(ref):
    c1, l1 = seqio.read_fastq(os.path.join(DATA, "reads_1.fastq.gz"))
    c2, l2 = seqio.read_fastq(os.path.join(DATA, "reads_2.fastq.gz"))
    a = runs.quant(ref, c1, l1, c2, l2)
    b = runs.quant(ref, c1, l1, c2, l2, em_dtype=torch.float32)
    assert a.classes == b.classes
    assert np.max(np.abs(a.est_counts - b.est_counts)
                  / np.maximum(a.est_counts, 1)) > 1e-7


def test_bus_10xv2_matches_kallisto(ref, tmp_path):
    c1, _ = seqio.read_fastq(os.path.join(DATA, "sc_reads_1.fastq.gz"))
    c2, l2 = seqio.read_fastq(os.path.join(DATA, "sc_reads_2.fastq.gz"))
    ans = runs.bus(ref, c1[:, :16], c1[:, 16:26], c2, l2)
    gold = os.path.join(GOLD, "bus10xv2")
    with open(os.path.join(gold, "output.bus"), "rb") as f:
        assert struct.unpack("<4sIII", f.read(16)) == (b"BUS\x00", 1, 16, 10)
    got = Bus.compare({"n": ans.n, "out": gold}, ans, ans.n)
    assert got == {"processed_gap": 0, "record_gap": 0}
    assert ans.records.shape[0] == 4808
    assert (ans.records["flags"] > 0).any()  # barcodes with N


def test_bus_control_and_altered_records_are_caught(ref, tmp_path):
    c1, _ = seqio.read_fastq(os.path.join(DATA, "sc_reads_1.fastq.gz"))
    c2, l2 = seqio.read_fastq(os.path.join(DATA, "sc_reads_2.fastq.gz"))
    ans = runs.bus(ref, c1[:, :16], c1[:, 16:26], c2, l2)
    kept = Bus.as_output(ans, str(tmp_path / "same"))
    assert Bus.compare(kept, ans, ans.n)["record_gap"] == 0
    # 16-bit fingerprints, so that a 14-transcript index meets false hits
    # on 10,000 reads (the cells' control uses 32 bits on 23.9M k-mers)
    ctl = runs.bus(ref, c1[:, :16], c1[:, 16:26], c2, l2,
                   fingerprint_bits=16)
    kept = Bus.as_output(ctl, str(tmp_path / "ctl"))
    assert Bus.compare(kept, ans, ans.n)["record_gap"] > 0
