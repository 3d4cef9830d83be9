"""The port's runs over several shards (parallel/mesh.py, K18) against its
one-device runs, the JAX package's sharded runs and the goldens.

On the CPU a mesh is n logical shards of the one device, the port's form
of the 8 virtual CPU devices the JAX tests use (tests/conftest.py): each
shard runs the plain versions of kernels A, B and E on its own slice of
the batch, and the host merges the shards in mesh order.  The cases are
those of tests/test_multichip.py (paired, uneven batch, single-end,
stranded, --min-range, the stranded golden, the position filter), plus
paired runs whose FLD goal is cut to 1,000 so that their batches reach
the `cmesh` route; `bus` (test_bus.py's two mesh cases), `quant-tcc`
(cells split across shards) and the dry run.  The one-device runs are
shared through module fixtures.
"""

import os

import numpy as np
import pytest
import torch

from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
from kallisto_tpu.sc.bus import run_bus as jrun_bus
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.parallel.dryrun import dryrun_multichip
from kallisto_tpu_torch.parallel.mesh import make_mesh, n_shards
from kallisto_tpu_torch.quant.pipeline import run_quant
from kallisto_tpu_torch.quant.tcc import run_quant_tcc
from kallisto_tpu_torch.sc.bus import run_bus

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")
R1 = os.path.join(DATA, "reads_1.fastq.gz")
R2 = os.path.join(DATA, "reads_2.fastq.gz")
HM2 = os.path.join(DATA, "halfmapped_2.fastq.gz")
N = 8  # shards

# case -> (options, FLD goal or None, golden abundance.tsv or None)
CASES = {
    "paired": (dict(files=[R1, R2]), None, "quant_paired"),
    "uneven": (dict(files=[R1, R2], batch_size=999), None, "quant_paired"),
    "single": (dict(files=[R1], single_end=True, fld_mean=180.0,
                    fld_sd=20.0), None, "quant_single"),
    "fr": (dict(files=[R1, R2], strand="fr"), None, "quant_fr"),
    "min_range": (dict(files=[R1, R2], min_range=15), None, None),
    "pos_filter": (dict(files=[R1, HM2], fld_mean=180, fld_sd=20), None,
                   "quant_halfmapped"),
    # the FLD is learned from the first batches, then every batch is cmesh
    "paired_steady": (dict(files=[R1, R2]), 1000, None),
    "fr_steady": (dict(files=[R1, R2], strand="fr"), 1000, None),
    "uneven_steady": (dict(files=[R1, R2], batch_size=999), 1000, None),
}


@pytest.fixture(scope="module")
def port_index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)


def _quant(case, n, index, out=None, jax=False, monkeypatch=None):
    kw, goal, _ = CASES[case]
    kw = dict(kw)
    kw.setdefault("batch_size", 1250)  # 10k reads -> 8 batches
    if goal is not None:
        monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", str(goal))
    try:
        if jax:
            return jrun_quant(JOptions(n_devices=n, **kw), index=index)
        return run_quant(Options(n_devices=n, output_dir=out or "",
                                 plaintext=True, **kw),
                         index=index, device="cpu")
    finally:
        if goal is not None:
            monkeypatch.delenv("KALLISTO_TPU_FLEN_GOAL")


@pytest.fixture(scope="module")
def one_device(port_index):
    """The port's one-device run of every case (lazily, once each)."""
    runs = {}
    mp = pytest.MonkeyPatch()

    def get(case):
        if case not in runs:
            runs[case] = _quant(case, 1, port_index, monkeypatch=mp)
        return runs[case]

    yield get
    mp.undo()


def _same_ecs(a, b):
    assert len(a.ec_sets) == len(b.ec_sets)
    for x, y in zip(a.ec_sets, b.ec_sets):
        assert np.array_equal(x, y)
    assert np.array_equal(a.counts, b.counts)


def test_mesh_gives_n_shards_beyond_the_device_count():
    """The CPU is one device, yet n_devices = 8 gives 8 shards (JAX's mesh
    would take at most the devices it has; the outputs are equal)."""
    assert make_mesh(N, "cpu") == [torch.device("cpu")] * N


@pytest.mark.parametrize("kw,tcc,want", [
    (dict(), False, 1), (dict(threads=4), False, 1),
    (dict(n_devices=N), False, N), (dict(n_devices=N, threads=4), False, N),
    (dict(threads=4), True, 1), (dict(n_devices=3, threads=4), True, 3),
], ids=["default", "threads", "n_devices", "both", "tcc_threads", "tcc_both"])
def test_shard_count_on_the_cpu(kw, tcc, want):
    """-t N asks for up to N cards and the CPU counts as one; an explicit
    n_devices gives that many shards; quant-tcc takes the larger."""
    assert n_shards(Options(**kw), torch.device("cpu"), tcc=tcc) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_quant_matches_one_device_jax_and_golden(
        case, port_index, one_device, tmp_path, monkeypatch):
    ref = one_device(case)
    out = str(tmp_path / "q8")
    got = _quant(case, N, port_index, out, monkeypatch=monkeypatch)
    jax = _quant(case, N, port_index, jax=True, monkeypatch=monkeypatch)
    # sharded = one device, bitwise
    assert got.num_processed == ref.num_processed == 10000
    assert got.num_pseudoaligned == ref.num_pseudoaligned
    _same_ecs(got, ref)
    np.testing.assert_array_equal(got.est_counts, ref.est_counts)
    np.testing.assert_array_equal(got.flens, ref.flens)
    # the routes: per read while the FLD is learned, cmesh after it
    t = got.timings
    assert t["turbo"] == t["compact"] == t["fallback"] == t["hw1"] == 0
    steady = CASES[case][1] is not None or "fld_mean" in CASES[case][0]
    assert (t["cmesh"] > 0) == steady
    # sharded = the JAX package's sharded run
    assert jax.num_pseudoaligned == got.num_pseudoaligned
    _same_ecs(got, jax)
    np.testing.assert_allclose(got.est_counts, jax.est_counts, rtol=1e-12)
    np.testing.assert_array_equal(got.flens, jax.flens)
    golden = CASES[case][2]
    if golden is not None:
        with open(os.path.join(out, "abundance.tsv")) as f, \
                open(os.path.join(GOLDEN, golden, "abundance.tsv")) as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("case", [
    ("10xv2", ["sc_reads_1.fastq.gz", "sc_reads_2.fastq.gz"],
     dict(technology="10xv2"), ("output.bus", "matrix.ec",
                                 "transcripts.txt")),
    ("bulk_paired", ["bulkb0_1.fastq.gz", "bulkb0_2.fastq.gz"],
     dict(technology="bulk", bus_paired=True),
     ("output.bus", "matrix.ec", "transcripts.txt", "flens.txt")),
], ids=lambda c: c[0])
def test_sharded_bus_byte_equal_to_one_device_and_jax(case, port_index,
                                                      tmp_path):
    """bus over 8 shards (every chunk per read, kernel A per shard): the
    outputs byte-equal to one device and to JAX's threads=8 run."""
    _, files, kw, names = case
    files = [os.path.join(DATA, f) for f in files]
    outs = {}
    for n in (1, N):
        outs[n] = str(tmp_path / f"t{n}")
        res = run_bus(Options(files=files, output_dir=outs[n], n_devices=n,
                              threads=n, **kw), index=port_index,
                      device="cpu")
        assert (res.timings["anchor"] == 0) == (n > 1)
    outs["jax"] = str(tmp_path / "jax")
    jrun_bus(JOptions(files=files, output_dir=outs["jax"], threads=N, **kw),
             index=port_index)
    for name in names:
        with open(os.path.join(outs[1], name), "rb") as f:
            want = f.read()
        for n in (N, "jax"):
            with open(os.path.join(outs[n], name), "rb") as f:
                assert f.read() == want, (name, n)


def _tcc_cells(tmp_path, n_cells=37, n_ec=20, seed=5):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 400, (n_cells, n_ec))
    counts[rng.random((n_cells, n_ec)) < 0.5] = 0
    counts[::9] = 0
    rows, cols = np.nonzero(counts)
    mtx = str(tmp_path / "cells.mtx")
    with open(mtx, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n_cells}\t{n_ec}\t{rows.shape[0]}\n")
        for r, c in zip(rows, cols):
            f.write(f"{r + 1}\t{c + 1}\t{counts[r, c]}\n")
    return mtx


@pytest.mark.parametrize("shards", [dict(n_devices=N), dict(threads=N)],
                         ids=["n_devices", "threads"])
def test_sharded_quant_tcc_bitwise_equal(port_index, tmp_path, shards):
    """37 cells in chunks of 16, each chunk split over 8 shards (one EM
    per shard, in threads): est_counts bitwise equal to one device, the
    tcc golden's bytes unchanged."""
    ec = os.path.join(DATA, "tcc_test.ec")
    mtx = _tcc_cells(tmp_path)
    kw = dict(ec_file=ec, tcc_file=mtx, fld_mean=180, fld_sd=20)
    ref = run_quant_tcc(Options(**kw), index=port_index, chunk=16,
                        device="cpu")
    got = run_quant_tcc(Options(**kw, **shards), index=port_index, chunk=16,
                        device="cpu")
    assert got.timings["chunks"] == ref.timings["chunks"] == 3
    assert got.timings["em_rounds"] == ref.timings["em_rounds"]
    np.testing.assert_array_equal(got.est_counts, ref.est_counts)
    # the tcc golden (threads = 8 on the CPU is one device, n_devices = 8
    # eight shards)
    out = str(tmp_path / "golden")
    run_quant_tcc(Options(ec_file=ec, tcc_file=os.path.join(DATA,
                                                            "tcc_test.mtx"),
                          genemap=os.path.join(DATA, "t2g.txt"),
                          fld_mean=180, fld_sd=20, output_dir=out,
                          **shards), index=port_index, device="cpu")
    names = sorted(os.listdir(os.path.join(GOLDEN, "tcc")))
    assert len(names) == 9
    for name in names:
        with open(os.path.join(out, name)) as f, \
                open(os.path.join(GOLDEN, "tcc", name)) as g:
            assert f.read() == g.read(), name


def test_dryrun_multichip_on_the_cpu():
    routes = dryrun_multichip(4, "cpu")
    assert routes["fld"]["full"] > 0 and routes["l180"]["cmesh"] > 0
