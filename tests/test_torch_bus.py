"""The port's `bus` (plain PyTorch path, device='cpu') against the reference
goldens and against the JAX package's run.

Each golden directory of tests/golden that the JAX package's bus tests
own (test_bus.py, test_bus_inputs.py, test_dlist.py, test_aa.py,
test_distinguish.py) is a case of one test, with the same invocation and
the same compared files as the JAX test; bus_long (kernel J's plain
version) also gives the JAX package's bytes.  The anchor route (kernel
I's plain version) and the per-read route must give the same bytes, and
the port must take the anchor route on the same chunks as the JAX
package.
"""

import gzip
import json
import os
import shutil
import struct
from collections import Counter

import numpy as np
import pytest
import torch

import kallisto_tpu.sc.bus as jbus
import kallisto_tpu.quant.pipeline as jpipe
from kallisto_tpu.common import Options as JOptions
from kallisto_tpu_torch import cli
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index, save_index
from kallisto_tpu_torch.sc import bus as tbus
from kallisto_tpu_torch.sc.bus import run_bus

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")


def _d(*names):
    return [os.path.join(DATA, n) for n in names]


INDEXES = {
    "tx": lambda: build_index(_d("transcripts.fasta.gz"), k=31),
    "tx_dlist": lambda: build_index(_d("transcripts.fasta.gz"), k=31,
                                    dlist_paths=_d("dlist.fasta")),
    "aa": lambda: build_index(_d("aa_ref.fasta"), k=7, aa=True),
    "aa_dlist": lambda: build_index(_d("aa_ref.fasta"), k=7, aa=True,
                                    dlist_paths=_d("dlist_nn.fasta"),
                                    dlist_overhang=3),
    "colors": lambda: build_index(_d("distinguish_colors.fasta"), k=7,
                                  dlist_paths=_d("distinguish_polyA.fasta"),
                                  distinguish=True),
    "shades": lambda: build_index(_d("distinguish_shades.fasta"), k=7,
                                  dlist_paths=_d("distinguish_polyA.fasta"),
                                  distinguish=True),
    "t0": lambda: build_index(_d("distinguish_t.fasta"), k=7,
                              dlist_paths=_d("distinguish_polyA.fasta"),
                              distinguish=True),
}
_built = {}


def index_of(name):
    if name not in _built:
        _built[name] = INDEXES[name]()
    return _built[name]


def _batch_file(tmp_path, rows):
    p = tmp_path / "batch.txt"
    with open(p, "w") as f:
        for row in rows:
            f.write(row[0] + " " + " ".join(_d(*row[1:])) + "\n")
    return str(p)


def _aa_mix(tmp_path):
    """The 4 on-target reads followed by the 10 contaminant-tiling reads
    (tests/test_dlist.py)."""
    mix = str(tmp_path / "mix_nn.fastq.gz")
    with open(mix, "wb") as f:
        for src in ("virus_nn_frame0.fastq.gz", "contam_nn.fastq.gz"):
            with open(os.path.join(DATA, src), "rb") as g:
                shutil.copyfileobj(g, f)
    return mix


SS3 = ("ss3_I1.fastq.gz", "ss3_I2.fastq.gz", "ss3_R1.fastq.gz",
       "ss3_R2.fastq.gz")
B10 = [("cellA", "sc_b0_1.fastq.gz", "sc_b0_2.fastq.gz"),
       ("cellB", "sc_b1_1.fastq.gz", "sc_b1_2.fastq.gz")]
BULK = [("sampleA", "bulkb0_1.fastq.gz", "bulkb0_2.fastq.gz"),
        ("sampleB", "bulkb1_1.fastq.gz", "bulkb1_2.fastq.gz")]
DISTINGUISH = dict(files=_d("distinguish_reads.fastq.gz"), technology="bulk",
                   bus_num=True, single_end=True, k=7)

# golden dir -> (index, options (a callable of tmp_path for files made at
# run time), compared files, run_info counts compared, extra checks)
CASES = {
    "bus10xv2": ("tx", dict(files=_d("sc_reads_1.fastq.gz",
                                     "sc_reads_2.fastq.gz"),
                            technology="10xv2", batch_size=20000),
                 ["output.bus", "matrix.ec", "transcripts.txt"], True,
                 dict(stats=(10000, 4808, 3524), bclen=16, umilen=10)),
    "bus_smartseq3": ("tx", dict(files=_d(*SS3), technology="SMARTSEQ3",
                                 batch_size=1024),
                      ["output.bus", "matrix.ec", "transcripts.txt",
                       "flens.txt"], True, dict(umilen=8)),
    "bus_smartseq3_num": ("tx", dict(files=_d(*SS3), technology="SMARTSEQ3",
                                     tag="ATTGCGCAATG", bus_num=True),
                          ["output.bus"], False, {}),
    "bus_batch_bulk": ("tx", lambda tp: dict(
        batch_file=_batch_file(tp, BULK), batch_size=700),
        ["output.bus", "matrix.ec", "matrix.cells", "matrix.sample.barcodes",
         "flens.txt"], True, {}),
    "bus_batch_10x": ("tx", lambda tp: dict(
        batch_file=_batch_file(tp, B10), technology="10xv2"),
        ["output.bus", "matrix.ec", "matrix.cells"], True, {}),
    "bus_batch_10x_bb": ("tx", lambda tp: dict(
        batch_file=_batch_file(tp, B10), technology="10xv2",
        batch_barcodes=True),
        ["output.bus", "matrix.ec", "matrix.cells",
         "matrix.sample.barcodes"], True, {}),
    "bus_inleaved": ("tx", dict(files=_d("interleaved_10x.fastq.gz"),
                                technology="10xv2", inleaved=True,
                                batch_size=500),
                     ["output.bus", "matrix.ec"], True, {}),
    "bus_rx": ("tx", dict(files=_d("rx_R1.fastq.gz", "rx_R2.fastq.gz"),
                          technology="0,0,16:RX:1,0,0"),
               ["output.bus", "matrix.ec"], True, dict(umilen=12)),
    "bus_bam": ("tx", dict(files=_d("sc10x.bam"), technology="10xv2",
                           bam=True),
                ["output.bus", "matrix.ec"], True, {}),
    "bus_dfk": ("tx_dlist", dict(files=_d("dfk_reads.fastq.gz"),
                                 technology="bulk", single_end=True,
                                 dfk_onlist=True),
                ["output.bus", "matrix.ec"], False, {}),
    "bus_aa_dlist": ("aa_dlist", lambda tp: dict(
        files=[_aa_mix(tp)], technology="bulk", aa=True),
        ["output.bus", "matrix.ec"], False, dict(stats2=(14, 5))),
    "bus_aa_f0": ("aa", dict(files=_d("virus_nn_frame0.fastq.gz"),
                             technology="bulk", aa=True),
                  ["output.bus", "matrix.ec", "matrix.cells",
                   "matrix.sample.barcodes"], False, dict(all_align=True)),
    "bus_aa_mixed": ("aa", dict(files=_d("virus_nn_mixed_frames.fastq.gz"),
                                technology="bulk", aa=True),
                     ["output.bus", "matrix.ec"], False,
                     dict(all_align=True)),
    "bus_distinguish": ("colors", DISTINGUISH,
                        ["output.bus", "matrix.ec", "transcripts.txt"], False,
                        {}),
    "bus_shade": ("shades", DISTINGUISH,
                  ["output.bus", "matrix.ec", "transcripts.txt"], False, {}),
    "bus_distinguish_t0": ("t0", DISTINGUISH,
                           ["output.bus", "matrix.ec", "transcripts.txt"],
                           False, {}),
    # the reference's match_long skips k-mers where both packages evaluate
    # every one: records a sub-multiset of the golden's (tests/
    # test_bus_inputs.py), and the JAX package's bytes
    "bus_long": ("tx", dict(files=_d("reads_lr.fastq.gz"), technology="bulk",
                            long_read=True, threshold=0.8),
                 ["matrix.ec", "flens.txt"], False, dict(long=True)),
}


def _opts(case, tmp_path):
    kw = CASES[case][1]
    return dict(kw(tmp_path) if callable(kw) else kw)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _cmp(out, golden, files):
    for fname in files:
        assert _bytes(os.path.join(out, fname)) == \
            _bytes(os.path.join(GOLDEN, golden, fname)), fname


def test_golden_cases_cover_every_bus_golden():
    dirs = {d for d in os.listdir(GOLDEN) if d.startswith("bus")}
    assert dirs == set(CASES)
    assert len(CASES) == 17


def _records(path):
    b = _bytes(path)
    n = struct.unpack("<I", b[16:20])[0]
    dt = np.dtype("<u8,<u8,<i4,<u4,<u4,<u4")
    return Counter(tuple(r) for r in np.frombuffer(b[20 + n:], dt))


def _long_checks(tmp_path, out, res, opts):
    mine = _records(os.path.join(out, "output.bus"))
    want = _records(os.path.join(GOLDEN, "bus_long", "output.bus"))
    assert not mine - want
    assert sum((want - mine).values()) <= max(1, sum(want.values()) // 200)
    jout = str(tmp_path / "jax")
    jbus.run_bus(JOptions(output_dir=jout, **opts), index=index_of("tx"))
    for fname in ("output.bus", "novel.fastq", "matrix.ec", "flens.txt"):
        assert _bytes(os.path.join(out, fname)) == \
            _bytes(os.path.join(jout, fname)), fname
    assert res.timings["long"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_bus_byte_equal_to_golden(tmp_path, case):
    iname, _, files, runinfo, extra = CASES[case]
    out = str(tmp_path / "out")
    res = run_bus(Options(output_dir=out, **_opts(case, tmp_path)),
                  index=index_of(iname), device="cpu")
    _cmp(out, case, files)
    if runinfo:
        mine = json.load(open(os.path.join(out, "run_info.json")))
        want = json.load(open(os.path.join(GOLDEN, case, "run_info.json")))
        for key in ("n_targets", "n_processed", "n_pseudoaligned",
                    "n_unique"):
            assert mine[key] == want[key], key
    if "stats" in extra:
        assert (res.num_processed, res.num_pseudoaligned, res.num_unique) \
            == extra["stats"]
    if "stats2" in extra:
        assert (res.num_processed, res.num_pseudoaligned) == extra["stats2"]
    if extra.get("all_align"):
        assert res.num_pseudoaligned == res.num_processed
    for key in ("bclen", "umilen"):
        if key in extra:
            assert getattr(res, key) == extra[key]
    if extra.get("long"):
        _long_checks(tmp_path, out, res, _opts(case, tmp_path))
    t = res.timings
    assert t["anchor"] + t["full"] + t["long"] > 0 and t["read_s"] > 0, t


def test_cli_bus_on_the_cpu(tmp_path):
    idx = str(tmp_path / "idx.npz")
    save_index(index_of("tx"), idx)
    out = str(tmp_path / "cli")
    assert cli.main(["bus", "-i", idx, "-o", out, "-x", "10xv2",
                     "--device", "cpu"]
                    + _d("sc_reads_1.fastq.gz", "sc_reads_2.fastq.gz")) == 0
    _cmp(out, "bus10xv2", ["output.bus", "matrix.ec", "transcripts.txt"])


def test_cli_bus_wants_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    idx = str(tmp_path / "idx.npz")
    save_index(index_of("tx"), idx)
    with pytest.raises(SystemExit) as e:
        cli.main(["bus", "-i", idx, "-o", str(tmp_path / "o"), "-x", "10xv2"]
                 + _d("sc_reads_1.fastq.gz", "sc_reads_2.fastq.gz"))
    assert e.value.code != 0
    with pytest.raises(RuntimeError):
        run_bus(Options(files=_d("sc_reads_1.fastq.gz", "sc_reads_2.fastq.gz"),
                        technology="10xv2", output_dir=str(tmp_path / "o2")),
                index=index_of("tx"))


def _count_anchor(monkeypatch, cls, counts):
    """Count a _BusRun's anchor attempts and the chunks they resolved."""
    for name in ("_anchor_pair", "_anchor_single"):
        fn = getattr(cls, name)

        def counted(self, *a, fn=fn):
            r = fn(self, *a)
            counts["tried"] += 1
            counts["taken"] += r is not None
            return r

        monkeypatch.setattr(cls, name, counted)


# Chunks are counted per file batch, so every file here fits one batch:
# the JAX package's FASTQ reader hands out everything after its first
# batch as one batch, where the port's holds each batch to batch_size
# (the outputs do not depend on it; the chunk count does).
ROUTE_CASES = {
    "bus10xv2": ("bus10xv2", False),             # single-end cDNA
    "bus_batch_bulk": ("bus_batch_bulk", False),  # pairs, two samples
    "bus_batch_bulk_w2_overflow": ("bus_batch_bulk", True),
}


@pytest.mark.parametrize("rcase", sorted(ROUTE_CASES))
def test_anchor_route_matches_per_read_and_jax(tmp_path, monkeypatch, rcase):
    """The port tries the anchor route on the JAX package's chunks and,
    having no wave-2 capacity, takes it on every one; JAX takes the chunks
    whose failures fit its capacity (all of them on this data; none in the
    w2_overflow case, which pins JAX's capacity at 1 read).  The per-read
    route and JAX give the same bytes."""
    case, overflow = ROUTE_CASES[rcase]
    iname, _, files, _, _ = CASES[case]
    index = index_of(iname)
    # JAX's capacity hints outlive a run: start from none
    monkeypatch.setattr(jpipe, "_W2_HINTS", {})
    if overflow:
        monkeypatch.setattr(jpipe, "_w2_cap", lambda B2: 1)
    jc = {"tried": 0, "taken": 0}
    _count_anchor(monkeypatch, jbus._BusRun, jc)
    kw = dict(_opts(case, tmp_path), batch_size=1 << 18)
    res = run_bus(Options(output_dir=str(tmp_path / "anchor"), **kw),
                  index=index, device="cpu")
    jbus.run_bus(JOptions(output_dir=str(tmp_path / "jax"), **kw),
                 index=index)
    t = res.timings
    assert t["anchor"] == jc["tried"] > 0
    assert jc["taken"] == (0 if overflow else jc["tried"])
    assert 0 < t["wave2_reads"] < res.num_processed * 2
    for name in ("_anchor_pair", "_anchor_single"):
        monkeypatch.setattr(tbus._BusRun, name, lambda self, *a: None)
    per_read = run_bus(Options(output_dir=str(tmp_path / "per_read"), **kw),
                       index=index, device="cpu")
    assert per_read.timings["anchor"] == 0 and per_read.timings["full"] > 0
    for fname in files:
        a = _bytes(os.path.join(tmp_path, "anchor", fname))
        assert a == _bytes(os.path.join(tmp_path, "per_read", fname)), fname
        assert a == _bytes(os.path.join(tmp_path, "jax", fname)), fname


def test_rx_comments_reach_the_reader():
    """keep_comments hands out each header's text after its first space."""
    from kallisto_tpu_torch.io.fastx import FastqStream

    s = FastqStream(_d("rx_R2.fastq.gz")[0], keep_comments=True)
    b = s.next_batch(4)
    s.close()
    with gzip.open(_d("rx_R2.fastq.gz")[0], "rb") as f:
        head = f.readline().rstrip(b"\n")
    assert b.comments[0] == head.split(b" ", 1)[1]
    assert all(c.find(b"RX:Z:") >= 0 for c in b.comments)
