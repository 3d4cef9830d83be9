"""The port's `quant-tcc` (the plain PyTorch EM, device='cpu') against the
reference goldens and against the JAX package.

Each tcc* golden directory is a case of one test, with the files and
options of tests/test_tcc.py, run once through run_quant_tcc and once
through the CLI.  A larger matrix with per-cell fragment-length
distributions, split into several EM chunks, gives the JAX package's bytes.
"""

import os

import numpy as np
import pytest
import torch

from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.quant.tcc import run_quant_tcc as jrun_quant_tcc
from kallisto_tpu_torch import cli
from kallisto_tpu_torch.common import MAX_FRAG_LEN, Options
from kallisto_tpu_torch.index import build_index, save_index
from kallisto_tpu_torch.quant.tcc import run_quant_tcc

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")
EC = os.path.join(DATA, "tcc_test.ec")
MTX = os.path.join(DATA, "tcc_test.mtx")


def _d(name):
    return os.path.join(DATA, name)


L180 = dict(fld_mean=180, fld_sd=20)
# golden dir -> (options, CLI flags, compared files, with the index)
CASES = {
    "tcc": (dict(tcc_file=MTX, genemap=_d("t2g.txt"), **L180),
            ["-l", "180", "-s", "20", "-g", _d("t2g.txt"), MTX],
            ["matrix.abundance.mtx", "matrix.abundance.tpm.mtx",
             "matrix.efflens.mtx", "matrix.fld.tsv",
             "matrix.abundance.gene.mtx", "matrix.abundance.gene.tpm.mtx",
             "genes.txt", "transcripts.txt", "transcript_lengths.txt"], True),
    "tcc_priors": (dict(tcc_file=MTX, priors=_d("priors.txt")),
                   ["-p", _d("priors.txt"), MTX],
                   ["matrix.abundance.mtx", "matrix.abundance.tpm.mtx"], True),
    "tcc_txnames": (dict(tcc_file=MTX, txnames_file=_d("txnames.txt")),
                    ["-T", _d("txnames.txt"), MTX],
                    ["matrix.abundance.mtx", "matrix.abundance.tpm.mtx"],
                    False),
    "tcc_gtf": (dict(tcc_file=MTX, gtf_file=_d("transcripts.gtf.gz")),
                ["-G", _d("transcripts.gtf.gz"), MTX],
                ["genes.txt", "matrix.abundance.gene.mtx",
                 "matrix.abundance.gene.tpm.mtx"], True),
    "tcc_long": (dict(tcc_file=MTX, long_read=True, **L180),
                 ["--long", "-l", "180", "-s", "20", MTX],
                 ["matrix.abundance.mtx", "matrix.abundance.tpm.mtx",
                  "matrix.efflens.mtx", "matrix.fld.tsv"], True),
    "tcc_flat": (dict(tcc_file=_d("tcc_flat.txt"), genemap=_d("t2g.txt"),
                      bootstrap=2),
                 ["-g", _d("t2g.txt"), "-b", "2", _d("tcc_flat.txt")],
                 ["abundance.tsv", "abundance.gene.tsv"], True),
    "tcc_m2f": (dict(tcc_file=MTX, bootstrap=2, plaintext=True,
                     matrix_to_files=True, **L180),
                ["-l", "180", "-s", "20", "-b", "2", "--plaintext",
                 "--matrix-to-files", MTX],
                ["abundance_1.tsv", "abundance_2.tsv"], True),
}


@pytest.fixture(scope="module")
def port_index():
    return build_index([_d("transcripts.fasta.gz")], k=31)


@pytest.fixture(scope="module")
def index_file(port_index, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("idx") / "idx.npz")
    save_index(port_index, path)
    return path


def _read(path):
    with open(path) as f:
        return f.read()


def _cmp(out, case, files):
    for fname in files:
        assert _read(os.path.join(out, fname)) == \
            _read(os.path.join(GOLDEN, case, fname)), fname


def test_cases_cover_every_tcc_golden():
    dirs = {d for d in os.listdir(GOLDEN) if d.startswith("tcc")}
    assert dirs == set(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tcc_byte_equal_to_golden(port_index, tmp_path, case):
    kw, _, files, with_index = CASES[case]
    out = str(tmp_path / "out")
    res = run_quant_tcc(Options(ec_file=EC, output_dir=out, **kw),
                        index=port_index if with_index else None,
                        device="cpu")
    _cmp(out, case, files)
    t = res.timings
    assert t["chunks"] == 1 and t["em_rounds"] > 50, t
    listed = os.listdir(out)
    # index-free mode writes no transcripts.txt (main.cpp:2914-2920)
    assert ("transcripts.txt" in listed) == with_index
    if kw.get("bootstrap"):
        cells = ["_1", "_2"] if kw.get("matrix_to_files") else [""]
        for c in cells:
            for b in range(2):
                assert f"bs_abundance{c}_{b}.tsv" in listed
    if "fld_mean" in kw:
        # -l/-s leaves the observed histogram empty: the sd is NaN
        assert np.isnan(res.fld_stats[:, 1]).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_quant_tcc_byte_equal_to_golden(index_file, tmp_path, case):
    _, flags, files, with_index = CASES[case]
    out = str(tmp_path / "cli")
    idx = ["-i", index_file] if with_index else []
    assert cli.main(["quant-tcc", *idx, "-o", out, "-e", EC, "--device",
                     "cpu", *flags]) == 0
    _cmp(out, case, files)


def test_tcc_matrix_to_directories(port_index, tmp_path):
    out = str(tmp_path / "m2d")
    kw = dict(CASES["tcc_m2f"][0], matrix_to_directories=True)
    run_quant_tcc(Options(ec_file=EC, output_dir=out, **kw),
                  index=port_index, device="cpu")
    for c in (1, 2):
        assert _read(os.path.join(out, f"abundance_{c}", "abundance.tsv")) \
            == _read(os.path.join(GOLDEN, "tcc_m2f", f"abundance_{c}.tsv"))
        for b in range(2):
            assert os.path.exists(os.path.join(
                out, f"abundance_{c}", f"bs_abundance_{b}.tsv"))


def _many_cells(tmp_path, n_cells, seed):
    """A cells x ECs matrix over tcc_test.ec's 20 ECs (sparse rows, a few
    empty cells) and one fragment-length histogram per cell."""
    rng = np.random.default_rng(seed)
    n_ec = 20
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
    fld = str(tmp_path / "flens.txt")
    with open(fld, "w") as f:
        for _ in range(n_cells):
            mean = rng.uniform(150, 350)
            h = np.histogram(rng.normal(mean, 30, 500), bins=MAX_FRAG_LEN,
                             range=(0, MAX_FRAG_LEN))[0]
            f.write(" ".join(str(int(x)) for x in h) + "\n")
    return mtx, fld


@pytest.mark.parametrize("opt", [
    dict(), dict(long_read=True, platform="PacBio"),
    dict(long_read=True, platform="ONT")])
def test_chunked_cells_with_their_own_lengths_match_jax(port_index,
                                                        tmp_path, opt):
    """37 cells in chunks of 8 (kernel G's per-cell lengths on the card,
    here its plain version) give the JAX package's bytes."""
    mtx, fld = _many_cells(tmp_path, 37, 3)
    kw = dict(ec_file=EC, tcc_file=mtx, fld_file=fld, **opt)
    res = run_quant_tcc(Options(output_dir=str(tmp_path / "port"), **kw),
                        index=port_index, chunk=8, device="cpu")
    jrun_quant_tcc(JOptions(output_dir=str(tmp_path / "jax"), **kw),
                   index=port_index)
    assert res.timings["chunks"] == 5
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    assert "matrix.abundance.mtx" in files
    assert ("matrix.efflens.mtx" in files) == (opt.get("platform") != "ONT")
    for fname in files:
        assert _read(tmp_path / "port" / fname) == \
            _read(tmp_path / "jax" / fname), fname
    if opt.get("platform") != "ONT":
        # per-cell effective lengths
        assert not np.allclose(res.eff_lens[1], res.eff_lens[2])


def test_quant_tcc_wants_the_card_by_default(index_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        run_quant_tcc(Options(ec_file=EC, tcc_file=MTX,
                              output_dir=str(tmp_path / "o")))
    with pytest.raises(SystemExit) as e:
        cli.main(["quant-tcc", "-i", index_file, "-o", str(tmp_path / "o2"),
                  "-e", EC, MTX])
    assert e.value.code != 0


@pytest.mark.parametrize("flags,msg", [
    ([], "either a kallisto index file or a transcripts file"),
    (["-i", "x.npz", "-T", "t.txt"], "cannot supply both"),
    (["-T", "t.txt", "-l", "180"], "without supplying both -l and -s"),
    (["-T", "t.txt", "-l", "180", "-s", "20", "-f", "f.txt"],
     "while also supplying"),
])
def test_cli_quant_tcc_checks(tmp_path, capsys, flags, msg):
    with pytest.raises(SystemExit) as e:
        cli.main(["quant-tcc", "-o", str(tmp_path / "o"), "-e", EC, *flags,
                  MTX])
    assert e.value.code != 0 and msg in str(e.value.code)
