"""The port's bootstraps (`quant -b N --seed S`, plain PyTorch path on the
CPU) against the JAX package and the reference's replicates.

The seeds (mt19937_64) and the multinomial resamples are host numpy in
both packages, so they are equal; the batched EM agrees with JAX's
float64 CPU leg to rtol 1e-12 with equal rounds (tests/test_torch_em.py),
so the written files are byte-equal.  Against the reference only the
distribution can be compared (tests/test_bootstrap.py explains why).
"""

import os

import numpy as np
import pytest
import torch

import kallisto_tpu.quant.bootstrap as jbs
from conftest import read_abundance
from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.quant.em import build_em_problem as jbuild_em_problem
from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.io import h5 as th5
from kallisto_tpu_torch.quant import bootstrap as tbs
from kallisto_tpu_torch.quant.em import build_em_problem
from kallisto_tpu_torch.quant.pipeline import run_quant

# The test workers share the machine's cores: one intra-op thread per
# worker keeps torch's thread pools from oversubscribing them, which
# slows the many small CPU ops of these tests several times over.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")
R1 = os.path.join(DATA, "reads_1.fastq.gz")
R2 = os.path.join(DATA, "reads_2.fastq.gz")
N_BS = 20


@pytest.fixture(scope="module")
def port_index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def bs_runs(port_index, tmp_path_factory):
    """-b 20 on the bundled pairs, port and JAX, plaintext and HDF5."""
    out = {}
    for plaintext in (True, False):
        for who, fn, opts in (("port", run_quant, Options),
                              ("jax", jrun_quant, JOptions)):
            d = str(tmp_path_factory.mktemp(f"{who}_{plaintext}"))
            kw = dict(files=[R1, R2], bootstrap=N_BS, batch_size=10000,
                      output_dir=d, plaintext=plaintext)
            if who == "port":
                res = fn(opts(**kw), index=port_index, device="cpu")
            else:
                res = fn(opts(**kw), index=port_index)
            out[who, plaintext] = (res, d)
    return out


def test_seeds_and_resamples_equal_jax():
    assert tbs.bootstrap_seeds(42, 5) == jbs.bootstrap_seeds(42, 5)
    assert tbs.bootstrap_seeds(7, 3)[0] != tbs.bootstrap_seeds(42, 1)[0]
    counts = np.random.default_rng(1).integers(0, 300, 50)
    for s in tbs.bootstrap_seeds(42, 4):
        np.testing.assert_array_equal(tbs.resample_counts(counts, s),
                                      jbs.resample_counts(counts, s))


def test_run_bootstraps_matches_jax(port_index, monkeypatch):
    rng = np.random.default_rng(3)
    T = port_index.num_trans
    ec_sets = [np.array([t], np.int32) for t in range(T)] + [
        np.sort(rng.choice(T, 3, replace=False)).astype(np.int32)
        for _ in range(10)
    ]
    counts = rng.integers(0, 500, len(ec_sets)).astype(np.int64)
    eff = np.linspace(100, 2000, T)
    monkeypatch.setenv("KALLISTO_TPU_EM_DEVICE", "cpu")
    want = jbs.run_bootstraps(jbuild_em_problem(ec_sets, T), counts, eff, 6,
                              seed=42)
    got = tbs.run_bootstraps(build_em_problem(ec_sets, T), counts, eff, 6,
                             seed=42, device="cpu")
    assert got.shape == (6, T) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def test_quant_bootstraps_shapes_and_mass(bs_runs):
    res, _ = bs_runs["port", True]
    bs = res.bootstraps
    assert bs is not None and bs.shape == (N_BS, 14)
    # each replicate redistributes exactly the resampled read mass
    np.testing.assert_allclose(bs.sum(axis=1), res.counts.sum(), rtol=1e-6)
    assert res.timings["bootstrap_s"] > 0


def test_quant_bootstrap_statistics_vs_reference(bs_runs):
    """The distribution checks of tests/test_bootstrap.py against the
    reference's 20 replicates (tests/golden/quant_bs)."""
    ref = np.stack([
        read_abundance(os.path.join(GOLDEN, "quant_bs",
                                    f"bs_abundance_{b}.tsv"))[3]
        for b in range(N_BS)])
    mine = bs_runs["port", True][0].bootstraps
    ref_mean, mine_mean = ref.mean(axis=0), mine.mean(axis=0)
    ref_sd, mine_sd = ref.std(axis=0), mine.std(axis=0)
    se = np.maximum(ref_sd, mine_sd) / np.sqrt(N_BS)
    big = ref_mean > 10
    assert (np.abs(ref_mean - mine_mean)[big] < 5 * se[big] + 1.0).all()
    nz = (ref_sd > 1.0) & (mine_sd > 1.0)
    ratio = mine_sd[nz] / ref_sd[nz]
    assert nz.any() and (ratio > 1 / 3).all() and (ratio < 3).all()


def test_bs_abundance_files_byte_equal_to_jax(bs_runs):
    (pres, pd), (jres, jd) = bs_runs["port", True], bs_runs["jax", True]
    np.testing.assert_allclose(pres.bootstraps, jres.bootstraps, rtol=1e-12)
    for name in ["abundance.tsv"] + [f"bs_abundance_{b}.tsv"
                                     for b in range(N_BS)]:
        assert _read(os.path.join(pd, name)) == _read(os.path.join(jd, name)), name
    assert not os.path.exists(os.path.join(pd, "abundance.h5"))
    assert '"n_bootstraps": 20' in _read(os.path.join(pd, "run_info.json"))


def test_abundance_h5_equal_to_jax(bs_runs):
    """abundance.h5 datasets: est_counts and bootstrap/bs* to rtol 1e-12,
    the aux datasets exactly (but start_time: each run stamps its own)."""
    import h5py  # here, not at the top: the card's machine has no h5py

    assert th5.HAVE_H5PY
    (_, pd), (_, jd) = bs_runs["port", False], bs_runs["jax", False]
    assert not os.path.exists(os.path.join(pd, "bs_abundance_0.tsv"))
    with h5py.File(os.path.join(pd, "abundance.h5")) as p, \
            h5py.File(os.path.join(jd, "abundance.h5")) as j:
        np.testing.assert_allclose(p["est_counts"][:], j["est_counts"][:],
                                   rtol=1e-12)
        assert sorted(p["bootstrap"]) == sorted(j["bootstrap"]) == \
            sorted(f"bs{b}" for b in range(N_BS))
        for b in range(N_BS):
            np.testing.assert_allclose(p[f"bootstrap/bs{b}"][:],
                                       j[f"bootstrap/bs{b}"][:], rtol=1e-12)
        assert sorted(p["aux"]) == sorted(j["aux"])
        for name in p["aux"]:
            if name == "start_time":
                continue
            a, b = p["aux"][name][:], j["aux"][name][:]
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert int(p["aux/num_bootstrap"][0]) == N_BS
        np.testing.assert_array_equal(p["aux/bias_observed"][:],
                                      np.ones(4096, np.int32))


def test_h5dump_round_trip(bs_runs, tmp_path):
    """The port's h5dump copy turns its abundance.h5 back into the
    plaintext files of the same run, to the six digits they print."""
    (_, pd), (_, td) = bs_runs["port", False], bs_runs["port", True]
    th5.h5dump(os.path.join(pd, "abundance.h5"), str(tmp_path))
    for name in ("abundance.tsv", "bs_abundance_3.tsv"):
        assert _read(os.path.join(tmp_path, name)) == \
            _read(os.path.join(td, name)), name


def test_nothing_aligned_bootstraps_equal_main_alpha(port_index, tmp_path):
    """With no read pseudoaligned, every replicate is the main EM result
    (reference: main.cpp:2732-2743)."""
    import gzip

    rng = np.random.default_rng(5)
    fq = str(tmp_path / "junk.fastq.gz")
    with gzip.open(fq, "wt") as f:
        for r in range(200):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 80))
            f.write(f"@r{r}\n{seq}\n+\n{'I' * 80}\n")
    res = run_quant(Options(files=[fq], single_end=True, fld_mean=180,
                            fld_sd=20, bootstrap=3, plaintext=True,
                            output_dir=str(tmp_path / "o")),
                    index=port_index, device="cpu")
    assert res.num_pseudoaligned == 0
    assert res.bootstraps.shape == (3, port_index.num_trans)
    for b in range(3):
        np.testing.assert_array_equal(res.bootstraps[b], res.est_counts)
    assert os.path.exists(str(tmp_path / "o" / "bs_abundance_2.tsv"))


def test_without_h5py_warns_and_writes_no_h5(port_index, tmp_path,
                                             monkeypatch, capsys):
    """Where h5py is missing, -b N without --plaintext writes abundance.tsv
    and run_info.json, no abundance.h5, and says so on stderr."""
    monkeypatch.setattr(th5, "HAVE_H5PY", False)
    out = str(tmp_path / "o")
    res = run_quant(Options(files=[R1, R2], bootstrap=2, batch_size=10000,
                            output_dir=out), index=port_index, device="cpu")
    err = capsys.readouterr().err
    assert "abundance.h5 and its 2 bootstraps not written" in err
    assert sorted(os.listdir(out)) == ["abundance.tsv", "run_info.json"]
    assert res.bootstraps.shape == (2, 14)
    for key in ("em_problem_s", "write_s", "bootstrap_s"):
        assert res.timings[key] > 0, key
    assert res.timings["bias_tables_s"] == 0.0
