"""The port's `quant` (plain PyTorch path, device='cpu') against the
reference goldens and against the JAX package's run.

abundance.tsv and counts.txt must be byte-identical to tests/golden (the
reference kallisto 0.51.1 outputs that the JAX package also matches), and
the run statistics and EC tables equal to the JAX run's.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import kallisto_tpu.quant.pipeline as jpipe
from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index, save_index
from kallisto_tpu_torch.ops import anchor as anchor_mod
from kallisto_tpu_torch.ops import turbo as turbo_mod
from kallisto_tpu_torch.quant import pipeline as tpipe
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
HM2 = os.path.join(DATA, "halfmapped_2.fastq.gz")


@pytest.fixture(scope="module")
def port_index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)


def _read(path):
    with open(path) as f:
        return f.read()


GOLDEN_CASES = {
    "paired": (dict(files=[R1, R2]), "quant_paired/abundance.tsv"),
    "single": (dict(files=[R1], single_end=True, fld_mean=180, fld_sd=20),
               "quant_single/abundance.tsv"),
    "single_r2": (dict(files=[R2], single_end=True, fld_mean=150, fld_sd=25),
                  "quant_single_r2/abundance.tsv"),
    "fr": (dict(files=[R1, R2], strand="fr"), "quant_fr/abundance.tsv"),
    "rf": (dict(files=[R1, R2], strand="rf"), "quant_rf/abundance.tsv"),
    "priors": (dict(files=[R1, R2], priors=os.path.join(DATA, "priors.txt")),
               "quant_priors/abundance.tsv"),
    "priors_prob": (dict(files=[R1, R2],
                         priors=os.path.join(DATA, "priors_prob.txt")),
                    "quant_priors/abundance_prob.tsv"),
    "halfmapped": (dict(files=[R1, HM2], fld_mean=180, fld_sd=20),
                   "quant_halfmapped/abundance.tsv"),
    "halfmapped_fr": (dict(files=[R1, HM2], fld_mean=180, fld_sd=20,
                           strand="fr"),
                      "quant_halfmapped_fr/abundance.tsv"),
}


# With an explicit -l no fragment lengths are learned, so these runs take
# the compact steady state from their first batch (turbo batches); paired
# runs without -l stay per read ("full") because their 10,000 pairs never
# reach the FLD goal.  With host wave 1 on, the same runs take hw1 / hw1s
# and hw1pb instead (test_abundance_byte_equal_to_golden_host_wave1).
COMPACT_CASES = {"single", "single_r2", "halfmapped", "halfmapped_fr"}


def _routes(res):
    return {r: res.timings[r] for r in ("full", "turbo", "compact", "fallback")}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_abundance_byte_equal_to_golden(port_index, tmp_path, monkeypatch,
                                        case):
    """The goldens through the card's own routes (host wave 1 off)."""
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    kw, golden = GOLDEN_CASES[case]
    out = str(tmp_path / case)
    res = run_quant(Options(output_dir=out, batch_size=4096, **kw),
                    index=port_index, device="cpu")
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, golden))
    routes = _routes(res)
    if case in COMPACT_CASES:
        assert routes["turbo"] > 0 and routes["full"] == 0, routes
        assert 0 < res.timings["n_uniq_max"] <= res.timings["n_uniq_sum"]
    else:
        assert routes["full"] > 0 and routes["turbo"] == 0, routes
    assert routes["compact"] == routes["fallback"] == 0, routes


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_abundance_byte_equal_to_golden_host_wave1(port_index, tmp_path,
                                                   monkeypatch, case):
    """The goldens with host wave 1 on: pairs learn the FLD on hw1pb,
    batches with -l go hw1 (paired) or hw1s (single-end); every batch of
    the bundled reads has one length."""
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "1")
    kw, golden = GOLDEN_CASES[case]
    out = str(tmp_path / case)
    res = run_quant(Options(output_dir=out, batch_size=4096, **kw),
                    index=port_index, device="cpu")
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, golden))
    t = res.timings
    hw1 = t["hw1pb"] + t["hw1"] + t["hw1s"]
    assert hw1 > 0 and t["full"] == t["turbo"] == 0, t
    assert t["probe_s"] > 0
    want = ("hw1s" if case.startswith("single")
            else "hw1" if case in COMPACT_CASES else "hw1pb")
    assert t[want] == hw1, t
    assert t["compact"] == t["fallback"] == 0, t


def test_dlist_abundance_byte_equal_to_golden(tmp_path):
    index = build_index(
        [os.path.join(DATA, "transcripts.fasta.gz")], k=31,
        dlist_paths=[os.path.join(DATA, "dlist.fasta")],
    )
    out = str(tmp_path / "dl")
    res = run_quant(Options(files=[R1, R2], output_dir=out, plaintext=True),
                    index=index, device="cpu")
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, "quant_dlist", "abundance.tsv"))
    assert res.num_pseudoaligned == 9413


@pytest.fixture(scope="module")
def paired_runs(port_index, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_paired"))
    port = run_quant(
        Options(files=[R1, R2], output_dir=out, write_index=True,
                batch_size=4096),
        index=port_index, device="cpu",
    )
    jax = jrun_quant(JOptions(files=[R1, R2], batch_size=4096),
                     index=port_index)
    return port, jax, out


def test_paired_counts_byte_equal_to_golden(paired_runs):
    _, _, out = paired_runs
    assert _read(os.path.join(out, "counts.txt")) == \
        _read(os.path.join(GOLDEN, "quant_paired_wi", "counts.txt"))


def test_paired_run_stats_match_golden_and_jax(paired_runs):
    port, jax, _ = paired_runs
    assert (port.num_processed, port.num_pseudoaligned, port.num_unique) == \
        (10000, 9413, 7174)
    assert (port.num_processed, port.num_pseudoaligned, port.num_unique) == \
        (jax.num_processed, jax.num_pseudoaligned, jax.num_unique)
    np.testing.assert_array_equal(port.counts, jax.counts)
    assert [s.tolist() for s in port.ec_sets] == \
        [s.tolist() for s in jax.ec_sets]
    np.testing.assert_array_equal(port.flens, jax.flens)
    np.testing.assert_array_equal(port.eff_lens, jax.eff_lens)
    assert port.em.n_rounds == jax.em.n_rounds
    np.testing.assert_allclose(port.est_counts, jax.est_counts, rtol=1e-12)


# the progress line every T reads, T lowered from 1,000,000 in both
# packages: the port through its module constant, JAX by counting each read
# of a batch as 1,000,000 / T reads in its _Progress.update
PROGRESS_T = 2000


@pytest.mark.parametrize("verbose,hw1", [(False, "0"), (True, "0"),
                                         (True, "1")])
def test_stderr_matches_jax_with_progress(port_index, monkeypatch, capsys,
                                          verbose, hw1):
    """The read loop's stderr -- the progress lines, the done line, and under
    --verbose the blank line, the throughput line (its figure masked) and
    host wave 1's verified share -- equals JAX's on a run past the progress
    threshold (10,000 pairs in batches of 1,000)."""
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", hw1)
    monkeypatch.setattr(tpipe, "_PROGRESS_EVERY", PROGRESS_T)
    jupdate = jpipe._Progress.update
    monkeypatch.setattr(
        jpipe._Progress, "update",
        lambda self, n, done: jupdate(self, n * (1000000 // PROGRESS_T),
                                      done))
    kw = dict(files=[R1, R2], batch_size=1000, fld_mean=180, fld_sd=20,
              verbose=verbose)
    capsys.readouterr()
    jrun_quant(JOptions(**kw), index=port_index)
    want = capsys.readouterr().err
    run_quant(Options(**kw), index=port_index, device="cpu")
    got = capsys.readouterr().err

    def mask(err):
        return re.sub(r"throughput: [0-9,]+ reads/s", "throughput: X", err)

    assert "[progress] 0M reads processed" in got
    assert ("throughput: " in got) == verbose
    assert ("host wave-1 verified" in got) == (verbose and hw1 == "1")
    assert mask(got) == mask(want)


def test_batch_size_invariance(port_index):
    """EC counts must not depend on device batch boundaries."""
    r1 = run_quant(Options(files=[R1, R2], batch_size=10000),
                   index=port_index, device="cpu")
    r2 = run_quant(Options(files=[R1, R2], batch_size=1536),
                   index=port_index, device="cpu")
    np.testing.assert_array_equal(r1.counts, r2.counts)
    assert [s.tolist() for s in r1.ec_sets] == [s.tolist() for s in r2.ec_sets]
    np.testing.assert_array_equal(r1.est_counts, r2.est_counts)


def test_threads_run_on_one_device(port_index, tmp_path):
    """-t N asks for up to N devices; the CPU is one, so -t 4 runs there
    and gives the same bytes as without -t."""
    out = str(tmp_path / "t4")
    run_quant(Options(files=[R1, R2], output_dir=out, threads=4,
                      batch_size=4096), index=port_index, device="cpu")
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, "quant_paired", "abundance.tsv"))


STEADY_CASES = {
    "plain": dict(),
    "min_range": dict(min_range=50),
    "fr": dict(strand="fr"),
    "w2_overflow": dict(),
}


def _count_calls(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("case", sorted(STEADY_CASES))
def test_paired_steady_state_matches_jax_and_per_read(port_index, tmp_path,
                                                      monkeypatch, case):
    """Paired runs that leave FLD learning after 1000 fragment lengths and
    take the steady state for the rest, through the anchor kernel on both
    sides: abundance.tsv byte-equal to the JAX package's run under the same
    settings (device path, no host probe), the same anchor batches, EC
    counts and EC sets equal to the port's own all-per-read run.  The port
    has no wave-2 capacity, so it never redoes an anchor batch through
    kernel D; the w2_overflow case pins JAX's capacity at 1 read, so that
    JAX redoes every one, and the bytes stay equal.  Without a filter the
    resolver reads new keys' slim rows first (kernel F's slim layout);
    with one it fetches every new key's full exemplar."""
    kw = dict(files=[R1, R2], batch_size=1024, **STEADY_CASES[case])
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", "1000")
    # JAX's capacity hints outlive a run: start from none
    monkeypatch.setattr(jpipe, "_W2_HINTS", {})
    if case == "w2_overflow":
        monkeypatch.setattr(jpipe, "_w2_cap", lambda B2: 1)
    tcalls, jcalls = {}, {}
    _count_calls(monkeypatch, anchor_mod, "pseudoalign_pair_anchor", tcalls)
    _count_calls(monkeypatch, turbo_mod, "pseudoalign_pair_turbo", tcalls)
    _count_calls(monkeypatch, jpipe, "pseudoalign_pair_anchor", jcalls)
    _count_calls(monkeypatch, jpipe, "pseudoalign_pair_turbo", jcalls)
    _count_calls(monkeypatch, tpipe, "gather_slim", tcalls)
    out = str(tmp_path / "port")
    res = run_quant(Options(output_dir=out, **kw), index=port_index,
                    device="cpu")
    routes = _routes(res)
    assert routes["turbo"] > 0 and routes["full"] > 0, routes
    assert routes["fallback"] == routes["compact"] == 0, routes
    jout = str(tmp_path / "jax")
    jrun_quant(JOptions(output_dir=jout, plaintext=True, **kw),
               index=port_index)
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(jout, "abundance.tsv"))
    assert tcalls["pseudoalign_pair_anchor"] == routes["turbo"] == \
        jcalls["pseudoalign_pair_anchor"]
    assert "pseudoalign_pair_turbo" not in tcalls
    assert ("gather_slim" in tcalls) == (case in ("plain", "w2_overflow"))
    if case == "w2_overflow":
        assert jcalls["pseudoalign_pair_turbo"] == routes["turbo"]
    assert 0 < res.timings["wave2_reads"] < 2 * kw["batch_size"] \
        * routes["turbo"]
    monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", "1000000")
    full = run_quant(Options(**kw), index=port_index, device="cpu")
    assert _routes(full)["turbo"] == 0
    np.testing.assert_array_equal(res.counts, full.counts)
    assert [s.tolist() for s in res.ec_sets] == \
        [s.tolist() for s in full.ec_sets]


def test_n_dense_batches_take_the_compact_route(port_index, tmp_path,
                                                monkeypatch):
    """Reads with Ns and an aux vector that holds none: every batch with
    an N goes through the bitmask kernels (the compact route) and gives
    the same bytes as the turbo route and the JAX package."""
    import gzip

    rng = np.random.default_rng(17)
    src = gzip.open(R1, "rt").read().split("\n")
    for i in range(1, len(src), 4):
        if src[i] and rng.random() < 0.05:
            s = list(src[i])
            for j in rng.integers(0, len(s), 2):
                s[j] = "N"
            src[i] = "".join(s)
    fq = str(tmp_path / "n_reads.fastq.gz")
    with gzip.open(fq, "wt") as f:
        f.write("\n".join(src))
    kw = dict(files=[fq], single_end=True, fld_mean=180, fld_sd=20,
              batch_size=4096)
    # the card's routes: host wave 1 off in both packages
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    outs = {}
    for route in ("turbo", "compact"):
        if route == "compact":
            monkeypatch.setattr(turbo_mod, "EXC_CAP", 0)
        out = str(tmp_path / route)
        res = run_quant(Options(output_dir=out, **kw), index=port_index,
                        device="cpu")
        routes = _routes(res)
        assert routes[route] > 0 and routes["full"] == 0, routes
        outs[route] = _read(os.path.join(out, "abundance.tsv"))
    jout = str(tmp_path / "jax")
    jrun_quant(JOptions(output_dir=jout, plaintext=True, **kw),
               index=port_index)
    assert outs["compact"] == outs["turbo"] == \
        _read(os.path.join(jout, "abundance.tsv"))


DLIST_CASES = {
    "quant_dlist_mix": (dict(dlist_paths=[os.path.join(DATA, "dlist.fasta")]),
                        9567),
    "quant_dlist_D3": (dict(dlist_paths=[os.path.join(DATA, "dlist.fasta")],
                            dlist_overhang=3), 9566),
    "quant_dlist_multi": (dict(dlist_paths=[
        os.path.join(DATA, "dlist_part1.fasta"),
        os.path.join(DATA, "dlist_part2.fasta")]), 9567),
}


@pytest.mark.parametrize("case", sorted(DLIST_CASES))
def test_dlist_goldens_with_contaminants(tmp_path, case):
    """The D-list goldens over two file pairs (bundled reads + 200
    contaminant pairs), as tests/test_dlist.py builds them."""
    ikw, n_aligned = DLIST_CASES[case]
    index = build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31,
                        **ikw)
    out = str(tmp_path / case)
    res = run_quant(Options(
        files=[R1, R2, os.path.join(DATA, "contam_1.fastq.gz"),
               os.path.join(DATA, "contam_2.fastq.gz")],
        output_dir=out, plaintext=True), index=index, device="cpu")
    assert res.num_pseudoaligned == n_aligned
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, case, "abundance.tsv"))


def test_cli_index_and_quant_on_cpu(port_index, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE), env.get("PYTHONPATH", "")])
    idx = str(tmp_path / "idx.npz")
    out = str(tmp_path / "out")
    cli = [sys.executable, "-m", "kallisto_tpu_torch.cli"]
    subprocess.run(
        cli + ["index", "-i", idx, os.path.join(DATA, "transcripts.fasta.gz")],
        check=True, env=env, capture_output=True,
    )
    subprocess.run(
        cli + ["quant", "-i", idx, "-o", out, "--device", "cpu",
               "--write-index", R1, R2],
        check=True, env=env, capture_output=True,
    )
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, "quant_paired", "abundance.tsv"))
    assert _read(os.path.join(out, "counts.txt")) == \
        _read(os.path.join(GOLDEN, "quant_paired_wi", "counts.txt"))
    assert '"n_pseudoaligned": 9413' in _read(os.path.join(out, "run_info.json"))


def test_cli_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE), env.get("PYTHONPATH", "")])
    idx = str(tmp_path / "idx.npz")
    save_index(build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31), idx)
    p = subprocess.run(
        [sys.executable, "-m", "kallisto_tpu_torch.cli", "quant", "-i", idx,
         "-o", str(tmp_path / "o"), R1, R2],
        env=env, capture_output=True, text=True,
    )
    assert p.returncode != 0
    assert "device='cpu'" in p.stderr or "--device cpu" in p.stderr


@pytest.fixture(scope="module")
def index_file(port_index, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("idx") / "idx.npz")
    save_index(port_index, path)
    return path


def test_cli_threads_flag_gives_golden_bytes(index_file, tmp_path):
    """-t/--threads is accepted and, on one device, changes nothing."""
    from kallisto_tpu_torch import cli

    out = str(tmp_path / "t4")
    assert cli.main(["quant", "-i", index_file, "-o", out, "-t", "4",
                     "--device", "cpu", "--plaintext", R1, R2]) == 0
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, "quant_paired", "abundance.tsv"))


def test_cli_bootstrap_bias_seed_equal_run_quant(port_index, index_file,
                                                 tmp_path):
    """-b 2 --seed 7 --bias through the CLI writes what run_quant writes
    with the same options (run_info.json but its start time and call)."""
    from kallisto_tpu_torch import cli

    out = str(tmp_path / "cli")
    assert cli.main(["quant", "-i", index_file, "-o", out, "-t", "4",
                     "-b", "2", "--seed", "7", "--bias", "--plaintext",
                     "--device", "cpu", R1, R2]) == 0
    direct = str(tmp_path / "direct")
    res = run_quant(Options(files=[R1, R2], output_dir=direct, threads=4,
                            bootstrap=2, seed=7, bias=True, plaintext=True),
                    index=port_index, device="cpu")
    assert res.bootstraps.shape == (2, port_index.num_trans)
    assert res.bias5 is not None and res.bias5.sum() > 0
    names = ["abundance.tsv", "bs_abundance_0.tsv", "bs_abundance_1.tsv"]
    assert sorted(os.listdir(out)) == sorted(names + ["run_info.json"])
    for name in names:
        assert _read(os.path.join(out, name)) == \
            _read(os.path.join(direct, name)), name

    def info(d):
        return [ln for ln in _read(os.path.join(d, "run_info.json")).split("\n")
                if '"start_time"' not in ln and '"call"' not in ln]

    assert info(out) == info(direct)
    assert '\t"n_bootstraps": 2,' in info(out)
    seed42 = run_quant(Options(files=[R1, R2], bootstrap=2, bias=True),
                       index=port_index, device="cpu")
    assert not np.array_equal(seed42.bootstraps, res.bootstraps)


def test_cli_no_jump_gives_golden_bytes(index_file, tmp_path):
    """quant --no-jump is accepted and changes nothing: every window is
    evaluated anyway (JAX cli.py:345)."""
    from kallisto_tpu_torch import cli

    out = str(tmp_path / "nj")
    assert cli.main(["quant", "-i", index_file, "-o", out, "--no-jump",
                     "--device", "cpu", "--plaintext", R1, R2]) == 0
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, "quant_paired", "abundance.tsv"))


def test_cli_bus_no_jump_is_accepted(index_file, tmp_path):
    from kallisto_tpu_torch import cli

    out = str(tmp_path / "bus")
    assert cli.main(["bus", "-i", index_file, "-o", out, "-x", "10xv2",
                     "--no-jump", "--device", "cpu",
                     os.path.join(DATA, "sc_reads_1.fastq.gz"),
                     os.path.join(DATA, "sc_reads_2.fastq.gz")]) == 0
    with open(os.path.join(out, "output.bus"), "rb") as f, \
            open(os.path.join(GOLDEN, "bus10xv2", "output.bus"), "rb") as g:
        assert f.read() == g.read()


def test_cli_fusion_exits_1_with_jax_message(index_file, tmp_path, capsys):
    """quant --fusion exits 1 with the JAX CLI's message (cli.py:110-113)."""
    from kallisto_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["quant", "-i", index_file, "-o", str(tmp_path / "f"),
                  "--fusion", "--device", "cpu", R1, R2])
    assert e.value.code == ("Error: fusion detection is not implemented (the "
                            "reference 0.51.1 exits with 'TODO: Implement "
                            "fusion' as well)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE), env.get("PYTHONPATH", "")])
    p = subprocess.run(
        [sys.executable, "-m", "kallisto_tpu_torch.cli", "quant", "-i",
         index_file, "-o", str(tmp_path / "f"), "--fusion", "--device",
         "cpu", R1, R2], env=env, capture_output=True, text=True)
    assert p.returncode == 1 and "fusion detection" in p.stderr


def test_cli_genomebam_needs_a_gtf(index_file, tmp_path):
    from kallisto_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["quant", "-i", index_file, "-o", str(tmp_path / "g"),
                  "--genomebam", "--device", "cpu", R1, R2])
    assert e.value.code == "Error: need GTF file for genome alignment"


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", ["aa", "distinguish"])
def test_cli_index_aa_and_distinguish(tmp_path, case):
    """index --aa / --distinguish through the CLI (with -t, -T and -m
    accepted) save the arrays of build_index(aa=...) / (distinguish=...);
    --aa with a D-list forces its overhang to 3."""
    from kallisto_tpu_torch import cli

    if case == "aa":
        fasta = [os.path.join(DATA, "aa_ref.fasta")]
        flags = ["--aa", "-d", os.path.join(DATA, "dlist.fasta")]
        want = build_index(fasta, k=7, aa=True,
                           dlist_paths=[os.path.join(DATA, "dlist.fasta")],
                           dlist_overhang=3)
    else:
        fasta = [os.path.join(DATA, "distinguish_colors.fasta")]
        flags = ["--distinguish", "-d",
                 os.path.join(DATA, "distinguish_polyA.fasta")]
        want = build_index(fasta, k=7, distinguish=True, dlist_paths=[
            os.path.join(DATA, "distinguish_polyA.fasta")])
    got_path = str(tmp_path / "cli.npz")
    assert cli.main(["index", "-i", got_path, "-k", "7", "-t", "2", "-T",
                     str(tmp_path / "tmp"), "-m", "5", *flags, *fasta]) == 0
    want_path = str(tmp_path / "api.npz")
    save_index(want, want_path)
    got, exp = _npz(got_path), _npz(want_path)
    assert sorted(got) == sorted(exp)
    for k in exp:
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)


TIME_TAG = re.compile(r"\[time\] (.+?) \d+\.\d{3}s")


@pytest.mark.parametrize("w2cap", ["default", "one_read"])
@pytest.mark.parametrize("hw1", ["0", "1"])
def test_timing_tags_match_jax(port_index, monkeypatch, capsys, hw1, w2cap):
    """KALLISTO_TPU_TIMING=1: the `[time]` tags of a run that learns the
    FLD and then reaches the steady state, in order, equal JAX's on the
    same run (the seconds masked) -- host wave 1 off (the per-read route's
    `full:` lines while the FLD is learned) and on (hw1pb writes none,
    then `probe`, `w2dispatch nf=<n>`, `w2fetch`, `resolve` per hw1
    batch).  The port has no wave-2 capacity; with JAX's pinned at one
    read JAX redoes its anchor batches through kernel D, which writes no
    line, so the tags stay equal."""
    monkeypatch.setenv("KALLISTO_TPU_TIMING", "1")
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", hw1)
    monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", "1000")
    monkeypatch.setattr(jpipe, "_W2_HINTS", {})
    if w2cap == "one_read":
        monkeypatch.setattr(jpipe, "_w2_cap", lambda B2: 1)
    kw = dict(files=[R1, R2], batch_size=1024)
    capsys.readouterr()
    jrun_quant(JOptions(**kw), index=port_index)
    want = TIME_TAG.findall(capsys.readouterr().err)
    res = run_quant(Options(**kw), index=port_index, device="cpu")
    got = TIME_TAG.findall(capsys.readouterr().err)
    assert got == want
    t = res.timings
    if hw1 == "0":
        assert got == ["full:hashes", "full:resolve", "full:overflow"] \
            * t["full"]
        assert t["turbo"] > 0
    else:
        assert t["hw1"] > 0 and t["hw1pb"] > 0
        assert got.count("w2fetch") == got.count("resolve") == t["hw1"]
        assert [g for g in got if g.startswith("w2dispatch")] == \
            [g for g in want if g.startswith("w2dispatch")]
        assert got.count("probe") == t["hw1"]


def test_timing_is_silent_without_the_variable(port_index, monkeypatch,
                                               capsys):
    monkeypatch.delenv("KALLISTO_TPU_TIMING", raising=False)
    monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", "1000")
    run_quant(Options(files=[R1, R2], batch_size=1024), index=port_index,
              device="cpu")
    assert "[time]" not in capsys.readouterr().err


def test_profile_writes_a_chrome_trace(port_index, monkeypatch, tmp_path):
    """KALLISTO_TPU_PROFILE=<dir>: a torch.profiler Chrome trace of the
    whole of run_quant lands in <dir> (CPU activities here), its spans
    from the index upload to the writers among the trace's ranges; the
    outputs are those of a run without it."""
    import json

    d = tmp_path / "prof"
    monkeypatch.setenv("KALLISTO_TPU_PROFILE", str(d))
    kw = dict(files=[R1], single_end=True, fld_mean=180, fld_sd=20,
              batch_size=4096)
    res = run_quant(Options(output_dir=str(tmp_path / "o"), plaintext=True,
                            **kw), index=port_index, device="cpu")
    files = os.listdir(d)
    assert files == [f"quant_{os.getpid()}.json"]
    with open(d / files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    ranges = {e["name"] for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"quant.run", "quant.index_upload", "quant.read_loop",
            "quant.em", "quant.write"} <= ranges
    monkeypatch.delenv("KALLISTO_TPU_PROFILE")
    plain = run_quant(Options(**kw), index=port_index, device="cpu")
    np.testing.assert_array_equal(res.counts, plain.counts)
