"""The port's `quant` (plain PyTorch path, device='cpu') against the
reference goldens and against the JAX package's run.

abundance.tsv and counts.txt must be byte-identical to tests/golden (the
reference kallisto 0.51.1 outputs that the JAX package also matches), and
the run statistics and EC tables equal to the JAX run's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index, save_index
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


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_abundance_byte_equal_to_golden(port_index, tmp_path, case):
    kw, golden = GOLDEN_CASES[case]
    out = str(tmp_path / case)
    run_quant(Options(output_dir=out, batch_size=4096, **kw),
              index=port_index, device="cpu")
    assert _read(os.path.join(out, "abundance.tsv")) == \
        _read(os.path.join(GOLDEN, golden))


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


def test_batch_size_invariance(port_index):
    """EC counts must not depend on device batch boundaries."""
    r1 = run_quant(Options(files=[R1, R2], batch_size=10000),
                   index=port_index, device="cpu")
    r2 = run_quant(Options(files=[R1, R2], batch_size=1536),
                   index=port_index, device="cpu")
    np.testing.assert_array_equal(r1.counts, r2.counts)
    assert [s.tolist() for s in r1.ec_sets] == [s.tolist() for s in r2.ec_sets]
    np.testing.assert_array_equal(r1.est_counts, r2.est_counts)


@pytest.mark.parametrize("opt", [
    dict(bias=True), dict(bootstrap=2), dict(pseudobam=True),
    dict(long_read=True), dict(threads=2),
])
def test_unported_options_raise(port_index, opt):
    with pytest.raises(NotImplementedError):
        run_quant(Options(files=[R1, R2], **opt), index=port_index,
                  device="cpu")


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
