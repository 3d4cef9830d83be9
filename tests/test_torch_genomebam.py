"""--genomebam through the port, on the CPU: the five checks of
tests/test_genomebam.py (sort order and header, GTF projection, spliced
CIGARs, ZW posteriors, the BAI) and its pseudoaln.bin check, on the
port's output, plus bytes (BAM and BAI) equal to the JAX package's run and
to the port's own run with host wave 1 off.
"""

import os

import pytest
import torch

import test_genomebam as jg
from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.io.bam import read_bgzf
from kallisto_tpu_torch.quant.pipeline import run_quant

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GB = dict(
    files=[os.path.join(DATA, "reads_1.fastq.gz"),
           os.path.join(DATA, "reads_2.fastq.gz")],
    pseudobam=True, genomebam=True,
    gtf_file=os.path.join(DATA, "transcripts.gtf.gz"),
    chrom_file=os.path.join(DATA, "chrom.txt"),
)


@pytest.fixture(scope="module")
def port_index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)


@pytest.fixture(scope="module")
def port_gbam(port_index, tmp_path_factory):
    """The port's genome BAM with host wave 1 on (pairs on hw1pb)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KALLISTO_TPU_HOST_WAVE1", "1")
    out = str(tmp_path_factory.mktemp("port_gbam"))
    res = run_quant(Options(output_dir=out, **GB), index=port_index,
                    device="cpu")
    mp.undo()
    assert res.timings["hw1pb"] > 0
    return out


def test_port_genomebam_sorted_and_header(port_gbam, data_dir):
    jg.test_genomebam_sorted_and_header(port_gbam, data_dir)


def test_port_genomebam_projection_matches_gtf(port_gbam, test_index,
                                               data_dir):
    jg.test_genomebam_projection_matches_gtf(port_gbam, test_index, data_dir)


def test_port_genomebam_spliced_cigars(port_gbam):
    jg.test_genomebam_spliced_cigars(port_gbam)


def test_port_genomebam_zw_posteriors(port_gbam):
    jg.test_genomebam_zw_posteriors(port_gbam)


def test_port_genomebam_bai_valid(port_gbam):
    jg.test_genomebam_bai_valid(port_gbam)


def test_port_pseudoaln_spill(port_gbam):
    """pseudoaln.bin beside the BAM, 32 bytes per pair."""
    assert os.path.getsize(os.path.join(port_gbam, "pseudoaln.bin")) == \
        32 * 10000


def _files(out):
    bam = read_bgzf(os.path.join(out, "pseudoalignments.bam"))
    with open(os.path.join(out, "pseudoalignments.bam.bai"), "rb") as f:
        return bam, f.read()


def test_port_genomebam_bytes_equal_jax_and_switch_off(port_gbam, port_index,
                                                       tmp_path, monkeypatch):
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "1")
    jout = str(tmp_path / "jax")
    jrun_quant(JOptions(output_dir=jout, **GB), index=port_index)
    assert _files(port_gbam) == _files(jout)
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    off = str(tmp_path / "off")
    run_quant(Options(output_dir=off, **GB), index=port_index, device="cpu")
    assert _files(off) == _files(port_gbam)
