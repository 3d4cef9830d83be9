"""--pseudobam through the port, on the CPU, against the reference golden
and the JAX package.

- tests/golden/pseudobam_clean: the checks of
  tests/test_pseudobam_golden.py::test_pseudobam_forward_records_byte_exact
  (header text, reference dictionary, record count, name order, the self
  fields of every forward record), with host wave 1 on (pairs on hw1pb:
  the probe's per-read keys and first hits, kernel K, E's per-read slots
  and F's slim rows) and off (per read, kernels A and B);
- the decompressed BAM byte-equal to the JAX package's with the switch
  both ways, and the port's own on/off BAMs byte-equal (the 10,000 bundled
  pairs, with and without -l, and single-end);
- pseudoaln.bin at 32 bytes per pair, and --pseudobam through the CLI
  byte-equal to run_quant.
"""

import os

import pytest
import torch

import test_pseudobam_golden as jpg
from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
from kallisto_tpu_torch.cli import main as cli_main
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index, save_index
from kallisto_tpu_torch.quant.pipeline import run_quant

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")
R1 = os.path.join(DATA, "reads_1.fastq.gz")
R2 = os.path.join(DATA, "reads_2.fastq.gz")


@pytest.fixture(scope="module")
def index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)


def _bam(out):
    return jpg.bgzf_decompress(os.path.join(out, "pseudoalignments.bam"))


def _port(index, out, monkeypatch, hw, **kw):
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", hw)
    res = run_quant(Options(output_dir=out, plaintext=True, pseudobam=True,
                            **kw), index=index, device="cpu")
    return res, _bam(out)


@pytest.mark.parametrize("hw", ["0", "1"])
def test_pseudobam_forward_records_match_golden(index, tmp_path, monkeypatch,
                                                hw):
    res, mine = _port(
        index, str(tmp_path / "pb"), monkeypatch, hw,
        files=[os.path.join(DATA, "clean_pb_1.fastq.gz"),
               os.path.join(DATA, "clean_pb_2.fastq.gz")])
    assert res.timings["hw1pb" if hw == "1" else "full"] > 0
    golden = jpg.bgzf_decompress(
        os.path.join(GOLDEN, "pseudobam_clean", "pseudoalignments.bam"))
    gt, gr, ga = jpg.split_bam(golden)
    mt, mr, ma = jpg.split_bam(mine)
    assert gt == mt
    assert gr == mr
    assert len(ga) == len(ma)
    fw = eq = 0
    for a, b in zip(ga, ma):
        assert a[32 : 32 + a[8]] == b[32 : 32 + b[8]]
        if int.from_bytes(b[14:16], "little") & 0x14:
            continue
        fw += 1
        eq += jpg._self_fields(a) == jpg._self_fields(b)
    assert fw >= 700
    assert eq == fw


CASES = {
    "paired": dict(files=[R1, R2]),
    "paired_l": dict(files=[R1, R2], fld_mean=180.0, fld_sd=20.0),
    "single": dict(files=[R1], single_end=True, fld_mean=180.0, fld_sd=20.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pseudobam_bytes_equal_jax_and_switch(index, tmp_path, monkeypatch,
                                              case):
    """The BAM with the switch on equals the switch off's and JAX's (JAX
    with its host probe on).  Paired batches take hw1pb with the switch on;
    single-end --pseudobam batches stay per read in both packages."""
    kw = CASES[case]
    res_on, on = _port(index, str(tmp_path / "on"), monkeypatch, "1", **kw)
    res_off, off = _port(index, str(tmp_path / "off"), monkeypatch, "0",
                         **kw)
    assert on == off
    want = "full" if case == "single" else "hw1pb"
    assert res_on.timings[want] > 0 and res_off.timings["hw1pb"] == 0
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "1")
    jout = str(tmp_path / "jax")
    jrun_quant(JOptions(output_dir=jout, plaintext=True, pseudobam=True, **kw),
               index=index)
    assert _bam(jout) == on
    spill = os.path.join(str(tmp_path / "on"), "pseudoaln.bin")
    per_read = 32 if len(kw["files"]) == 2 else 18
    assert os.path.getsize(spill) == per_read * res_on.num_processed


def test_pseudobam_through_the_cli(index, tmp_path, monkeypatch):
    """quant --pseudobam through the CLI gives run_quant's bytes."""
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "1")
    idx = str(tmp_path / "idx.npz")
    save_index(index, idx)
    out = str(tmp_path / "cli")
    cli_main(["quant", "-i", idx, "-o", out, "--pseudobam", "--plaintext",
              "--device", "cpu", R1, R2])
    _, want = _port(index, str(tmp_path / "api"), monkeypatch, "1",
                    files=[R1, R2])
    assert _bam(out) == want
    with open(os.path.join(out, "abundance.tsv")) as f, \
            open(os.path.join(GOLDEN, "quant_paired", "abundance.tsv")) as g:
        assert f.read() == g.read()
