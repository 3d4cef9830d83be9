"""The port's CUDA kernels against their plain PyTorch versions.

Each test runs a kernel on the card and the plain version on the CPU on
the same seeded inputs (the bundled transcriptome's index and reads, plus
random reads with Ns, ragged lengths and reads shorter than k) and
requires equality: every SideResult field and every key bit for kernels
A and B, bitwise alpha and equal rounds for kernel C.  They need a CUDA
card and skip without one; this file imports no JAX, so it also runs where
JAX is absent:

    KALLISTO_TPU_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.io.fastx import (
    ReadBatch,
    _read_batch_to_packed,
    packed_single_batches,
)
from kallisto_tpu_torch.ops import kernels
from kallisto_tpu_torch.ops import pseudoalign as pa
from kallisto_tpu_torch.quant import em as emq

DATA = os.path.join(os.path.dirname(__file__), "data")
K = 31


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def port_index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=K)


def _random_batch(index, n, L, seed):
    """Reads sampled from the index's unitig sequences (so most k-mers
    hit), with 0.5% Ns, 10% ragged lengths (some shorter than k)."""
    rng = np.random.default_rng(seed)
    seq = index.unitig_seq
    starts = rng.integers(0, max(seq.shape[0] - L, 1), n)
    codes = seq[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    codes[rng.random((n, L)) < 0.005] = 4
    lens = np.full(n, L, np.int32)
    short = rng.random(n) < 0.1
    lens[short] = rng.integers(1, L + 1, int(short.sum()))
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    return _read_batch_to_packed(ReadBatch(codes=codes, lens=lens), K)


def _bundled_batch(name):
    return next(packed_single_batches(os.path.join(DATA, name), 10000, K))


def _batches(index):
    return {
        "bundled_1": _bundled_batch("reads_1.fastq.gz"),
        "bundled_2": _bundled_batch("reads_2.fastq.gz"),
        "rand100": _random_batch(index, 5000, 100, 1),
        "rand76": _random_batch(index, 5000, 76, 2),
        "rand_short": _random_batch(index, 3000, 24, 3),
    }


def _sides(didx, pb, dev):
    return pa.pseudoalign_batch_packed(
        didx, *pa.upload_batch(pb, dev), k=K, L=pb.Lp)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "which", ["bundled_1", "bundled_2", "rand100", "rand76", "rand_short"])
def test_kernel_a_matches_plain(cuda, port_index, which):
    pb = _batches(port_index)[which]
    before = kernels.LAUNCHES["pseudoalign_side"]
    g = _sides(pa.device_index_from_host(port_index, cuda), pb, cuda)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pseudoalign_side"] == before + 1
    c = _sides(pa.device_index_from_host(port_index, "cpu"), pb, "cpu")
    for f in pa.SideResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [True, False])
def test_kernel_b_matches_plain(cuda, port_index, paired):
    bs = _batches(port_index)
    p1, p2 = (bs["bundled_1"], bs["bundled_2"]) if paired else (bs["rand76"], None)
    dg = pa.device_index_from_host(port_index, cuda)
    dc = pa.device_index_from_host(port_index, "cpu")
    g1, c1 = _sides(dg, p1, cuda), _sides(dc, p1, "cpu")
    g2 = c2 = None
    if paired:
        g2, c2 = _sides(dg, p2, cuda), _sides(dc, p2, "cpu")
    hg, tg = pa.read_keys(g1, g2, K)
    torch.cuda.synchronize()
    hc, tc = pa.read_keys(c1, c2, K)
    assert torch.equal(hg.cpu(), hc)
    if paired:
        assert torch.equal(tg.cpu(), tc)
    else:
        assert tg is None and tc is None


@pytest.mark.cuda
@pytest.mark.parametrize("use_priors", [False, True])
def test_kernel_c_em_bitwise(cuda, use_priors):
    rng = np.random.default_rng(7)
    T = 300
    ec_sets = [np.array([t], np.int32) for t in range(0, T, 3)]
    for _ in range(400):
        n = int(rng.integers(2, 12))
        ec_sets.append(np.unique(rng.choice(T, n, replace=False)).astype(np.int32))
    counts = rng.integers(0, 500, len(ec_sets)).astype(np.int64)
    eff = rng.uniform(50, 3000, T)
    priors = rng.dirichlet(np.ones(T)) if use_priors else None
    problem = emq.build_em_problem(ec_sets, T)
    g = emq.run_em(problem, counts, eff, priors=priors, device=cuda)
    c = emq.run_em(problem, counts, eff, priors=priors, device="cpu")
    assert g.n_rounds == c.n_rounds
    assert np.array_equal(g.alpha, c.alpha)
    assert np.array_equal(g.alpha_before_zeroes, c.alpha_before_zeroes)


@pytest.mark.cuda
def test_wrappers_refuse_cpu_tensors_and_count_launches(cuda, port_index):
    pb = _batches(port_index)["rand100"]
    dg = pa.device_index_from_host(port_index, cuda)
    with pytest.raises(ValueError):
        kernels.pseudoalign_side(dg, *pa.upload_batch(pb, "cpu"), K, pb.Lp, 16)
    kernels.reset_launches()
    s = _sides(dg, pb, cuda)
    pa.read_keys(s, None, K)
    assert kernels.LAUNCHES["pseudoalign_side"] == 1
    assert kernels.LAUNCHES["read_keys"] == 1
