"""Kernel A's two-wave split against the dense per-read core, on the CPU.

Kernel A (csrc/pseudoalign.cu pseudoalign_side: pseudoalign_side_kernel,
then pseudoalign_side_wave2_kernel) verifies a read by its anchors alone -- every
anchor hits one unitig on one strand at the interpolated position, at the
read's own length and with no N in an anchor's window -- and fills the
verified read's ten SideResult fields from its anchors and two block_ec8
rows; every other read goes through the dense core.  That is exact only
if the verified fields equal the dense core's.  ops/anchor.py
side_waves_plain is the same split in plain PyTorch: here it must equal
pseudoalign_batch_packed_plain (kernel A's plain version) in every field
and every bit, and both must equal the JAX package's
pseudoalign_batch_packed, in both device index layouts (padded, and
bucketed with both budgets set to 0), on the bundled index and a small
simulated one, with reads made from a numpy seed: error-free reads of
both strands, reads with errors and with Ns, ragged lengths, reads
shorter than k and of length 0, junk, reads across unitig and block
boundaries, and a padded length whose row width R = L - k + 1 is below
16.
"""

import os

import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
from kallisto_tpu.index import build_index as jbuild
from kallisto_tpu_torch.index import build_index as tbuild
from kallisto_tpu_torch.io.fastx import ReadBatch, _read_batch_to_packed
from kallisto_tpu_torch.ops import anchor as tanchor
from kallisto_tpu_torch.ops import pseudoalign as tpa
from kallisto_tpu_torch.utils.simtx import generate_transcriptome

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
K = 31


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """name -> (JAX index, port index): the bundled transcriptome and a
    40-gene simulated one."""
    sim = str(tmp_path_factory.mktemp("simtx") / "simtx.fasta.gz")
    generate_transcriptome(sim, n_genes=40, seed=3)
    out = {}
    for name, fa in (("bundled", os.path.join(DATA, "transcripts.fasta.gz")),
                     ("simtx", sim)):
        out[name] = (jbuild([fa], k=K), tbuild([fa], k=K))
    return out


def _reads(index, n, L, seed):
    """n reads of at most L bases from the index's transcripts (so they
    cross unitig and block boundaries), as the reader packs them: by
    kind, error-free on either strand, 1 % substitutions, a few Ns, a
    length drawn from [k, L], shorter than k, length 0, or random junk;
    the columns past a read's length are N."""
    rng = np.random.default_rng(seed)
    seq, off = index.target_seq, index.target_seq_off
    tl = np.diff(off)
    ok = np.flatnonzero(tl > L)
    t = ok[rng.integers(0, ok.shape[0], n)]
    starts = off[t] + (rng.random(n) * (tl[t] - L)).astype(np.int64)
    codes = seq[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = np.where(codes[rc] < 4, 3 - codes[rc], codes[rc])[:, ::-1]
    lens = np.full(n, L, np.int32)
    kind = rng.random(n)
    err = (kind >= 0.45) & (kind < 0.6)
    e = err[:, None] & (rng.random((n, L)) < 0.01)
    codes[e] = (codes[e] + 1) % 4
    ns = (kind >= 0.6) & (kind < 0.7)
    codes[ns[:, None] & (rng.random((n, L)) < 0.02)] = 4
    rag = (kind >= 0.7) & (kind < 0.82)
    lens[rag] = rng.integers(K, L + 1, int(rag.sum()))
    short = (kind >= 0.82) & (kind < 0.88)
    lens[short] = rng.integers(1, K, int(short.sum()))
    lens[(kind >= 0.88) & (kind < 0.91)] = 0
    junk = kind >= 0.96
    codes[junk] = rng.integers(0, 4, (int(junk.sum()), L))
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    return _read_batch_to_packed(ReadBatch(codes=codes, lens=lens), K)


def _layout(jindex, tindex, monkeypatch, layout):
    if layout == "bucketed":
        monkeypatch.setattr(jpa, "_PADDED_BYTES_BUDGET", 0)
        monkeypatch.setattr(tpa, "_PADDED_BYTES_BUDGET", 0)
    jdidx = jpa.device_index_from_host(jindex)
    tdidx = tpa.device_index_from_host(tindex, "cpu")
    want = (jpa.PaddedDeviceIndex, tpa.PaddedDeviceIndex) \
        if layout == "padded" else (jpa.DeviceIndex, tpa.DeviceIndex)
    assert isinstance(jdidx, want[0]) and isinstance(tdidx, want[1])
    return jdidx, tdidx


@pytest.mark.parametrize("L", [100, 76, 40])
@pytest.mark.parametrize("layout", ["padded", "bucketed"])
@pytest.mark.parametrize("which", ["bundled", "simtx"])
def test_two_waves_equal_the_dense_core(indexes, monkeypatch, which, layout,
                                        L):
    jindex, tindex = indexes[which]
    jdidx, tdidx = _layout(jindex, tindex, monkeypatch, layout)
    pb = _reads(tindex, 2000, L, seed=L + 7 * (which == "simtx"))
    Lp = pb.Lp
    assert (Lp - K + 1 < 16) == (L == 40)
    up = tpa.upload_batch(pb, "cpu")
    waves, fail = tanchor.side_waves_plain(tdidx, *up, K, Lp)
    dense = tpa.pseudoalign_batch_packed_plain(tdidx, *up, K, Lp)
    jx = jpa.pseudoalign_batch_packed(jdidx, pb.packed, pb.nmask, pb.lens,
                                      k=K, L=Lp)
    for f in tpa.SideResult._fields:
        a, b = getattr(waves, f), getattr(dense, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
        np.testing.assert_array_equal(np.asarray(getattr(jx, f)), b.numpy(),
                                      err_msg=f)
    # both waves do work: verified reads (on the bundled index some across
    # block boundaries, with several ECs; the simulated index has one block
    # per unitig); failing reads, among them full-length ones without N
    # that hit (an error, or a unitig boundary); and every read shorter
    # than k, of length 0 or holding an N in wave 2
    ver = ~fail
    lens = up[2]
    assert int(ver.sum()) > 200 and int(fail.sum()) > 200
    if which == "bundled":
        assert bool((dense.n_rows[ver] >= 2).any())
    assert bool((lens == 0).any()) and bool(fail[lens == 0].all())
    codes = tpa.unpack_codes(*up[:2], Lp)
    col = torch.arange(Lp)[None, :] < lens[:, None].long()
    has_n = ((codes >= 4) & col).any(dim=1)
    assert bool(fail[lens < K].all()) and bool(fail[has_n].all())
    assert not bool(ver[has_n | (lens < K)].any())
    assert bool((fail & dense.has_hits & (lens == L) & ~has_n).any())


@pytest.mark.parametrize("layout", ["padded", "bucketed"])
def test_unitig_reads_are_all_verified(indexes, monkeypatch, layout):
    """Reads copied from inside unitigs (either strand, ragged lengths from
    k to 100) are all verified in wave 1, and still equal the dense core;
    one substitution in the middle of each sends them all to wave 2."""
    jindex, tindex = indexes["bundled"]
    _, tdidx = _layout(jindex, tindex, monkeypatch, layout)
    rng = np.random.default_rng(17)
    n, L = 1500, 100
    off = tindex.unitig_seq_off
    ulen = np.diff(off)
    ok = np.flatnonzero(ulen >= L)
    u = ok[rng.integers(0, ok.shape[0], n)]
    starts = off[u] + (rng.random(n) * (ulen[u] - L + 1)).astype(np.int64)
    codes = tindex.unitig_seq[starts[:, None] + np.arange(L)[None, :]]
    codes = codes.astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    lens = rng.integers(K, L + 1, n).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    for mutate in (False, True):
        c = codes.copy()
        if mutate:
            mid = lens // 2
            c[np.arange(n), mid] = (c[np.arange(n), mid] + 1) % 4
        pb = _read_batch_to_packed(ReadBatch(codes=c, lens=lens), K)
        up = tpa.upload_batch(pb, "cpu")
        waves, fail = tanchor.side_waves_plain(tdidx, *up, K, pb.Lp)
        dense = tpa.pseudoalign_batch_packed_plain(tdidx, *up, K, pb.Lp)
        for f in tpa.SideResult._fields:
            a, b = getattr(waves, f), getattr(dense, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        assert int(fail.sum()) == (n if mutate else 0)


@pytest.mark.parametrize("wave", ["side_wave1", "side_wave2",
                                  "pseudoalign_side"])
def test_kernel_a_wrappers_refuse_cpu_tensors(indexes, wave):
    """Kernel A's wrapper launches or raises, for wave 1 alone, wave 2
    alone and both: CPU tensors are refused before any launch is counted
    (the dispatching pseudoalign_batch_packed sends them to the plain
    version instead)."""
    from kallisto_tpu_torch.ops import kernels

    tdidx = tpa.device_index_from_host(indexes["bundled"][1], "cpu")
    up = tpa.upload_batch(_reads(indexes["bundled"][1], 8, 100, 1), "cpu")
    kw = {"side_wave1": dict(waves=1), "pseudoalign_side": {},
          "side_wave2": dict(waves=2, lists=(
              None, torch.zeros(8, dtype=torch.int32),
              torch.zeros(1, dtype=torch.int64)))}[wave]
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        kernels.pseudoalign_side(tdidx, *up, K, 104, 16, **kw)
    assert kernels.LAUNCHES == before
