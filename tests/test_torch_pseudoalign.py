"""The port's per-read pseudoalignment, read keys and fragment lengths
against the JAX package, on the CPU (the port's plain PyTorch versions).

All ten SideResult fields must be equal to pseudoalign_batch_packed's under
both JAX device layouts.  One caveat, by construction: for a read with no
hit, f_strand is an artefact of window 0's lookup slot, whose number
differs between the JAX padded layout and the bucketed one; the port keeps
the bucketed layout, so against the padded layout f_strand is compared on
reads with hits only (the only reads whose f_strand anything reads).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
from kallisto_tpu.index import build_index as jbuild
from kallisto_tpu_torch.index import build_index as tbuild
from kallisto_tpu_torch.io.fastx import (
    ReadBatch,
    _read_batch_to_packed,
    pack_codes_host,
    packed_single_batches,
)
from kallisto_tpu_torch.ops import pseudoalign as tpa

# The test workers share the machine's cores: one intra-op thread per
# worker keeps torch's thread pools from oversubscribing them, which
# slows the many small CPU ops of these tests several times over.
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
K = 31


@pytest.fixture(scope="module")
def indexes():
    fa = os.path.join(DATA, "transcripts.fasta.gz")
    t = tbuild([fa], k=K)
    return jbuild([fa], k=K), t, tpa.device_index_from_host(t, "cpu")


def _random_batch(index, n, L, seed):
    rng = np.random.default_rng(seed)
    seq = index.unitig_seq
    starts = rng.integers(0, max(seq.shape[0] - L, 1), n)
    codes = seq[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    err = rng.random((n, L)) < 0.01
    codes[err] = (codes[err] + 1) % 4
    codes[rng.random((n, L)) < 0.005] = 4
    lens = np.full(n, L, np.int32)
    short = rng.random(n) < 0.15
    lens[short] = rng.integers(1, L + 1, int(short.sum()))
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    return _read_batch_to_packed(ReadBatch(codes=codes, lens=lens), K)


def _batch(index, which):
    if which.startswith("bundled"):
        name = "reads_1.fastq.gz" if which == "bundled_1" else "reads_2.fastq.gz"
        return next(packed_single_batches(os.path.join(DATA, name), 10000, K))
    L, seed = {"rand100": (100, 1), "rand76": (76, 2), "rand40": (40, 3),
               "rand_short": (24, 4)}[which]
    return _random_batch(index, 4000, L, seed)


def _jax_side(didx, pb):
    return jpa.pseudoalign_batch_packed(
        didx, pb.packed, pb.nmask, pb.lens, k=K, L=pb.Lp)


def _port_side(didx, pb):
    return tpa.pseudoalign_batch_packed(
        didx, *tpa.upload_batch(pb, "cpu"), k=K, L=pb.Lp)


@pytest.mark.parametrize("layout", ["padded", "bucketed"])
@pytest.mark.parametrize(
    "which", ["bundled_1", "bundled_2", "rand100", "rand76", "rand40",
              "rand_short"])
def test_side_result_matches_jax(indexes, monkeypatch, layout, which):
    jindex, tindex, tdidx = indexes
    if layout == "bucketed":
        monkeypatch.setattr(jpa, "_PADDED_BYTES_BUDGET", 0)
    jdidx = jpa.device_index_from_host(jindex)
    assert isinstance(jdidx, jpa.DeviceIndex if layout == "bucketed"
                      else jpa.PaddedDeviceIndex)
    pb = _batch(tindex, which)
    rj = _jax_side(jdidx, pb)
    rt = _port_side(tdidx, pb)
    has = np.asarray(rj.has_hits)
    # reads shorter than k have no window that can hit
    assert has.any() != (which == "rand_short")
    for f in jpa.SideResult._fields:
        a = np.asarray(getattr(rj, f))
        b = getattr(rt, f).numpy()
        if f == "f_strand" and layout == "padded":
            a, b = a[has], b[has]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("pair", [("bundled_1", "bundled_2"),
                                  ("rand100", "rand100")])
def test_pair_keys_and_fragment_lengths_match_jax(indexes, monkeypatch, pair):
    jindex, tindex, tdidx = indexes
    monkeypatch.setattr(jpa, "_PADDED_BYTES_BUDGET", 0)
    jdidx = jpa.device_index_from_host(jindex)
    p1 = _batch(tindex, pair[0])
    p2 = _batch(tindex, pair[1]) if pair[1] != pair[0] else _random_batch(
        tindex, 4000, 100, 11)
    j1, j2 = _jax_side(jdidx, p1), _jax_side(jdidx, p2)
    t1, t2 = _port_side(tdidx, p1), _port_side(tdidx, p2)
    np.testing.assert_array_equal(
        np.asarray(jpa.pair_key_hash(j1, j2)), tpa.pair_key_hash(t1, t2).numpy())
    np.testing.assert_array_equal(
        np.asarray(jpa.pair_fragment_lengths(j1, j2, k=K)),
        tpa.pair_fragment_lengths(t1, t2, K).numpy())
    h, tl = tpa.read_keys(t1, t2, K)
    assert h.dtype == torch.int64 and tl.dtype == torch.int32
    assert (tl >= 0).any()


@pytest.mark.parametrize("which", ["bundled_1", "rand76", "rand_short"])
def test_single_keys_match_jax(indexes, monkeypatch, which):
    jindex, tindex, tdidx = indexes
    monkeypatch.setattr(jpa, "_PADDED_BYTES_BUDGET", 0)
    jdidx = jpa.device_index_from_host(jindex)
    pb = _batch(tindex, which)
    np.testing.assert_array_equal(
        np.asarray(jpa.single_key_hash(_jax_side(jdidx, pb))),
        tpa.single_key_hash(_port_side(tdidx, pb)).numpy())


def test_mix64_matches_numpy():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2**63, 10000, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, 10000, dtype=np.uint64)
    got = tpa.mix64(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, tpa._mix64_np(x))


def test_unpack_matches_jax():
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 5, (64, 96)).astype(np.uint8)
    packed, nmask, L = pack_codes_host(codes)
    want = np.asarray(jpa.unpack_codes_device(
        jnp.asarray(packed), jnp.asarray(nmask), L))
    got = tpa.unpack_codes(torch.from_numpy(packed), torch.from_numpy(nmask), L)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)


def test_device_index_tables_match_jax_bucketed(indexes, monkeypatch):
    jindex, _, tdidx = indexes
    monkeypatch.setattr(jpa, "_PADDED_BYTES_BUDGET", 0)
    j = jpa.device_index_from_host(jindex)
    np.testing.assert_array_equal(
        np.asarray(j.kmer_hkeys).view(np.int64), tdidx.kmer_hkeys.numpy())
    for f in ("bucket_start", "kmer_uid", "kmer_pos", "kmer_fw",
              "kmer_block", "kmer_ec"):
        np.testing.assert_array_equal(
            np.asarray(getattr(j, f)), getattr(tdidx, f).numpy(), err_msg=f)
