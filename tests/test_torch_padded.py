"""The port's padded device index layout against the JAX package's, on
the CPU (the plain PyTorch versions).

The port's device_index_from_host must choose JAX's layout (padded when
2^p * S * 16 bytes of bucket rows fit _PADDED_BYTES_BUDGET), its padded
tables must equal JAX's PaddedDeviceIndex bit for bit, and the plain
lookup_kmers (kernel L's plain version, the probe of kernels A, D, I, J
and K) must equal JAX's padded lookup_kmers in slot, hit and EC row on
index k-mers, random k-mers and invalid windows, and so must kernel L's
bucketed search over packed (key, EC row) entries (packed_entries_plain
and lookup_kmers_packed_plain) against JAX's bucketed lookup_kmers.
Each case that forces
a layout patches both packages' budgets together.  The bucketed run loop
stays covered: `quant` forced to the bucketed layout gives the golden
bytes.  The kernels themselves are held against these plain versions on
the card by tests/test_torch_kernels.py, in both layouts.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
from kallisto_tpu.index import build_index as jbuild
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index as tbuild
from kallisto_tpu_torch.ops import pseudoalign as tpa
from kallisto_tpu_torch.quant.pipeline import run_quant

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")
FASTA = os.path.join(DATA, "transcripts.fasta.gz")
K = 31


@pytest.fixture(scope="module")
def indexes():
    return jbuild([FASTA], k=K), tbuild([FASTA], k=K)


@pytest.fixture(scope="module")
def padded(indexes):
    """Both packages' device indexes in the bundled index's own layout."""
    jindex, tindex = indexes
    return (jpa.device_index_from_host(jindex),
            tpa.device_index_from_host(tindex, "cpu"))


def _set_budget(monkeypatch, budget):
    monkeypatch.setattr(jpa, "_PADDED_BYTES_BUDGET", budget)
    monkeypatch.setattr(tpa, "_PADDED_BYTES_BUDGET", budget)


@pytest.mark.parametrize("budget", ["default", "one_byte_under", "at"])
def test_layout_choice_matches_jax(indexes, monkeypatch, budget):
    jindex, tindex = indexes
    M, S = tpa.padded_shape(tpa.cached_probe_layout(tindex))
    need = M * S * 16
    if budget != "default":
        _set_budget(monkeypatch, need - 1 if budget == "one_byte_under"
                    else need)
    j = jpa.device_index_from_host(jindex)
    t = tpa.device_index_from_host(tindex, "cpu")
    want_padded = budget != "one_byte_under"
    assert isinstance(j, jpa.PaddedDeviceIndex) == want_padded
    assert isinstance(t, tpa.PaddedDeviceIndex) == want_padded
    assert t.p == int(np.log2(M)) and (not want_padded or t.S == S)
    assert t.device == torch.device("cpu")


@pytest.mark.parametrize("field", ["bucket_rows", "kmer_uid", "kmer_pos",
                                   "kmer_fw", "kmer_block", "block_ec8"])
def test_padded_tables_match_jax(padded, field):
    j, t = padded
    want = np.asarray(getattr(j, field))
    if field == "bucket_rows":
        want = want.view(np.int64)
    got = getattr(t, field).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_padded_nbytes(padded):
    _, t = padded
    M, S2 = t.bucket_rows.shape
    assert t.nbytes() == (8 * M * S2 + M * S2 // 2 * (3 * 4 + 1)
                          + 4 * t.block_ec8.numel())


@pytest.mark.parametrize("which", ["hits", "misses", "invalid", "mixed"])
def test_lookup_matches_jax(indexes, padded, which):
    """Slot, hit and EC row equal to JAX's padded lookup_kmers: a miss
    names slot b * S of its bucket, an invalid window is probed with
    canon 0 and never hits."""
    _, tindex = indexes
    jd, td = padded
    rng = np.random.default_rng(17)
    n = 6000
    keys = tindex.kmer_keys.astype(np.int64)
    canon = {
        "hits": keys[rng.integers(0, keys.shape[0], n)],
        "misses": rng.integers(0, 2**62, n, dtype=np.int64),
        "invalid": keys[rng.integers(0, keys.shape[0], n)],
        "mixed": np.where(rng.random(n) < 0.5,
                          keys[rng.integers(0, keys.shape[0], n)],
                          rng.integers(0, 2**62, n, dtype=np.int64)),
    }[which]
    valid = {"invalid": np.zeros(n, bool),
             "mixed": rng.random(n) < 0.8}.get(which, np.ones(n, bool))
    canon, valid = canon.reshape(60, 100), valid.reshape(60, 100)
    want = jpa.lookup_kmers(jd, jnp.asarray(canon), jnp.asarray(valid))
    got = tpa.lookup_kmers(td, torch.from_numpy(canon),
                           torch.from_numpy(valid))
    for name, a, b in zip(("idx", "hit", "ec"), want, got):
        a = np.asarray(a)
        assert b.shape == a.shape, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    hit = got[1].numpy()
    assert hit.all() if which == "hits" else (
        not hit.any() if which in ("invalid", "misses") else 0 < hit.sum())
    if which != "hits":
        # a miss's slot is its bucket's first: b * S
        S = td.S
        miss = ~hit
        assert (got[0].numpy()[miss] % S == 0).all()
        assert (got[2].numpy()[miss] == -1).all()


def test_bucketed_quant_is_golden(indexes, monkeypatch, tmp_path):
    """`quant` forced to the bucketed layout (both budgets 0) on the
    bundled pairs: abundance.tsv byte-equal to tests/golden/quant_paired."""
    _, tindex = indexes
    _set_budget(monkeypatch, 0)
    assert isinstance(tpa.device_index_from_host(tindex, "cpu"),
                      tpa.DeviceIndex)
    out = str(tmp_path / "out")
    run_quant(Options(files=[os.path.join(DATA, "reads_1.fastq.gz"),
                             os.path.join(DATA, "reads_2.fastq.gz")],
                      output_dir=out, plaintext=True),
              index=tindex, device="cpu")
    with open(os.path.join(out, "abundance.tsv")) as f, \
            open(os.path.join(GOLDEN, "quant_paired", "abundance.tsv")) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("which", ["hits", "misses", "invalid", "mixed"])
def test_packed_lookup_matches_jax(indexes, monkeypatch, which):
    """Kernel L's bucketed table: the packed (key, EC row) entries in slot
    order, searched by the plain packed probe, give the slot, hit and EC
    row of the plain lookup_kmers and of JAX's bucketed lookup_kmers."""
    jindex, tindex = indexes
    _set_budget(monkeypatch, 0)
    jd = jpa.device_index_from_host(jindex)
    td = tpa.device_index_from_host(tindex, "cpu")
    assert isinstance(td, tpa.DeviceIndex)
    ent = tpa.packed_entries_plain(td)
    assert ent.shape == (td.kmer_hkeys.shape[0], 2)
    assert ent.dtype == torch.int64 and ent.is_contiguous()
    assert torch.equal(ent[:, 0], td.kmer_hkeys)
    assert torch.equal(ent[:, 1], td.kmer_ec.long())
    rng = np.random.default_rng(23)
    n = 6000
    keys = tindex.kmer_keys.astype(np.int64)
    canon = {
        "hits": keys[rng.integers(0, keys.shape[0], n)],
        "misses": rng.integers(0, 2**62, n, dtype=np.int64),
        "invalid": keys[rng.integers(0, keys.shape[0], n)],
        "mixed": np.where(rng.random(n) < 0.5,
                          keys[rng.integers(0, keys.shape[0], n)],
                          rng.integers(0, 2**62, n, dtype=np.int64)),
    }[which]
    valid = {"invalid": np.zeros(n, bool),
             "mixed": rng.random(n) < 0.8}.get(which, np.ones(n, bool))
    canon, valid = canon.reshape(60, 100), valid.reshape(60, 100)
    c, v = torch.from_numpy(canon), torch.from_numpy(valid)
    got = tpa.lookup_kmers_packed_plain(td, ent, c, v)
    plain = tpa.lookup_kmers(td, c, v)
    want = jpa.lookup_kmers(jd, jnp.asarray(canon), jnp.asarray(valid))
    for name, a, b, x in zip(("idx", "hit", "ec"), want, got, plain):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == x.dtype, name
        assert torch.equal(b, x), name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    hit = got[1].numpy()
    assert hit.all() if which == "hits" else (
        not hit.any() if which in ("invalid", "misses") else 0 < hit.sum())


def test_packed_entries_cache_keys_on_keys_and_ecs(indexes, monkeypatch):
    """kernels.packed_entries keeps one entry array per (key table, EC
    table): two bucketed DeviceIndexes that share kmer_hkeys but differ in
    kmer_ec each get their own entries, equal to packed_entries_plain, and
    a second call on either returns its cached array."""
    from kallisto_tpu_torch.ops import kernels

    _, tindex = indexes
    _set_budget(monkeypatch, 0)
    d1 = tpa.device_index_from_host(tindex, "cpu")
    assert isinstance(d1, tpa.DeviceIndex)
    d2 = d1._replace(kmer_ec=torch.flip(d1.kmer_ec, [0]).contiguous())
    assert d2.kmer_hkeys is d1.kmer_hkeys
    assert not torch.equal(d2.kmer_ec, d1.kmer_ec)
    e1 = kernels.packed_entries(d1)
    e2 = kernels.packed_entries(d2)
    assert torch.equal(e1, tpa.packed_entries_plain(d1))
    assert torch.equal(e2, tpa.packed_entries_plain(d2))
    assert not torch.equal(e1, e2)
    assert kernels.packed_entries(d1) is e1
    assert kernels.packed_entries(d2) is e2
