"""The port's sequence-specific bias (`quant --bias`, plain PyTorch path
on the CPU) against the JAX package.

Hexamer ids (kernel H's plain version) must be equal to JAX's
bias_hexamers on the same SideResults (bucketed layout, as the per-read
tests compare them); update_eff_lens is a numpy copy and must be bitwise
equal.  End to end, bias5 must be equal, abundance.tsv byte-equal, and
the bias-corrected lengths and the expected hexamer distribution
(post_bias) within rtol 1e-12: they come from alpha, which the two EMs
agree on to rtol 1e-12 (tests/test_torch_em.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
import kallisto_tpu.quant.bias as jbias
import kallisto_tpu.quant.pipeline as jpipe
from kallisto_tpu.common import Options as JOptions
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.io.fastx import packed_single_batches
from kallisto_tpu_torch.ops import pseudoalign as tpa
from kallisto_tpu_torch.quant import bias as tbias
from kallisto_tpu_torch.quant import pipeline as tpipe

# The test workers share the machine's cores: one intra-op thread per
# worker keeps torch's thread pools from oversubscribing them, which
# slows the many small CPU ops of these tests several times over.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
R1 = os.path.join(DATA, "reads_1.fastq.gz")
R2 = os.path.join(DATA, "reads_2.fastq.gz")
K = 31


@pytest.fixture(scope="module")
def port_index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=K)


def _read(path):
    with open(path) as f:
        return f.read()


def _sides(port_index, monkeypatch):
    """(JAX, port) SideResults of both bundled mates (bucketed layout in
    both packages)."""
    monkeypatch.setattr(jpa, "_PADDED_BYTES_BUDGET", 0)
    monkeypatch.setattr(tpa, "_PADDED_BYTES_BUDGET", 0)
    jdidx = jpa.device_index_from_host(port_index)
    tdidx = tpa.device_index_from_host(port_index, "cpu")
    out = []
    for f in (R1, R2):
        pb = next(packed_single_batches(f, 10000, K))
        j = jpa.pseudoalign_batch_packed(jdidx, pb.packed, pb.nmask, pb.lens,
                                         k=K, L=pb.Lp)
        t = tpa.pseudoalign_batch_packed(tdidx, *tpa.upload_batch(pb, "cpu"),
                                         k=K, L=pb.Lp)
        out.append((j, t))
    return out


@pytest.mark.parametrize("paired", [True, False])
def test_bias_hexamers_match_jax(port_index, monkeypatch, paired):
    (j1, t1), (j2, t2) = _sides(port_index, monkeypatch)
    jbt = jpa.bias_tables_from_host(port_index)
    tbt = tpa.bias_tables_from_host(port_index, "cpu")
    if paired:  # mate 1's hexamer where mate 2 has hits (JAX :937)
        jv, tv = j2.has_hits, t2.has_hits
    else:  # every single-end read (JAX :1403)
        jv = jnp.ones(j1.has_hits.shape[0], bool)
        tv = torch.ones_like(t1.has_hits)
    want = np.asarray(jpa.bias_hexamers(jbt, j1, jv, k=K))
    got = tpa.bias_hexamers(tbt, t1, tv, K)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 500 and (want == -1).any()


def test_bias_hexamers_clip_matches_jax(port_index):
    """Random first-hit fields, many of them out of range, so that the
    start is clipped to [0, len(unitig_seq) - 6] and both sides of every
    branch are taken."""
    rng = np.random.default_rng(2)
    B = 5000
    NB = port_index.block_start.shape[0]
    U = port_index.unitig_seq_off.shape[0] - 1
    S = int(port_index.unitig_seq.shape[0])
    f = dict(
        f_block=rng.integers(-1, NB, B).astype(np.int32),
        f_uid=rng.integers(-1, U, B).astype(np.int32),
        f_upos=rng.integers(-50, S + 50, B).astype(np.int32),
        f_rpos=rng.integers(0, 80, B).astype(np.int32),
        f_strand=rng.random(B) < 0.5,
        has_hits=rng.random(B) < 0.9,
    )
    valid = rng.random(B) < 0.9
    zi = np.zeros(B, np.int32)
    zb = np.zeros(B, bool)
    base = dict(rows=np.zeros((B, 2), np.int32), n_rows=zi, overflow=zb,
                rng=zi)
    js = jpa.SideResult(**{k: jnp.asarray(v) for k, v in {**base, **f}.items()})
    ts = tpa.SideResult(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in {**base, **f}.items()})
    want = np.asarray(jpa.bias_hexamers(jpa.bias_tables_from_host(port_index),
                                        js, jnp.asarray(valid), k=K))
    got = tpa.bias_hexamers(tpa.bias_tables_from_host(port_index, "cpu"), ts,
                            torch.from_numpy(valid), K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 100


@pytest.mark.parametrize("paired", [True, False])
def test_read_keys_with_bias_match_jax(port_index, monkeypatch, paired):
    """read_keys(..., bias=) -- kernels B and H of one launch on the card,
    their plain versions here -- equals JAX's pair_key_hash /
    single_key_hash, pair_fragment_lengths and bias_hexamers (valid: mate
    2's has_hits, or every single-end read); h and tl equal the call
    without bias."""
    (j1, t1), (j2, t2) = _sides(port_index, monkeypatch)
    jbt = jpa.bias_tables_from_host(port_index)
    tbt = tpa.bias_tables_from_host(port_index, "cpu")
    if paired:
        h, tl, hx = tpa.read_keys(t1, t2, K, bias=tbt)
        jh = jpa.pair_key_hash(j1, j2)
        np.testing.assert_array_equal(
            tl.numpy(), np.asarray(jpa.pair_fragment_lengths(j1, j2, k=K)))
        jv = j2.has_hits
    else:
        h, tl, hx = tpa.read_keys(t1, None, K, bias=tbt)
        assert tl is None
        jh = jpa.single_key_hash(j1)
        jv = jnp.ones(j1.has_hits.shape[0], bool)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    want = np.asarray(jpa.bias_hexamers(jbt, j1, jv, k=K))
    assert hx.dtype == torch.int32
    np.testing.assert_array_equal(hx.numpy(), want)
    assert (want >= 0).sum() > 500 and (want == -1).any()
    h0, tl0, hx0 = tpa.read_keys(t1, t2 if paired else None, K)
    assert hx0 is None and torch.equal(h0, h)
    assert (tl0 is None and tl is None) or torch.equal(tl0, tl)


@pytest.mark.parametrize("paired", [True, False])
def test_read_keys_with_bias_clip_matches_jax(port_index, paired):
    """test_bias_hexamers_clip_matches_jax's random first-hit fields (the
    start clipped to [0, len(unitig_seq) - 6]) through read_keys with
    bias: keys, fragment lengths and hexamer ids equal JAX's."""
    rng = np.random.default_rng(2)
    B = 5000
    NB = port_index.block_start.shape[0]
    U = port_index.unitig_seq_off.shape[0] - 1
    S = int(port_index.unitig_seq.shape[0])

    def side():
        return dict(
            rows=rng.integers(-1, 60, (B, 3)).astype(np.int32),
            n_rows=np.zeros(B, np.int32), overflow=rng.random(B) < 0.1,
            rng=np.zeros(B, np.int32),
            f_block=rng.integers(-1, NB, B).astype(np.int32),
            f_uid=rng.integers(-1, U, B).astype(np.int32),
            f_upos=rng.integers(-50, S + 50, B).astype(np.int32),
            f_rpos=rng.integers(0, 80, B).astype(np.int32),
            f_strand=rng.random(B) < 0.5, has_hits=rng.random(B) < 0.9)

    f1, f2 = side(), side()
    js = [jpa.SideResult(**{k: jnp.asarray(v) for k, v in f.items()})
          for f in (f1, f2)]
    ts = [tpa.SideResult(**{k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in f.items()}) for f in (f1, f2)]
    jbt = jpa.bias_tables_from_host(port_index)
    tbt = tpa.bias_tables_from_host(port_index, "cpu")
    if paired:
        h, tl, hx = tpa.read_keys(ts[0], ts[1], K, bias=tbt)
        np.testing.assert_array_equal(h.numpy(),
                                      np.asarray(jpa.pair_key_hash(*js)))
        np.testing.assert_array_equal(
            tl.numpy(), np.asarray(jpa.pair_fragment_lengths(*js, k=K)))
        jv = js[1].has_hits
    else:
        h, tl, hx = tpa.read_keys(ts[0], None, K, bias=tbt)
        np.testing.assert_array_equal(h.numpy(),
                                      np.asarray(jpa.single_key_hash(js[0])))
        jv = jnp.ones(B, bool)
    want = np.asarray(jpa.bias_hexamers(jbt, js[0], jv, k=K))
    np.testing.assert_array_equal(hx.numpy(), want)
    assert len(np.unique(want)) > 100


def test_bias_tables_pad_unitig_seq(port_index):
    """unitig_seq on the device is the index's S bases, and its storage
    runs on to the next multiple of 8 bytes (kernel H's word loads)."""
    bt = tpa.bias_tables_from_host(port_index, "cpu")
    S = int(port_index.unitig_seq.shape[0])
    assert bt.useq.shape == (S,) and bt.useq.storage_offset() == 0
    np.testing.assert_array_equal(bt.useq.numpy(), port_index.unitig_seq)
    assert bt.useq.untyped_storage().nbytes() == -(-S // 8) * 8


@pytest.mark.parametrize("strand", [None, "fr", "rf"])
def test_update_eff_lens_bitwise_equal_to_jax(port_index, strand):
    rng = np.random.default_rng(7)
    T = port_index.num_trans
    alpha = rng.random(T) * 1000
    alpha[0] = 0.0  # below MIN_ALPHA: skipped
    lens = port_index.target_lens.astype(np.float64)
    means = np.minimum(178.02, lens)
    eff = lens - means + 1
    bias5 = rng.integers(0, 50, tbias.NUM_6MERS).astype(np.int64)
    jh, th = jbias.TranscriptHexamers(port_index), tbias.TranscriptHexamers(
        port_index)
    for f in ("fw", "rc", "tx_of", "pos_of", "seqlens", "hex_ptr"):
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f))
    want = jbias.update_eff_lens(means, bias5, jh, port_index.target_lens,
                                 alpha, eff, strand)
    got = tbias.update_eff_lens(means, bias5, th, port_index.target_lens,
                                alpha, eff, strand)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not np.array_equal(got[0], eff)


def test_update_eff_lens_without_sequences_keeps_lengths(port_index):
    """An index loaded without target sequences: no target has hexamers,
    so every effective length stays as it was."""
    import copy

    idx = copy.copy(port_index)
    idx.target_seq_off = np.zeros(1, np.int64)
    idx.target_seq = np.empty(0, np.uint8)
    T = idx.num_trans
    eff = np.linspace(100, 900, T)
    bias5 = np.ones(tbias.NUM_6MERS, np.int64)
    got, db = tbias.update_eff_lens(np.full(T, 180.0), bias5,
                                    tbias.TranscriptHexamers(idx),
                                    idx.target_lens, np.ones(T), eff, None)
    np.testing.assert_array_equal(got, eff)
    assert not db.any()


def _bias_runs(port_index, tmp_path, kw):
    """(port result, port dir, JAX dir) of one --bias run with HDF5
    output (its aux/bias_observed is JAX's bias5)."""
    pd, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    res = tpipe.run_quant(Options(output_dir=pd, bias=True, **kw),
                          index=port_index, device="cpu")
    jres = jpipe.run_quant(JOptions(output_dir=jd, bias=True, **kw),
                           index=port_index)
    return res, jres, pd, jd


def _assert_bias_equal(res, jres, pd, jd):
    import h5py  # here, not at the top: the card's machine has no h5py

    assert _read(os.path.join(pd, "abundance.tsv")) == \
        _read(os.path.join(jd, "abundance.tsv"))
    with h5py.File(os.path.join(pd, "abundance.h5")) as p, \
            h5py.File(os.path.join(jd, "abundance.h5")) as j:
        jb5 = j["aux/bias_observed"][:]
        np.testing.assert_array_equal(p["aux/bias_observed"][:], jb5)
        np.testing.assert_allclose(p["aux/bias_normalized"][:],
                                   j["aux/bias_normalized"][:], rtol=1e-12)
    np.testing.assert_array_equal(res.bias5, jb5)
    assert res.bias5.sum() > 1000
    np.testing.assert_allclose(res.eff_lens, jres.eff_lens, rtol=1e-12)
    np.testing.assert_allclose(res.em.post_bias, jres.em.post_bias,
                               rtol=1e-12)
    assert res.em.n_rounds == jres.em.n_rounds


BIAS_CASES = {
    "paired": dict(files=[R1, R2]),
    "single": dict(files=[R1], single_end=True, fld_mean=180, fld_sd=20),
    "fr": dict(files=[R1, R2], strand="fr"),
}


@pytest.mark.parametrize("case", sorted(BIAS_CASES))
def test_quant_bias_matches_jax(port_index, tmp_path, monkeypatch, case):
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    res, jres, pd, jd = _bias_runs(port_index, tmp_path,
                                   dict(batch_size=4096, **BIAS_CASES[case]))
    _assert_bias_equal(res, jres, pd, jd)
    assert res.timings["bias_update_s"] > 0
    assert res.timings["bias_tables_s"] > 0
    assert res.timings["full"] > 0 and res.timings["turbo"] == 0


@pytest.mark.parametrize("case", ["single", "paired_l"])
def test_bias_goal_with_jax_pipeline_depth(port_index, tmp_path, monkeypatch,
                                           case):
    """With a bias goal of 3,000 reads and 1,024-read batches, the goal is
    reached a few batches in: bias5 and abundance.tsv equal JAX's, and so
    does the number of batches sent per read with hexamers -- two batches
    stay pending in both packages, so the batches dispatched before the
    goal's batch is processed carry hexamers that are not counted (the
    port's: its calls of read_keys with bias)."""
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    monkeypatch.setattr(jpipe, "_BIAS_GOAL", 3000)
    monkeypatch.setattr(tpipe, "_BIAS_GOAL", 3000)
    calls = {"jax": 0, "port": 0}

    def counting(who, fn):
        def wrapped(*a, **k):
            calls[who] += 1
            return fn(*a, **k)
        return wrapped

    def counting_bias(fn):
        # the port computes the hexamers in kernel B's call (bias=)
        def wrapped(*a, **k):
            if k.get("bias") is not None:
                calls["port"] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jpipe, "bias_hexamers",
                        counting("jax", jpipe.bias_hexamers))
    monkeypatch.setattr(tpipe, "read_keys", counting_bias(tpipe.read_keys))
    kw = dict(files=[R1], single_end=True) if case == "single" else dict(
        files=[R1, R2])
    res, jres, pd, jd = _bias_runs(
        port_index, tmp_path,
        dict(batch_size=1024, fld_mean=180, fld_sd=20, **kw))
    _assert_bias_equal(res, jres, pd, jd)
    assert 3000 <= res.bias5.sum() < 4500
    assert calls["port"] == calls["jax"] == res.timings["full"]
    assert res.timings["turbo"] > 0
