"""The port's compact-key pieces against the JAX package's, on the CPU: the
position-filter tables and rank (K12), the extended read keys (the compact
key kernel E computes in its first pass), the key table (kernel E, K6)
and the exemplar rows (kernel F, K7).

SideResults come from the JAX per-read program on the bundled index in
its bucketed layout (where every field, f_strand of hitless reads
included, is defined as the port defines it) and are handed to both
packages as numpy arrays.
"""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
import kallisto_tpu.quant.pipeline as jpipe
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.io.fastx import ReadBatch, _read_batch_to_packed
from kallisto_tpu_torch.ops import pseudoalign as tpa

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
K = 31


@pytest.fixture(scope="module", params=["padded", "bucketed"])
def env(request):
    """The bundled index and both packages' device index in one layout:
    padded (the bundled index's own) or bucketed (both budgets 0)."""
    index = build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=K)
    mp = pytest.MonkeyPatch()
    if request.param == "bucketed":
        mp.setattr(jpa, "_PADDED_BYTES_BUDGET", 0)
        mp.setattr(tpa, "_PADDED_BYTES_BUDGET", 0)
    jdidx = jpa.device_index_from_host(index, with_pos_tables=True)
    tdidx = tpa.device_index_from_host(index, "cpu", with_pos_tables=True)
    mp.undo()
    padded = request.param == "padded"
    assert isinstance(jdidx, jpa.PaddedDeviceIndex if padded
                      else jpa.DeviceIndex)
    assert isinstance(tdidx, tpa.PaddedDeviceIndex if padded
                      else tpa.DeviceIndex)
    rng = np.random.default_rng(5)
    sides = []
    for seed in (1, 2):
        n, L = 1500, 100
        seq = index.unitig_seq
        starts = rng.integers(0, seq.shape[0] - L, n)
        codes = seq[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
        rc = rng.random(n) < 0.5
        codes[rc] = (3 - codes[rc])[:, ::-1]
        codes[rng.random(n) < 0.2] = rng.integers(0, 4, L)  # hitless reads
        err = rng.random((n, L)) < 0.01
        codes[err] = (codes[err] + 1) % 4
        lens = rng.integers(K, L + 1, n).astype(np.int32)
        codes[np.arange(L)[None, :] >= lens[:, None]] = 4
        pb = _read_batch_to_packed(ReadBatch(codes=codes, lens=lens), K)
        sides.append(jpa.pseudoalign_batch_packed(
            jdidx, pb.packed, pb.nmask, pb.lens, k=K, L=pb.Lp))
    j1, j2 = sides
    t1, t2 = (tpa.SideResult(*(torch.from_numpy(np.array(a)) for a in s))
              for s in sides)
    return index, jdidx, tdidx, j1, j2, t1, t2


def test_pos_tables_match_jax(env):
    index, jdidx, tdidx = env[:3]
    for a, b in zip(jpa.pos_tables_from_host(index),
                    tpa.pos_tables_from_host(index)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jdidx.pf_ptr), tdidx.pf_ptr.numpy())
    np.testing.assert_array_equal(np.asarray(jdidx.pf_base), tdidx.pf_base.numpy())
    assert jpa.pf_probe_depth(index) == tpa.pf_probe_depth(index)


@pytest.mark.parametrize("fl", [0, 180, 400])
def test_pos_rank_and_pair_column_match_jax(env, fl):
    index, jdidx, tdidx, j1, j2, t1, t2 = env
    depth = tpa.pf_probe_depth(index)
    for js, ts in ((j1, t1), (j2, t2)):
        np.testing.assert_array_equal(
            np.asarray(jpa.pos_filter_rank(jdidx, js, fl, depth)),
            tpa.pos_filter_rank(tdidx, ts, fl, depth).numpy())
    col = tpa.pos_col_pair(tdidx, t1, t2, fl, depth).numpy()
    np.testing.assert_array_equal(
        np.asarray(jpa.pos_col_pair(jdidx, j1, j2, fl, depth)), col)
    assert (col >= 0).any() and (col == -1).any()


def _jax_key_columns(jdidx, j1, j2, spec):
    """The JAX compact key columns (compact_pair_keys :701-708 and
    compact_single_keys :722-728)."""
    cols = [j1.rows[:, i] for i in range(j1.rows.shape[1])]
    if j2 is not None:
        cols += [j2.rows[:, i] for i in range(j2.rows.shape[1])]
        cols.append(jpa._pair_flags(j1, j2, spec.k, spec.min_range))
        tail = jpa._strand_cols_pair(j1, j2)
        pc = lambda: jpa.pos_col_pair(jdidx, j1, j2, spec.pos_fl, spec.pos_depth)
    else:
        cols.append(jpa._single_flags(j1, spec.k, spec.min_range))
        tail = jpa._strand_cols_single(j1)
        pc = lambda: jpa.pos_filter_rank(jdidx, j1, spec.pos_fl, spec.pos_depth)
    if spec.strand_key or spec.pos_key:
        cols += tail
    if spec.pos_key:
        cols.append(pc())
    return cols


SPECS = [
    dict(),
    dict(min_range=50),
    dict(strand_key=True),
    dict(min_range=50, strand_key=True, pos_fl=180),
    dict(pos_fl=180),
]


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("opts", range(len(SPECS)))
def test_compact_keys_match_jax(env, paired, opts):
    index, jdidx, tdidx, j1, j2, t1, t2 = env
    kw = dict(SPECS[opts])
    if "pos_fl" in kw:
        kw["pos_depth"] = tpa.pf_probe_depth(index)
    spec = tpa.KeySpec(k=K, **kw)
    cols = _jax_key_columns(jdidx, j1, j2 if paired else None, spec)
    want_h = np.asarray(jpa._hash_columns_128(cols))
    h, flags = tpa.key_hash_plain(t1, t2 if paired else None, spec, tdidx)
    np.testing.assert_array_equal(want_h, h.numpy())
    np.testing.assert_array_equal(np.asarray(cols[t1.rows.shape[1] * (
        2 if paired else 1)]), flags.numpy())
    if spec.min_range:
        assert (flags.numpy() & 48).any()
    # the whole table through the public entry points
    if paired:
        jck = jpa.compact_pair_keys(
            j1, j2, 2048, k=K, min_range=spec.min_range,
            strand_key=spec.strand_key,
            pos_col=cols[-1] if spec.pos_key else None)
        tck = tpa.compact_pair_keys(t1, t2, 2048, didx=tdidx, **dict(
            kw, k=K))
    else:
        jck = jpa.compact_single_keys(
            j1, 2048, k=K, min_range=spec.min_range,
            strand_key=spec.strand_key,
            pos_col=cols[-1] if spec.pos_key else None)
        tck = tpa.compact_single_keys(t1, 2048, didx=tdidx, **dict(kw, k=K))
    jck = np.asarray(jpa._ck_flat(jck))
    np.testing.assert_array_equal(jck[0], tck[0].numpy())
    jr = jck[1:][jck[1:, 2] > 0]
    tr = tck[1:][tck[1:, 2] > 0].numpy()
    np.testing.assert_array_equal(jr[np.argsort(jr[:, 3])], tr)


@pytest.mark.parametrize("K_", [1, 7, 300, 5000])
def test_key_histogram_matches_jax_compact_keys(K_):
    """Random keys with many repeats (and a repeated h0 with different
    h1, which merges as in JAX): meta row, then occupied rows by
    first_idx; past K only the first K keys in read order are kept."""
    rng = np.random.default_rng(K_)
    B = 4000
    pool = rng.integers(-2**63, 2**63 - 1, (600, 2), dtype=np.int64)
    pool[1, 0] = pool[0, 0]
    pool[2, 0] = -1  # the all-ones word
    h = pool[rng.integers(0, 600, B)]
    flags = rng.integers(0, 64, 600).astype(np.int32)[
        np.searchsorted(np.unique(pool[:, 0]), h[:, 0])]
    ck = tpa.key_histogram_plain(torch.from_numpy(h), torch.from_numpy(flags), K_)
    j = jpa._compact_keys(jnp.asarray(h), jnp.asarray(flags), 5000)
    jck = np.asarray(jpa._ck_flat(j))
    n = int(jck[0, 0])
    assert int(ck[0, 0]) == n and n == np.unique(h[:, 0]).shape[0]
    jr = jck[1:][jck[1:, 2] > 0]
    jr = jr[np.argsort(jr[:, 3])]
    got = ck[1:].numpy()
    m = min(n, K_)
    np.testing.assert_array_equal(got[:m], jr[:m])
    assert not got[m:].any()


def _take(j, t, sel):
    """The reads sel of a JAX and a port SideResult."""
    return (type(j)(*(jnp.asarray(np.asarray(a)[sel]) for a in j)),
            tpa.SideResult(*(a[torch.from_numpy(sel)] for a in t)))


@pytest.mark.parametrize("K_", [7, 2048])
@pytest.mark.parametrize("opts", [0, 3])
@pytest.mark.parametrize("paired", [True, False])
def test_compact_keys_hot_key_match_jax(env, paired, opts, K_):
    """compact_pair_keys / compact_single_keys on a batch where read 0's
    key covers 60 % of the reads (the hot key kernel E merges per block
    before its global insert) and the hitless reads share one more: the
    meta row equal to JAX's, the rows JAX's in first-read order, the first
    K of them when K cuts."""
    index, jdidx, tdidx, j1, j2, t1, t2 = env
    rng = np.random.default_rng(11)
    n = int(t1.rows.shape[0])
    sel = np.where(rng.random(n) < 0.6, 0, np.arange(n))
    j1, t1 = _take(j1, t1, sel)
    j2, t2 = _take(j2, t2, sel)
    assert bool(t1.has_hits[0]) and not bool(t1.has_hits.all())
    kw = dict(SPECS[opts])
    if "pos_fl" in kw:
        kw["pos_depth"] = tpa.pf_probe_depth(index)
    spec = tpa.KeySpec(k=K, **kw)
    cols = _jax_key_columns(jdidx, j1, j2 if paired else None, spec)
    jkw = dict(k=K, min_range=spec.min_range, strand_key=spec.strand_key,
               pos_col=cols[-1] if spec.pos_key else None)
    if paired:
        jck = jpa.compact_pair_keys(j1, j2, n + 1, **jkw)
        tck, slots = tpa.compact_pair_keys(t1, t2, K_, didx=tdidx,
                                           with_slots=True, **dict(kw, k=K))
    else:
        jck = jpa.compact_single_keys(j1, n + 1, **jkw)
        tck = tpa.compact_single_keys(t1, K_, didx=tdidx, **dict(kw, k=K))
    jck = np.asarray(jpa._ck_flat(jck))
    nu = int(jck[0, 0])
    assert int(tck[0, 0]) == nu and nu < 0.5 * n
    jr = jck[1:][jck[1:, 2] > 0]
    jr = jr[np.argsort(jr[:, 3])]
    m = min(nu, K_)
    np.testing.assert_array_equal(tck[1 : m + 1].numpy(), jr[:m])
    assert not tck[m + 1 :].numpy().any()
    assert int(jr[0, 2]) > 0.55 * n  # read 0's key
    if paired:
        assert int(slots.max()) <= K_ - 1
        assert torch.equal(slots[torch.from_numpy(sel == 0)],
                           torch.zeros(int((sel == 0).sum()),
                                       dtype=torch.int32))


@pytest.mark.parametrize("K_", [1, 100, 5000])
def test_key_histogram_edge_words_match_jax(K_):
    """Keys whose h0 is 0 (an empty slot's word in kernel E's table) or all
    ones, beside one key on 55 % of the reads: the port's table (with its
    slots) against JAX's _compact_keys, rows in first-read order."""
    rng = np.random.default_rng(K_ + 3)
    B = 4000
    pool = rng.integers(-2**63, 2**63 - 1, (600, 2), dtype=np.int64)
    pool[2, 0] = -1
    pool[3, 0] = 0
    pick = rng.integers(0, 600, B)
    pick[rng.random(B) < 0.55] = 9
    pick[:2] = [3, 2]
    h = pool[pick]
    flags = rng.integers(0, 64, 600).astype(np.int32)[pick]
    ck, slots = tpa.key_histogram_plain(torch.from_numpy(h),
                                  torch.from_numpy(flags), K_,
                                  with_slots=True)
    jck = np.asarray(jpa._ck_flat(jpa._compact_keys(
        jnp.asarray(h), jnp.asarray(flags), 5000)))
    n = int(jck[0, 0])
    assert int(ck[0, 0]) == n == np.unique(h[:, 0]).shape[0]
    jr = jck[1:][jck[1:, 2] > 0]
    jr = jr[np.argsort(jr[:, 3])]
    m = min(n, K_)
    np.testing.assert_array_equal(ck[1 : m + 1].numpy(), jr[:m])
    assert not ck[m + 1 :].numpy().any()
    if K_ > 1:
        assert jr[0, 0] == 0 and jr[1, 0] == -1  # reads 0 and 1
    # each read's slot names its own key's row (capped at K - 1)
    rank = {int(r[0]): i for i, r in enumerate(jr)}
    want = np.minimum([rank[int(x)] for x in h[:, 0]], K_ - 1)
    np.testing.assert_array_equal(slots.numpy(), want)


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("mr,sk,pk", list(itertools.product(
    [0, 50], [False, True], [False, True])))
def test_exemplars_match_jax(env, paired, mr, sk, pk):
    index, jdidx, tdidx, j1, j2, t1, t2 = env
    rng = np.random.default_rng(3)
    idx = np.concatenate([[0, 1499], rng.integers(0, 1500, 200)])
    spec = tpa.KeySpec(k=K, min_range=mr, strand_key=sk,
                       pos_fl=180 if pk else -1)
    got = tpa.gather_exemplars(torch.from_numpy(idx), t1,
                               t2 if paired else None, spec).numpy()
    if paired:
        want = jpipe._gather_pair_exemplars(j1, j2, jnp.asarray(idx), K, mr,
                                            sk, pk)
    else:
        want = jpipe._gather_single_exemplars(j1, jnp.asarray(idx), K, mr, sk,
                                              pk)
    want = np.asarray(want)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
