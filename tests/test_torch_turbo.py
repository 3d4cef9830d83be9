"""The port's turbo and compact-packed steady-state steps against the JAX
package's, on the CPU (the port's plain PyTorch versions of kernels D, B
and E).

Same seeded inputs go through kallisto_tpu.ops.turbo /
kallisto_tpu.ops.pseudoalign and kallisto_tpu_torch.ops.turbo /
kallisto_tpu_torch.ops.pseudoalign: reads from the bundled transcriptome
with injected Ns, padded batches (Bp > n) and a uniform length shorter
than the padded one.  Held exactly: all ten SideResult fields of both
mates (the JAX index in its bucketed layout, where even f_strand of
hitless reads is defined the same way), the key table's meta row, and
its occupied rows ordered by first_idx (JAX orders them by h0, the port
by first read; the host sorts by first_idx either way).
"""

import os

import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
import kallisto_tpu.ops.turbo as jturbo
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.io.fastx import ReadBatch, _read_batch_to_packed
from kallisto_tpu_torch.ops import pseudoalign as tpa
from kallisto_tpu_torch.ops import turbo as tturbo
from kallisto_tpu_torch.quant.pipeline import (
    _bucket_size,
    _pad_rows,
    _turbo_exceptions,
    _uniform_len,
)

# The test workers share the machine's cores: one intra-op thread per
# worker keeps torch's thread pools from oversubscribing them.
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
    return index, jdidx, tdidx


def reads(index, n, L, seed, varlen=False, n_frac=0.01):
    """Reads sampled from the index's unitig sequence (both strands), 1%
    substitutions, n_frac Ns, optional ragged lengths in [k, L]."""
    rng = np.random.default_rng(seed)
    seq = index.unitig_seq
    starts = rng.integers(0, max(seq.shape[0] - L, 1), n)
    codes = seq[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    err = rng.random((n, L)) < 0.01
    codes[err] = (codes[err] + 1) % 4
    codes[rng.random((n, L)) < n_frac] = 4
    lens = np.full(n, L, np.int32)
    if varlen:
        lens = rng.integers(K, L + 1, n).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    return _read_batch_to_packed(ReadBatch(codes=codes, lens=lens), K)


def assert_sides_equal(j, t):
    for f in jpa.SideResult._fields:
        a = np.asarray(getattr(j, f))
        b = getattr(t, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def occupied(ck):
    """(meta row, occupied rows sorted by first_idx) of a flat key table."""
    ck = np.asarray(ck)
    rows = ck[1:][ck[1:, 2] > 0]
    return ck[0], rows[np.argsort(rows[:, 3], kind="stable")]


def assert_tables_equal(jck, tck):
    jm, jr = occupied(jck)
    tm, tr = occupied(tck.numpy())
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_array_equal(jr, tr)
    assert jm[0] == jr.shape[0]


def turbo_inputs(index, n, L, seed, varlen, single, extra_exc=False):
    b1 = reads(index, n, L, seed, varlen)
    b2 = None if single else reads(index, n, L, seed + 100, varlen)
    sides = (b1,) if single else (b1, b2)
    Bp = _bucket_size(n, lo=256)
    assert Bp > n
    exc = _turbo_exceptions(sides, Bp)
    assert exc is not None and exc.size > 0
    rl = _uniform_len(*sides)
    if extra_exc:
        # an exception in a padding column of read 3 (column >= rl): the
        # trim must drop it on both sides
        exc = np.sort(np.append(exc, 3 * b1.Lp + b1.Lp - 2))
    aux = tturbo.make_aux(n, rl or 0, exc)
    np.testing.assert_array_equal(aux, jturbo.make_aux(n, rl or 0, np.sort(exc)))
    packed = [_pad_rows(b.packed, Bp) for b in sides]
    lens = None
    if varlen:
        lens = np.concatenate(
            [_pad_rows(b.lens.astype(np.uint16), Bp) for b in sides])
    return sides, Bp, rl, aux, packed, lens


OPTS = {
    "plain": dict(),
    "options": dict(min_range=50, strand_key=True, pos_fl=180),
}


@pytest.mark.parametrize("opts", sorted(OPTS))
@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("single", [False, True])
def test_turbo_matches_jax(env, opts, varlen, single):
    index, jdidx, tdidx = env
    kw = dict(k=K, max_keys=4096, **OPTS[opts])
    if "pos_fl" in kw:
        kw["pos_depth"] = jpa.pf_probe_depth(index)
    sides, Bp, rl, aux, packed, lens = turbo_inputs(
        index, 700, 50, 7, varlen, single, extra_exc=not varlen)
    L = sides[0].Lp
    if not varlen:
        assert 0 < rl < L  # the trim is exercised
    tp = [torch.from_numpy(p) for p in packed]
    ta = torch.from_numpy(aux)
    tl = None if lens is None else torch.from_numpy(lens)
    if single:
        if varlen:
            j1, jck = jturbo.pseudoalign_single_turbo_varlen(
                jdidx, packed[0], aux, lens, L=L, **kw)
            t1, tck = tturbo.pseudoalign_single_turbo_varlen(
                tdidx, tp[0], ta, tl, L=L, **kw)
        else:
            j1, jck = jturbo.pseudoalign_single_turbo(
                jdidx, packed[0], aux, L=L, rl=rl, **kw)
            t1, tck = tturbo.pseudoalign_single_turbo(
                tdidx, tp[0], ta, L=L, rl=rl, **kw)
        assert_sides_equal(j1, t1)
    else:
        if varlen:
            j1, j2, jck = jturbo.pseudoalign_pair_turbo_varlen(
                jdidx, packed[0], packed[1], aux, lens, L=L, **kw)
            t1, t2, tck = tturbo.pseudoalign_pair_turbo_varlen(
                tdidx, tp[0], tp[1], ta, tl, L=L, **kw)
        else:
            j1, j2, jck = jturbo.pseudoalign_pair_turbo(
                jdidx, packed[0], packed[1], aux, L=L, rl=rl, **kw)
            t1, t2, tck = tturbo.pseudoalign_pair_turbo(
                tdidx, tp[0], tp[1], ta, L=L, rl=rl, **kw)
        assert_sides_equal(j1, t1)
        assert_sides_equal(j2, t2)
    assert t1.rows.shape[0] == Bp
    assert bool(t1.has_hits.any())
    assert_tables_equal(jck, tck)


@pytest.mark.parametrize("single", [False, True])
def test_compact_packed_matches_jax(env, single):
    """K17: the bitmask route (kernels A, B, E) on a batch with Ns."""
    index, jdidx, tdidx = env
    b1 = reads(index, 600, 76, 21, varlen=True, n_frac=0.02)
    kw = dict(k=K, L=b1.Lp, max_keys=601, min_range=50, strand_key=True,
              pos_fl=180, pos_depth=jpa.pf_probe_depth(index))
    t_in1 = [torch.from_numpy(a) for a in (b1.packed, b1.nmask, b1.lens)]
    if single:
        j1, jck = jpa.pseudoalign_single_compact_packed(
            jdidx, b1.packed, b1.nmask, b1.lens, **kw)
        t1, tck = tpa.pseudoalign_single_compact_packed(tdidx, *t_in1, **kw)
        assert_sides_equal(j1, t1)
    else:
        b2 = reads(index, 600, 76, 22, varlen=True, n_frac=0.02)
        t_in2 = [torch.from_numpy(a) for a in (b2.packed, b2.nmask, b2.lens)]
        j1, j2, jck = jpa.pseudoalign_pair_compact_packed(
            jdidx, b1.packed, b1.nmask, b1.lens, b2.packed, b2.nmask,
            b2.lens, **kw)
        t1, t2, tck = tpa.pseudoalign_pair_compact_packed(
            tdidx, *t_in1, *t_in2, **kw)
        assert_sides_equal(j1, t1)
        assert_sides_equal(j2, t2)
    assert_tables_equal(jck, tck)


def test_small_key_table_counts_past_k(env):
    """max_keys=64: the table overflows and both report the same exact
    n_uniq > K (the host then redoes the batch per read)."""
    index, jdidx, tdidx = env
    sides, Bp, rl, aux, packed, _ = turbo_inputs(index, 700, 50, 9, False,
                                                 False)
    L = sides[0].Lp
    _, _, jck = jturbo.pseudoalign_pair_turbo(
        jdidx, packed[0], packed[1], aux, k=K, L=L, rl=rl, max_keys=64)
    _, _, tck = tturbo.pseudoalign_pair_turbo(
        tdidx, torch.from_numpy(packed[0]), torch.from_numpy(packed[1]),
        torch.from_numpy(aux), k=K, L=L, rl=rl, max_keys=64)
    n_j = tpa.unflatten_ck_host(np.asarray(jck))[4]
    n_t = tpa.unflatten_ck_host(tck.numpy())[4]
    assert n_j == n_t > 64
    assert tck.shape == (65, 5)
    assert (tck[1:, 2] > 0).all()


def test_turbo_overflow_flag(env):
    """max_rows=1 forces multi-row reads to overflow; the flag reaches the
    table's flags & 12, as in JAX."""
    index, jdidx, tdidx = env
    sides, Bp, rl, aux, packed, _ = turbo_inputs(index, 300, 56, 3, False,
                                                 True)
    L = sides[0].Lp
    j1, jck = jturbo.pseudoalign_single_turbo(
        jdidx, packed[0], aux, k=K, L=L, rl=rl, max_rows=1)
    t1, tck = tturbo.pseudoalign_single_turbo(
        tdidx, torch.from_numpy(packed[0]), torch.from_numpy(aux), k=K, L=L,
        rl=rl, max_rows=1)
    assert_sides_equal(j1, t1)
    assert bool(t1.overflow.any())
    _, occ, _, flags, _ = tpa.unflatten_ck_host(tck.numpy())
    assert (flags[occ > 0] & 12).any()
    assert_tables_equal(jck, tck)
