"""The port's two-wave anchor step against the JAX package's, on the CPU
(the plain PyTorch version of kernel I, then kernels B and E's).

The reads are tests/test_anchor.py's simulated ones (errors, Ns, junk
reads), the JAX index in its bucketed layout, as in test_torch_turbo.py.
Held exactly, with JAX's wave2_denom=1 so that every failing read is in
its wave-2 sub-batch (the port has no wave-2 capacity: every failing read
is evaluated): all ten SideResult fields of both mates, the key table's
meta row (n_uniq and n_fail) and its occupied rows ordered by first_idx.
Past JAX's capacity, JAX marks the table overflowed where the port's
stays whole (ops/anchor.py).
"""

import os

import numpy as np
import pytest
import torch

import kallisto_tpu.ops.anchor as janchor
import kallisto_tpu.ops.pseudoalign as jpa
from kallisto_tpu.ops.turbo import make_aux
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.ops import anchor as tanchor
from kallisto_tpu_torch.ops import pseudoalign as tpa
from test_anchor import _exc_from_codes, _pack, _sim_reads
from test_torch_turbo import assert_sides_equal, assert_tables_equal

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


def batch(index, n_sides, B, rlen, Lp, seed):
    """Packed sides, aux and their torch twins for reads of length rlen
    padded to Lp (only in-read Ns are exceptions)."""
    packed, excs = [], []
    for s in range(n_sides):
        c = _sim_reads(index, B, rlen, seed=seed + s)
        packed.append(_pack(c, Lp)[0])
        full = np.pad(c, ((0, 0), (0, Lp - rlen)), constant_values=4)[:, :Lp]
        excs.append(_exc_from_codes(full, B, s, Lp))
    exc = np.concatenate(excs)
    aux = make_aux(B, rlen, exc[(exc % Lp) < rlen])
    return packed, aux, [torch.from_numpy(p) for p in packed], \
        torch.from_numpy(aux)


OPTS = {
    "plain": dict(),
    "options": dict(min_range=50, strand_key=True, pos_fl=180),
}


@pytest.mark.parametrize("opts", sorted(OPTS))
@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("rlen", [50, 62])
def test_pair_anchor_matches_jax(env, rlen, trim, opts):
    index, jdidx, tdidx = env
    B, Lp = 1024, ((rlen + 7) // 8) * 8
    packed, aux, tp, ta = batch(index, 2, B, rlen, Lp, 1)
    kw = dict(k=K, L=Lp, n_anchors=tanchor.n_anchors_for(Lp, K),
              rl=rlen if trim else 0, **OPTS[opts])
    if "pos_fl" in kw:
        kw["pos_depth"] = jpa.pf_probe_depth(index)
    j1, j2, jck = janchor.pseudoalign_pair_anchor(jdidx, *packed, aux,
                                                  wave2_denom=1, **kw)
    t1, t2, tck = tanchor.pseudoalign_pair_anchor(tdidx, *tp, ta, **kw)
    assert_sides_equal(j1, t1)
    assert_sides_equal(j2, t2)
    assert_tables_equal(jck, tck)
    n_fail = tpa.ck_n_fail(tck.numpy())
    assert n_fail == jpa.ck_n_fail(np.asarray(jck))
    # both waves ran: verified reads and wave-2 reads
    assert 0 < n_fail < 2 * B
    assert int(t1.has_hits.sum()) > 0


def test_single_anchor_matches_jax(env):
    index, jdidx, tdidx = env
    B, rlen, Lp = 2048, 50, 56
    packed, aux, tp, ta = batch(index, 1, B, rlen, Lp, 3)
    kw = dict(k=K, L=Lp, n_anchors=tanchor.n_anchors_for(Lp, K))
    j1, jck = janchor.pseudoalign_single_anchor(jdidx, packed[0], aux,
                                                wave2_denom=1, **kw)
    t1, tck = tanchor.pseudoalign_single_anchor(tdidx, tp[0], ta, **kw)
    assert_sides_equal(j1, t1)
    assert_tables_equal(jck, tck)
    assert tpa.ck_n_fail(tck.numpy()) == jpa.ck_n_fail(np.asarray(jck)) > 0


def test_padded_batch_matches_jax(env):
    """Bp > n_real: padding reads are neither verified nor in wave 2 and
    keep anchor 0's strand, as in JAX; n_fail counts real reads only."""
    index, jdidx, tdidx = env
    B, rlen, Lp = 600, 50, 56
    packed, aux, _, _ = batch(index, 2, B, rlen, Lp, 5)
    Bp = 1024
    packed = [np.concatenate([p, np.zeros((Bp - B, p.shape[1]), p.dtype)])
              for p in packed]
    r, c = np.divmod(aux[4:][aux[4:] < 2**62], Lp)
    aux = make_aux(B, rlen, np.where(r >= B, r - B + Bp, r) * Lp + c)
    kw = dict(k=K, L=Lp, n_anchors=2, rl=rlen)
    j1, j2, jck = janchor.pseudoalign_pair_anchor(jdidx, *packed, aux,
                                                  wave2_denom=1, **kw)
    t1, t2, tck = tanchor.pseudoalign_pair_anchor(
        tdidx, *[torch.from_numpy(p) for p in packed], torch.from_numpy(aux),
        **kw)
    assert_sides_equal(j1, t1)
    assert_sides_equal(j2, t2)
    assert_tables_equal(jck, tck)
    assert not t1.has_hits[B:].any()


def test_wave2_overflow_marks_the_table(env):
    """tests/test_anchor.py's overflow case: all-junk reads, wave2_denom=4,
    max_keys=1024.  JAX marks its table (n_uniq = max_keys + 1); the port,
    with no wave-2 capacity, gives the same n_fail and the whole table,
    equal to JAX's with every failing read in wave 2 (wave2_denom=1)."""
    _, jdidx, tdidx = env
    B, rlen, Lp = 256, 50, 56
    rng = np.random.default_rng(9)
    c1 = rng.integers(0, 4, (B, rlen)).astype(np.uint8)
    p1, _ = _pack(c1, Lp)
    aux = make_aux(B, rlen, np.empty(0, np.int64))
    kw = dict(k=K, L=Lp, n_anchors=2, max_keys=1024)
    j1, jck = janchor.pseudoalign_single_anchor(jdidx, p1, aux,
                                                wave2_denom=4, **kw)
    t1, tck = tanchor.pseudoalign_single_anchor(
        tdidx, torch.from_numpy(p1), torch.from_numpy(aux), **kw)
    jm, tm = np.asarray(jck)[0], tck.numpy()[0]
    assert jm[0] == 1025 and tm[0] <= B
    assert tm[1] == jm[1] > B // 4
    f1, fck = janchor.pseudoalign_single_anchor(jdidx, p1, aux,
                                                wave2_denom=1, **kw)
    assert_sides_equal(f1, t1)
    assert_tables_equal(fck, tck)


@pytest.mark.parametrize("rlen", [31, 40, 45, 46])
def test_short_reads_row_width(env, rlen):
    """Reads shorter than k + 15: the wave-2 core has min(16, rlen - k + 1)
    row slots against the verified reads' 16.  JAX broadcasts a one-slot
    core row over the 16 slots (rlen = k) and raises ValueError for 2-15
    slots; the port does the same."""
    index, jdidx, tdidx = env
    B, Lp = 256, ((rlen + 7) // 8) * 8
    packed, aux, tp, ta = batch(index, 1, B, rlen, Lp, 7)
    kw = dict(k=K, L=Lp, n_anchors=tanchor.n_anchors_for(rlen, K), rl=rlen)
    fits = tanchor.row_width_ok(rlen, K)
    assert fits == (rlen in (31, 46))
    if not fits:
        with pytest.raises(ValueError):
            janchor.pseudoalign_single_anchor(jdidx, packed[0], aux,
                                              wave2_denom=1, **kw)
        with pytest.raises(ValueError):
            tanchor.pseudoalign_single_anchor(tdidx, tp[0], ta, **kw)
        return
    j1, jck = janchor.pseudoalign_single_anchor(jdidx, packed[0], aux,
                                                wave2_denom=1, **kw)
    t1, tck = tanchor.pseudoalign_single_anchor(tdidx, tp[0], ta, **kw)
    assert_sides_equal(j1, t1)
    assert_tables_equal(jck, tck)
    assert t1.rows.shape == (B, 16)


def test_block_ec8_matches_jax(env):
    _, jdidx, tdidx = env
    np.testing.assert_array_equal(np.asarray(jdidx.block_ec8),
                                  tdidx.block_ec8.numpy())
    assert tdidx.block_ec8.dtype == torch.int32


@pytest.mark.parametrize("rlen,g", [(50, 2), (100, 4), (150, 8), (250, 16),
                                    (500, 32), (1000, 32)])
def test_wave1_group_width(rlen, g):
    """Kernel I's wave 1 gives each read the smallest power of two of lanes
    that holds its anchors (2x100 bp: 4 anchors, 8 reads a warp); past 32
    anchors (1,000 bp: 33) the read keeps a whole warp and loops."""
    from kallisto_tpu_torch.ops import kernels

    na = tanchor.n_anchors_for(rlen, 31)
    assert kernels.anchor_group_width(na) == g
    assert g >= min(na, 32) and g // 2 < min(na, 32) or g == 2
