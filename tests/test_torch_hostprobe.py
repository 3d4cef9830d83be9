"""Host wave 1 of the port against the JAX package's, on the CPU.

The port's host probe (kallisto_tpu_torch/csrc/hostprobe.cpp through
ops/hostprobe.py, built with g++ here) against JAX's HostProbe, and the
plain versions of the wave-2 kernels -- kernel K (the half-fail step),
kernel E with per-read slots and kernel F's slim layout -- against JAX's
pseudoalign_pair_halffail, _compact_read_slots and _gather_pair_slim, on
the same seeded reads (tests/test_anchor.py's simulated reads with
errors, Ns and junk rows).  Integers are held exactly:

- every HostKeys field; JAX's keys come in its map's slot order, the
  port's in first-read order, so JAX's are sorted by first read first;
- all ten SideResult fields of both mates, the key table's occupied rows
  by first read, and each read's slot through the key it names (the
  port's rows are in first-read order, JAX's in ascending h0);
- run_quant with the switch on against the switch off and against JAX
  (counts and EC sets in order; est_counts to the EM's rtol 1e-12, as in
  tests/test_torch_quant.py), and quant_paired's golden bytes with the
  switch on.
"""

import os

import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
import kallisto_tpu.ops.turbo as jturbo
import kallisto_tpu.quant.pipeline as jpipe
from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.native import PackedBatch as JPackedBatch
from kallisto_tpu.ops.hostprobe import HostProbe as JHostProbe
from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.io.fastx import PackedBatch
from kallisto_tpu_torch.ops import hostprobe as thostprobe
from kallisto_tpu_torch.ops import pseudoalign as tpa
from kallisto_tpu_torch.ops import turbo as tturbo
from kallisto_tpu_torch.quant import pipeline as tpipe
from kallisto_tpu_torch.quant.pipeline import run_quant
from test_anchor import _pack, _sim_reads
from test_torch_turbo import assert_sides_equal, occupied

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")
R1 = os.path.join(DATA, "reads_1.fastq.gz")
R2 = os.path.join(DATA, "reads_2.fastq.gz")
K = 31
RLEN, LP = 50, 56


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


def _batches(index, B, seed, err=0.01):
    """(JAX, port) PackedBatch twins of B simulated reads of RLEN bp."""
    codes = _sim_reads(index, B, RLEN, seed=seed, err=err)
    packed, nmask = _pack(codes, LP)
    lens = np.full(B, RLEN, np.int32)
    return (JPackedBatch(packed, nmask, lens, LP),
            PackedBatch(packed, nmask, lens, LP))


TAILS = {
    "none": dict(),
    "strand": dict(strand_key=True),
    "pos": dict(strand_key=True, pos_key=True, pos_fl=180),
    "single": dict(pos_key=True, pos_fl=180),
}


def _assert_host_keys_equal(j, t):
    for f in ("fail_idx", "fail_side", "fail_vsum", "read_h1", "vinfo",
              "read_tl"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    o = np.argsort(j.first_idx, kind="stable")
    for f in ("h128", "occ", "first_idx", "exemplars"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a[o], b, err_msg=f)


@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("B", [2048, 20000])
def test_host_probe_matches_jax(env, tail, B):
    """Every HostKeys field, per-read outputs included, in the three tail
    modes of tests/test_hostprobe.py and single-end with the position
    rank; 20,000 reads run the probe's threads (past 16,384 reads)."""
    index = env[0]
    j1, t1 = _batches(index, B, seed=11)
    j2, t2 = _batches(index, B, seed=12)
    kw = TAILS[tail]
    jp, tp = JHostProbe(index, **kw), thostprobe.HostProbe(index, **kw)
    if tail == "single":
        jk = jp.probe_single(j1, RLEN, perread=True)
        tk = tp.probe_single(t1, RLEN, perread=True)
    else:
        jk = jp.probe_pair(j1, j2, RLEN, perread=True)
        tk = tp.probe_pair(t1, t2, RLEN, perread=True)
        assert (tk.fail_side != 3).sum() > 50 and (tk.fail_side == 3).any()
    assert 0 < tk.fail_idx.shape[0] < B and tk.h128.shape[0] > 0
    _assert_host_keys_equal(jk, tk)
    # without per-read outputs the keys and fails are the same
    nk = (tp.probe_single(t1, RLEN) if tail == "single"
          else tp.probe_pair(t1, t2, RLEN))
    assert nk.read_h1 is None and nk.vinfo is None and nk.read_tl is None
    for f in ("fail_idx", "h128", "occ", "exemplars"):
        np.testing.assert_array_equal(getattr(nk, f), getattr(tk, f))


def _half_inputs(env, seed):
    """A half-fail wave-2 slice as the pipeline builds it: the failed
    mates' codes, the summaries and sidev, padded to Bp with Ns in aux."""
    index = env[0]
    B = 2048
    j1, t1 = _batches(index, B, seed=seed, err=0.02)
    j2, t2 = _batches(index, B, seed=seed + 1, err=0.02)
    hk = thostprobe.HostProbe(index).probe_pair(t1, t2, RLEN)
    half = np.flatnonzero(hk.fail_side != 3)
    sub = hk.fail_idx[half].astype(np.int64)
    side = hk.fail_side[half]
    n = sub.shape[0]
    Bp = tpipe._bucket_size(n, lo=256)
    assert n > 50 and Bp > n
    m1 = (side == 1)[:, None]
    pkf = np.where(m1, t1.packed[sub], t2.packed[sub])
    nmf = np.where(m1, t1.nmask[sub], t2.nmask[sub])
    exc = tpipe._rows_exceptions([(nmf, t1.lens[sub])], Bp, LP)
    assert exc.size > 0
    aux = tturbo.make_aux(n, RLEN, exc)
    np.testing.assert_array_equal(aux, jturbo.make_aux(n, RLEN, exc))
    return (tpipe._pad_rows(pkf, Bp), tpipe._pad_rows(hk.fail_vsum[half], Bp),
            tpipe._pad_rows(side.astype(np.int32), Bp), aux, n)


def _assert_slots_name_same_keys(jck, jslots, tck, tslots, n):
    """Each read's slot names the same key in both tables (JAX's rows are
    in ascending h0, the port's in first-read order)."""
    jk = np.asarray(jck)[1:, :2][np.asarray(jslots)[:n]]
    tk = tck.numpy()[1:, :2][tslots.numpy()[:n]]
    np.testing.assert_array_equal(jk, tk)


OPTS = {
    "plain": dict(),
    "options": dict(min_range=60, strand_key=True, pos_fl=180),
}


@pytest.mark.parametrize("opts", sorted(OPTS))
@pytest.mark.parametrize("max_rows", [16, 32])
def test_halffail_plain_matches_jax(env, opts, max_rows):
    """Plain kernel K + B + E (with slots) against JAX's half-fail step:
    both mates' SideResult fields, the key table and the slots."""
    index, jdidx, tdidx = env
    pkf, vsum, sidev, aux, n = _half_inputs(env, seed=31)
    kw = dict(k=K, L=LP, max_rows=max_rows, max_keys=pkf.shape[0] + 1,
              rl=RLEN, **OPTS[opts])
    if "pos_fl" in kw:
        kw["pos_depth"] = jpa.pf_probe_depth(index)
    j1, j2, jck, jslots = jturbo.pseudoalign_pair_halffail(
        jdidx, pkf, vsum, sidev, aux, with_slots=True, **kw)
    t1, t2, tck, tslots = tturbo.pseudoalign_pair_halffail(
        tdidx, torch.from_numpy(pkf), torch.from_numpy(vsum),
        torch.from_numpy(sidev), torch.from_numpy(aux), with_slots=True,
        **kw)
    assert_sides_equal(j1, t1)
    assert_sides_equal(j2, t2)
    jm, jr = occupied(jck)
    tm, tr = occupied(tck.numpy())
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_array_equal(jr, tr)
    assert tslots.dtype == torch.int32 and tslots.shape == (pkf.shape[0],)
    _assert_slots_name_same_keys(jck, jslots, tck, tslots, pkf.shape[0])
    # both mates' rows have the core's clamped width min(max_rows, W)
    assert t1.rows.shape[1] == t2.rows.shape[1] == min(max_rows, RLEN - K + 1)
    # padding pairs stay no-hit on both mates
    assert not t1.has_hits[n:].any() and not t2.has_hits[n:].any()


def _full_mates(env, seed):
    """Both mates of the same half-fail pairs (for the turbo step)."""
    index = env[0]
    B = 2048
    _, t1 = _batches(index, B, seed=seed, err=0.02)
    _, t2 = _batches(index, B, seed=seed + 1, err=0.02)
    hk = thostprobe.HostProbe(index).probe_pair(t1, t2, RLEN)
    sub = hk.fail_idx[hk.fail_side != 3].astype(np.int64)
    Bp = tpipe._bucket_size(sub.shape[0], lo=256)
    exc = tpipe._rows_exceptions(
        [(b.nmask[sub], b.lens[sub]) for b in (t1, t2)], Bp, LP)
    aux = tturbo.make_aux(sub.shape[0], RLEN, exc)
    return (torch.from_numpy(tpipe._pad_rows(t1.packed[sub], Bp)),
            torch.from_numpy(tpipe._pad_rows(t2.packed[sub], Bp)),
            torch.from_numpy(aux))


def test_halffail_equals_exhaustive_turbo(env):
    """tests/test_hostprobe.py's soundness check through the port: the
    half-fail step (failed mate + summary) gives the rows, hits and first
    hits of the exhaustive both-mate evaluation, f_uid aside (the summary
    does not carry the unitig; no key or resolver reads it)."""
    index, _, tdidx = env
    pkf, vsum, sidev, aux, n = _half_inputs(env, seed=31)
    h1, h2, hck = tturbo.pseudoalign_pair_halffail(
        tdidx, torch.from_numpy(pkf), torch.from_numpy(vsum),
        torch.from_numpy(sidev), torch.from_numpy(aux), k=K, L=LP, rl=RLEN,
        max_keys=pkf.shape[0] + 1)
    p1, p2, aux2 = _full_mates(env, seed=31)
    e1, e2, eck = tturbo.pseudoalign_pair_turbo(
        tdidx, p1, p2, aux2, k=K, L=LP, rl=RLEN, max_keys=pkf.shape[0] + 1)
    for f in tpa.SideResult._fields:
        if f == "f_uid":
            continue
        for a, b in ((h1, e1), (h2, e2)):
            np.testing.assert_array_equal(getattr(a, f)[:n].numpy(),
                                          getattr(b, f)[:n].numpy(),
                                          err_msg=f)
    np.testing.assert_array_equal(occupied(hck.numpy())[1],
                                  occupied(eck.numpy())[1])


@pytest.mark.parametrize("B,K_", [(3000, 3001), (3000, 40)])
def test_key_slots_plain_matches_jax(B, K_):
    """Plain kernel E with slots against _compact_read_slots, through the
    key each slot names; with a table smaller than the distinct keys both
    cap the slot at K - 1 (the key tables then differ: JAX keeps the K
    smallest h0, the port the K first-seen keys), so only the cap holds."""
    rng = np.random.default_rng(5)
    h = rng.integers(-2**63, 2**63 - 1, (B, 2), dtype=np.int64)
    h[rng.integers(0, B, B // 2)] = h[rng.integers(0, B, B // 2)]
    flags = rng.integers(0, 4, B).astype(np.int32)
    jck = jpa._ck_flat(jpa._compact_keys(h, flags, K_))
    jslots = np.asarray(jpa._compact_read_slots(h, K_))
    tck, tslots = tpa.key_histogram_plain(torch.from_numpy(h),
                                          torch.from_numpy(flags), K_,
                                          with_slots=True)
    tck_only = tpa.key_histogram_plain(torch.from_numpy(h),
                                       torch.from_numpy(flags), K_)
    assert torch.equal(tck, tck_only)
    n_uniq = int(tck[0, 0])
    assert n_uniq == int(np.asarray(jck)[0, 0])
    if n_uniq <= K_:
        _assert_slots_name_same_keys(jck, jslots, tck, tslots, B)
        # the slot names the read's own key
        np.testing.assert_array_equal(tck.numpy()[1:, :2][tslots.numpy()], h)
    else:
        assert int(tslots.max()) == int(jslots.max()) == K_ - 1


def test_slim_gather_plain_matches_jax(env):
    """Plain kernel F's slim layout against _gather_pair_slim on a
    half-fail slice's sides (padding rows included)."""
    _, jdidx, tdidx = env
    pkf, vsum, sidev, aux, n = _half_inputs(env, seed=41)
    kw = dict(k=K, L=LP, max_rows=32, max_keys=pkf.shape[0] + 1, rl=RLEN)
    j1, j2, _ = jturbo.pseudoalign_pair_halffail(jdidx, pkf, vsum, sidev,
                                                 aux, **kw)
    t1, t2, _ = tturbo.pseudoalign_pair_halffail(
        tdidx, torch.from_numpy(pkf), torch.from_numpy(vsum),
        torch.from_numpy(sidev), torch.from_numpy(aux), **kw)
    idx = np.random.default_rng(3).integers(0, pkf.shape[0], 600)
    want = np.asarray(jpipe._gather_pair_slim(j1, j2, idx))
    got = tpa.gather_slim(torch.from_numpy(idx), t1, t2).numpy()
    assert got.dtype == np.int32 and got.shape == (600, 5)
    np.testing.assert_array_equal(want, got)


MODES = {
    "paired_pos": dict(files=[R1, R2], fld_mean=180.0, fld_sd=20.0),
    "single_strand": dict(files=[R1], single_end=True, fld_mean=180.0,
                          fld_sd=20.0, single_overhang=True, strand="fr"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quant_switch_on_matches_off_and_jax(env, monkeypatch, mode):
    """tests/test_hostprobe.py's end-to-end modes through the port: the
    switch on (hw1 / hw1s routes) gives the switch off's counts, EC sets
    and est_counts, and JAX's with its host probe on."""
    index = env[0]
    kw = dict(plaintext=True, **MODES[mode])
    res = {}
    for hw in ("0", "1"):
        monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", hw)
        res[hw] = run_quant(Options(**kw), index=index, device="cpu")
    route = "hw1s" if mode.startswith("single") else "hw1"
    assert res["1"].timings[route] > 0 and res["1"].timings["turbo"] == 0
    assert res["0"].timings[route] == 0 and res["0"].timings["turbo"] > 0
    assert res["1"].timings["probe_s"] > 0 == res["0"].timings["probe_s"]
    a, b = res["0"], res["1"]
    np.testing.assert_array_equal(a.counts, b.counts)
    assert [s.tolist() for s in a.ec_sets] == [s.tolist() for s in b.ec_sets]
    np.testing.assert_array_equal(a.est_counts, b.est_counts)
    j = jrun_quant(JOptions(**kw), index=index)
    np.testing.assert_array_equal(j.counts, b.counts)
    assert [s.tolist() for s in j.ec_sets] == [s.tolist() for s in b.ec_sets]
    np.testing.assert_allclose(b.est_counts, j.est_counts, rtol=1e-12)


def test_quant_paired_golden_with_switch_on(env, tmp_path, monkeypatch):
    """quant_paired with the switch on: every batch learns the FLD on the
    hw1pb route (the bundled 10,000 pairs never reach the goal), and
    abundance.tsv is byte-equal to the golden; the FLD equals the switch
    off's."""
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "1")
    out = str(tmp_path / "on")
    res = run_quant(Options(files=[R1, R2], output_dir=out, plaintext=True),
                    index=env[0], device="cpu")
    assert res.timings["hw1pb"] > 0 and res.timings["full"] == 0
    with open(os.path.join(out, "abundance.tsv"), "rb") as f:
        got = f.read()
    with open(os.path.join(GOLDEN, "quant_paired", "abundance.tsv"),
              "rb") as f:
        assert got == f.read()
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    off = run_quant(Options(files=[R1, R2]), index=env[0], device="cpu")
    np.testing.assert_array_equal(res.fld, off.fld)


def test_fld_goal_switch_on_matches_off(env, monkeypatch):
    """A paired run that reaches a small FLD goal: batches learn the FLD
    on hw1pb (pipelined) and then go hw1; the FLD, counts and EC sets equal
    the switch off's (per read, then the anchor route) and JAX's."""
    monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", "1000")
    kw = dict(files=[R1, R2], batch_size=1024)
    res = {}
    for hw in ("0", "1"):
        monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", hw)
        res[hw] = run_quant(Options(**kw), index=env[0], device="cpu")
    t = res["1"].timings
    assert t["hw1pb"] > 0 and t["hw1"] > 0 and t["full"] == 0, t
    np.testing.assert_array_equal(res["0"].fld, res["1"].fld)
    np.testing.assert_array_equal(res["0"].counts, res["1"].counts)
    assert [s.tolist() for s in res["0"].ec_sets] == \
        [s.tolist() for s in res["1"].ec_sets]
    monkeypatch.setattr(jpipe, "_W2_HINTS", {})
    j = jrun_quant(JOptions(**kw), index=env[0])
    np.testing.assert_array_equal(j.fld, res["1"].fld)
    np.testing.assert_array_equal(j.counts, res["1"].counts)


def test_probe_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: with the switch on, a host probe that cannot be built
    raises instead of dropping to the card's routes."""
    monkeypatch.setattr(thostprobe, "_lib", None)
    monkeypatch.setattr(thostprobe, "_SRC", str(tmp_path / "missing.cpp"))
    with pytest.raises((OSError, RuntimeError)):
        thostprobe.load()
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "1")
    index = build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=K)
    with pytest.raises((OSError, RuntimeError)):
        run_quant(Options(files=[R1, R2]), index=index, device="cpu")


def test_switch_default_follows_the_card(env, monkeypatch):
    """KALLISTO_TPU_HOST_WAVE1 unset is off (the card's measurement decided
    the default, PERF.md section 5): no probe, the card's own routes; "1"
    turns host wave 1 on, "0" off."""
    monkeypatch.delenv("KALLISTO_TPU_HOST_WAVE1", raising=False)
    assert not tpipe.host_wave1_enabled()
    kw = dict(files=[R1], single_end=True, fld_mean=180.0, fld_sd=20.0)
    res = run_quant(Options(**kw), index=env[0], device="cpu")
    assert res.timings["hw1s"] == 0 and res.timings["probe_s"] == 0
    assert res.timings["turbo"] > 0
    for value, on in (("1", True), ("0", False), ("yes", True)):
        monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", value)
        assert tpipe.host_wave1_enabled() is on
