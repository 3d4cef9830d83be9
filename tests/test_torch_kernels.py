"""The port's CUDA kernels against their plain PyTorch versions.

Each test runs a kernel on the card and the plain version on the CPU on
the same seeded inputs (the bundled transcriptome's index and reads, plus
random reads with Ns, ragged lengths and reads shorter than k) and
requires equality, for kernels A (both waves, its wave-2 count equal to
the plain two-wave composition's), A on unpacked codes, D, I (both
waves), J and K and for kernel L (the k-mer probe alone) in both device
index layouts (padded and bucketed): every SideResult field and every
key bit for kernels A, B, D and I, every read's key and flags, every
table entry and every slot for kernel E (compact_keys: the compact key
fused into the table, on SideResults in both layouts, on a hot key, on B
= 0, 1 and 777, and on given keys with h0 = 0 and h0 = -1), every
exemplar row for kernel F, every hexamer id for kernel H, bitwise alpha and equal rounds for
kernel G (the main EM and the bootstraps), every LongResult field for
kernel J, both mates' SideResult fields, the key table and the per-read
slots for kernel K (after the port's host probe) and every slim row of kernel F (also on no key, one key, counts that fill
no block, reads outside the batch and row widths 16, 15 and 10); sharded runs (four shards, and kernel A
and a sharded quant on a second card, which needs two) equal one
device.  They need a CUDA
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


@pytest.fixture(params=["padded", "bucketed"])
def layout(request, monkeypatch):
    """The device index layout of the test: the bundled index takes the
    padded one; a budget of 0 forces the bucketed one."""
    if request.param == "bucketed":
        monkeypatch.setattr(pa, "_PADDED_BYTES_BUDGET", 0)
    return (pa.PaddedDeviceIndex if request.param == "padded"
            else pa.DeviceIndex)


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
def test_kernel_a_matches_plain(cuda, port_index, layout, which):
    pb = _batches(port_index)[which]
    before = kernels.LAUNCHES["pseudoalign_side"]
    dg = pa.device_index_from_host(port_index, cuda)
    assert isinstance(dg, layout)
    g = _sides(dg, pb, cuda)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pseudoalign_side"] == before + 1
    c = _sides(pa.device_index_from_host(port_index, "cpu"), pb, "cpu")
    for f in pa.SideResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.cuda
def test_kernel_l_matches_plain(cuda, port_index, layout):
    """Kernel L (the probe alone, four queries a lane): slot, hit and EC
    row equal to the plain lookup_kmers on index k-mers, random k-mers and
    invalid windows (window 0 of an empty read: canon 0, q = mix64(0)), as
    a 2-D batch; on n = 1, 2, 3, 5 and 40,001 queries (not a multiple of
    four); on views 8 bytes past a 16-byte boundary (element loads); n = 0
    launches nothing.  The bucketed index is probed through its packed
    (key, EC row) entries, which equal packed_entries_plain."""
    rng = np.random.default_rng(9)
    keys = port_index.kmer_keys.astype(np.int64)
    canon = np.concatenate([
        keys[rng.integers(0, keys.shape[0], 20000)],
        rng.integers(0, 2**62, 20000, dtype=np.int64), np.zeros(8, np.int64)])
    valid = rng.random(canon.shape[0]) < 0.9
    valid[-8:] = False
    c, v = torch.from_numpy(canon), torch.from_numpy(valid)
    dg = pa.device_index_from_host(port_index, cuda)
    assert isinstance(dg, layout)
    dc = pa.device_index_from_host(port_index, "cpu")
    before = kernels.LAUNCHES["lookup_kmers"]
    g = kernels.lookup_kmers(dg, c.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lookup_kmers"] == before + 1
    want = pa.lookup_kmers(dc, c, v)
    assert int(want[1].sum()) > 10000
    for a, b in zip(g, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    cases = [(c[:n], v[:n]) for n in (1, 2, 3, 5, 40001)]
    cases.append((c[:40000].view(200, 200), v[:40000].view(200, 200)))
    gc, gv = c.to(cuda), v.to(cuda)
    cases.append((gc[1:40002], gv[1:40002]))   # 8 and 1 bytes off
    for cc, vv in cases:
        g = kernels.lookup_kmers(dg, cc.to(cuda), vv.to(cuda))
        want = pa.lookup_kmers(dc, cc.cpu(), vv.cpu())
        torch.cuda.synchronize()
        for a, b in zip(g, want):
            assert a.shape == b.shape and torch.equal(a.cpu(), b)
    n0 = kernels.LAUNCHES["lookup_kmers"]
    out = kernels.lookup_kmers(dg, gc[:0], gv[:0])
    assert all(t.numel() == 0 for t in out)
    assert kernels.LAUNCHES["lookup_kmers"] == n0
    if layout is pa.DeviceIndex:
        ent = kernels.packed_entries(dg)
        assert ent is kernels.packed_entries(dg)
        assert torch.equal(ent.cpu(), pa.packed_entries_plain(dc))


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
    hg, tg, xg = pa.read_keys(g1, g2, K)
    torch.cuda.synchronize()
    hc, tc, xc = pa.read_keys(c1, c2, K)
    assert xg is None and xc is None
    assert torch.equal(hg.cpu(), hc)
    if paired:
        assert torch.equal(tg.cpu(), tc)
    else:
        assert tg is None and tc is None


def _with_rows(s, rows):
    return s._replace(rows=rows)


def _offset_rows(rows, words):
    """A contiguous copy of rows whose first word lies `words` int32 into
    its allocation (so 16-byte loads are not allowed at words = 1 or 2)."""
    B, R = rows.shape
    buf = torch.zeros(B * R + words, dtype=rows.dtype, device=rows.device)
    out = buf[words:].view(B, R)
    out.copy_(rows)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["r16", "r15", "r10", "off4", "off8"])
def test_kernel_b_row_layouts_match_plain(cuda, port_index, rows):
    """Kernel B's per-read form on R = 16 (16-byte loads), R = 15 and 10
    (not a multiple of 4), and on R = 16 row views 4 and 8 bytes past a
    16-byte boundary: keys and fragment lengths equal to the plain
    version; B = 1 too, and B = 0 launches nothing."""
    bs = _batches(port_index)
    dg = pa.device_index_from_host(port_index, cuda)
    g1, g2 = _sides(dg, bs["bundled_1"], cuda), _sides(dg, bs["bundled_2"], cuda)
    if rows in ("r15", "r10"):
        R = int(rows[1:])
        g1 = _with_rows(g1, g1.rows[:, :R].contiguous())
        g2 = _with_rows(g2, g2.rows[:, :R].contiguous())
    elif rows.startswith("off"):
        w = int(rows[3:]) // 4
        g1 = _with_rows(g1, _offset_rows(g1.rows, w))
        g2 = _with_rows(g2, _offset_rows(g2.rows, w))
        assert g1.rows.data_ptr() % 16 == 4 * w
    for b1, b2 in ((g1, g2), (g1, None)):
        h, tl, hx = kernels.read_keys(b1, b2, K)
        hp, tlp = pa.read_keys_plain(b1, b2, K)
        torch.cuda.synchronize()
        assert torch.equal(h, hp) and hx is None
        assert (tl is None and tlp is None) or torch.equal(tl, tlp)
        one = pa.SideResult(*(t[:1] for t in b1))
        assert torch.equal(kernels.read_keys(one, None, K)[0],
                           pa.read_keys_plain(one, None, K)[0])
    before = kernels.LAUNCHES["read_keys"]
    bt = pa.bias_tables_from_host(port_index, cuda)
    h0, tl0, hx0 = kernels.read_keys(pa.SideResult(*(t[:0] for t in g1)),
                                     pa.SideResult(*(t[:0] for t in g2)), K,
                                     bias=bt)
    assert h0.shape == (0, 2) and tl0.shape == (0,) and hx0.shape == (0,)
    assert kernels.LAUNCHES["read_keys"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("use_priors", [False, True])
def test_kernel_c_em_bitwise(cuda, use_priors):
    """The main EM (kernel G with one replicate) on the card is bitwise
    the plain version's on the CPU."""
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
    # kernel E refuses what B's checks refuse, and counts one launch
    spec = pa.KeySpec(k=K)
    sc = pa.SideResult(*(t.cpu() for t in s))
    bad = {"cpu": sc, "dtype": s._replace(rng=s.rng.long()),
           "shape": s._replace(has_hits=s.has_hits[:-1]),
           "contiguity": s._replace(rows=s.rows.t().contiguous().t())}
    for name, b in bad.items():
        with pytest.raises((ValueError, TypeError)):
            kernels.compact_keys(s, b, spec, 100)
    with pytest.raises(ValueError):
        kernels.read_keys(sc, None, K)
    # kernel H's tables must lie on the card, with int32 block tables
    bt = pa.bias_tables_from_host(port_index, cuda)
    for b in (pa.bias_tables_from_host(port_index, "cpu"),
              bt._replace(block_end=bt.block_end.long())):
        with pytest.raises((ValueError, TypeError)):
            kernels.read_keys(s, None, K, bias=b)
    with pytest.raises(ValueError):
        kernels.compact_keys(sc, None, spec, 100)
    kernels.compact_keys(s, s, spec, 100)
    assert kernels.LAUNCHES["key_histogram"] == 1
    assert kernels.LAUNCHES["read_keys"] == 1


def _turbo_case(index, single, varlen, dev):
    """One turbo batch (Bp > n, Ns through the aux vector, uniform length
    50 < Lp = 56 or ragged lengths) as tensors on `dev`."""
    from kallisto_tpu_torch.ops import turbo
    from kallisto_tpu_torch.quant.pipeline import (
        _bucket_size, _pad_rows, _turbo_exceptions, _uniform_len)

    L = 50
    bs = [_random_batch(index, 3000, L, s) for s in ((11,) if single else (11, 12))]
    if not varlen:
        for b in bs:  # the ragged reads of _random_batch get full length
            b.lens[:] = L
    Bp = _bucket_size(3000, lo=256)
    exc = _turbo_exceptions(bs, Bp)
    rl = _uniform_len(*bs)
    aux = turbo.make_aux(3000, rl or 0, exc)
    packed = [torch.from_numpy(_pad_rows(b.packed, Bp)).to(dev) for b in bs]
    lens = None
    if varlen:
        lens = torch.from_numpy(np.concatenate(
            [_pad_rows(b.lens.astype(np.uint16), Bp) for b in bs])).to(dev)
    return packed, torch.from_numpy(aux).to(dev), lens, bs[0].Lp, rl or 0


@pytest.mark.cuda
@pytest.mark.parametrize("single,varlen", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_kernel_d_matches_plain(cuda, port_index, layout, single, varlen):
    from kallisto_tpu_torch.ops import turbo

    dg = pa.device_index_from_host(port_index, cuda)
    dc = pa.device_index_from_host(port_index, "cpu")
    assert isinstance(dg, layout) and isinstance(dc, layout)
    out = {}
    for dev, d in ((cuda, dg), ("cpu", dc)):
        packed, aux, lens, L, rl = _turbo_case(port_index, single, varlen, dev)
        out[str(dev)] = turbo.turbo_sides(d, packed, aux, lens, K, L, 16, rl)
    g, c = out[str(cuda)], out["cpu"]
    assert bool(c.has_hits.any())
    for f in pa.SideResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [True, False])
def test_kernel_b_compact_layout_matches_plain(cuda, port_index, paired):
    """The compact key (min_range 50, strand tail, position rank) that
    kernel E computes in its first pass: every read's h and flags equal to
    the plain key of the CPU's SideResults."""
    depth = pa.pf_probe_depth(port_index)
    spec = pa.KeySpec(k=K, min_range=50, strand_key=True, pos_fl=180,
                      pos_depth=depth)
    res = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev, with_pos_tables=True)
        bs = _batches(port_index)
        s1 = _sides(d, bs["rand100"], dev)
        s2 = _sides(d, _random_batch(port_index, 5000, 100, 9), dev) \
            if paired else None
        if dev == cuda:
            _, _, h, fl = kernels.compact_keys(s1, s2, spec, 5001, didx=d,
                                               want_keys=True)
            res[str(dev)] = (h, fl)
        else:
            res[str(dev)] = pa.key_hash_plain(s1, s2, spec, d)
    (hg, fg), (hc, fc) = res[str(cuda)], res["cpu"]
    assert torch.equal(hg.cpu(), hc) and torch.equal(fg.cpu(), fc)
    assert bool((fc & 16).any())


_CARD_SIDES = {}


def _card_sides(index, cuda, layout):
    """Card SideResults of 40,000 pairs (79 tiles of kernel E, past one
    look-back window of 32) and the card index with its position tables,
    once per layout."""
    key = layout.__name__
    if key not in _CARD_SIDES:
        d = pa.device_index_from_host(index, cuda, with_pos_tables=True)
        assert isinstance(d, layout)
        s1 = _sides(d, _random_batch(index, 40000, 100, 21), cuda)
        s2 = _sides(d, _random_batch(index, 40000, 100, 22), cuda)
        _CARD_SIDES[key] = (d, s1, s2)
    return _CARD_SIDES[key]


_KEY_SPECS = {
    "off": dict(),
    "mr50": dict(min_range=50),
    "strand_pos": dict(min_range=50, strand_key=True, pos_fl=180),
}


def _hold_compact_keys(s1, s2, spec, K_, d, with_slots):
    """compact_keys against key_hash_plain + key_histogram_plain on the
    same card tensors: every read's h and flags, the table and the slots
    bitwise; one launch counted under E's name."""
    name = "key_histogram_slots" if with_slots else "key_histogram"
    before = kernels.LAUNCHES[name]
    ck, slots, h, fl = kernels.compact_keys(s1, s2, spec, K_, with_slots, d,
                                            want_keys=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    hp, flp = pa.key_hash_plain(s1, s2, spec, d)
    assert torch.equal(h, hp) and torch.equal(fl, flp)
    want = pa.key_histogram_plain(hp, flp, K_, with_slots)
    if with_slots:
        assert torch.equal(ck, want[0]) and torch.equal(slots, want[1])
        assert int(slots.max()) <= K_ - 1
    else:
        assert torch.equal(ck, want)
    return ck


@pytest.mark.cuda
@pytest.mark.parametrize("K_", ["1", "100", "B+1"])
@pytest.mark.parametrize("opts", list(_KEY_SPECS))
@pytest.mark.parametrize("paired", [True, False])
def test_compact_keys_matches_plain(cuda, port_index, layout, paired, opts,
                                    K_):
    """Kernel E (compact key, table, slots) on 40,000 pairs, paired and
    single-end, options off, min_range 50, and min_range + strand tail +
    position rank, K = 1, 100 and B + 1, in both index layouts."""
    d, s1, s2 = _card_sides(port_index, cuda, layout)
    kw = dict(_KEY_SPECS[opts])
    if "pos_fl" in kw:
        kw["pos_depth"] = pa.pf_probe_depth(port_index)
    spec = pa.KeySpec(k=K, **kw)
    B = int(s1.rows.shape[0])
    Kn = B + 1 if K_ == "B+1" else int(K_)
    for with_slots in (False, True):
        ck = _hold_compact_keys(s1, s2 if paired else None, spec, Kn, d,
                                with_slots)
    assert int(ck[0, 0]) > (1000 if paired else 50)
    # the dispatchers on the card return what they return on the CPU
    if paired:
        got = pa.compact_pair_keys(s1, s2, Kn, didx=d, with_slots=True, **dict(
            kw, k=K))
        assert torch.equal(got[0], ck) and got[1].shape == (B,)
    else:
        got = pa.compact_single_keys(s1, Kn, didx=d, **dict(kw, k=K))
        assert torch.equal(got, ck)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hot", "b1", "b777", "b0"])
def test_compact_keys_edge_batches(cuda, port_index, layout, case):
    """Kernel E on a batch where one read's key covers 60 % of the reads
    (copies of read 0, hits and all), on B = 1, on B = 777 (not a multiple
    of the 512-read tile) and on B = 0 (nothing launched, meta row 0)."""
    d, s1, s2 = _card_sides(port_index, cuda, layout)
    spec = pa.KeySpec(k=K, min_range=50, strand_key=True, pos_fl=180,
                      pos_depth=pa.pf_probe_depth(port_index))
    B = int(s1.rows.shape[0])
    if case == "hot":
        rng = np.random.default_rng(5)
        sel = torch.from_numpy(np.where(rng.random(B) < 0.6, 0,
                                        np.arange(B))).to(cuda)
        s1 = pa.SideResult(*(t[sel].contiguous() for t in s1))
        s2 = pa.SideResult(*(t[sel].contiguous() for t in s2))
    elif case != "hot":
        n = {"b1": 1, "b777": 777, "b0": 0}[case]
        s1 = pa.SideResult(*(t[:n] for t in s1))
        s2 = pa.SideResult(*(t[:n] for t in s2))
    if case == "b0":
        before = dict(kernels.LAUNCHES)
        ck, slots, h, _ = kernels.compact_keys(s1, s2, spec, 10, True, d,
                                               want_keys=True)
        assert kernels.LAUNCHES == before
        assert not ck.cpu().any() and slots.shape == (0,) and h.shape == (0, 2)
        return
    for paired in (True, False):
        for K_ in (1, 100, int(s1.rows.shape[0]) + 1):
            for with_slots in (False, True):
                ck = _hold_compact_keys(s1, s2 if paired else None, spec, K_,
                                        d, with_slots)
                if case == "hot" and K_ > 1:
                    assert int(ck[1, 2]) > 0.6 * B - 500


def _crafted_keys(seed, B=20000):
    """Random keys from a pool of 3,000 with the words no read could be
    made to hash to: h0 = -1 (all ones), h0 = 0 (an empty slot's word) and
    one h0 on 55 % of the reads."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-2**63, 2**63 - 1, (3000, 2), dtype=np.int64)
    pool[1, 0] = pool[0, 0]
    pool[2, 0] = -1  # all ones
    pool[3, 0] = 0
    pick = rng.integers(0, 3000, B)
    pick[rng.random(B) < 0.55] = 7
    h = pool[pick]
    flags = (np.abs(h[:, 0]) % 64).astype(np.int32)
    return torch.from_numpy(h), torch.from_numpy(flags)


@pytest.mark.cuda
@pytest.mark.parametrize("K_", [1, 100, 6000])
def test_kernel_e_matches_plain(cuda, K_):
    th, tf = _crafted_keys(K_)
    before = kernels.LAUNCHES["key_histogram"]
    g, _, gh, _ = kernels.compact_keys(None, None, None, K_,
                                       keys=(th.to(cuda), tf.to(cuda)),
                                       want_keys=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["key_histogram"] == before + 1
    assert torch.equal(gh.cpu(), th)
    want = pa.key_histogram_plain(th, tf, K_)
    assert torch.equal(g.cpu(), want)
    assert int(want[0, 0]) == int(np.unique(th[:, 0].numpy()).shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("mr,sk,pk", [(0, False, False), (50, False, False),
                                      (0, True, False), (50, True, True)])
def test_kernel_f_matches_plain(cuda, port_index, paired, mr, sk, pk):
    spec = pa.KeySpec(k=K, min_range=mr, strand_key=sk,
                      pos_fl=180 if pk else -1)
    idx = np.random.default_rng(4).integers(0, 5000, 700)
    res = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        bs = _batches(port_index)
        s1 = _sides(d, bs["rand100"], dev)
        s2 = _sides(d, bs["rand76"], dev) if paired else None
        res[str(dev)] = pa.gather_exemplars(
            torch.from_numpy(idx).to(dev), s1, s2, spec)
    assert torch.equal(res[str(cuda)].cpu(), res["cpu"])


@pytest.mark.cuda
def test_compact_route_on_the_card_is_golden(cuda, port_index, tmp_path,
                                             monkeypatch):
    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.quant.pipeline import run_quant

    # the card's own steady state (kernel I): host wave 1 off
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    kernels.reset_launches()
    out = str(tmp_path / "single")
    res = run_quant(Options(
        files=[os.path.join(DATA, "reads_1.fastq.gz")], single_end=True,
        fld_mean=180, fld_sd=20, output_dir=out, batch_size=4096),
        index=port_index, device=cuda)
    assert res.timings["turbo"] > 0 and res.timings["full"] == 0
    # every batch turbo: the keys come from kernel E's first pass, kernel
    # B (the per-read form) is not launched
    for name in ("pseudoalign_anchor", "key_histogram", "gather_exemplars",
                 "em_step_batch"):
        assert kernels.LAUNCHES[name] > 0, name
    assert kernels.LAUNCHES["read_keys"] == 0
    with open(os.path.join(out, "abundance.tsv")) as f, open(os.path.join(
            DATA, "..", "golden", "quant_single", "abundance.tsv")) as g:
        assert f.read() == g.read()


def _batch_problem(Bb, seed):
    """A random EC structure and Bb resampled count vectors; replicate 0
    keeps only its singleton counts, so it converges first and is frozen
    while the others run."""
    rng = np.random.default_rng(seed)
    T = 300
    ec_sets = [np.array([t], np.int32) for t in range(0, T, 3)]
    for _ in range(400):
        n = int(rng.integers(2, 12))
        ec_sets.append(np.unique(rng.choice(T, n, replace=False)).astype(np.int32))
    counts = rng.integers(0, 500, len(ec_sets)).astype(np.float64)
    counts_b = np.stack([rng.multinomial(int(counts.sum()),
                                         counts / counts.sum())
                         for _ in range(Bb)]).astype(np.float64)
    problem = emq.build_em_problem(ec_sets, T)
    counts_b[0, problem.multi_ec_ids] = 0
    return problem, counts_b, rng.uniform(50, 3000, T), rng


def _g_update(prob, alpha, mode):
    """One round of kernel G's loop (EmLoop, a graph of one round on the
    card) from alpha [Bb, T] with per-replicate modes and the stop rule
    out of reach: (next [Bb, T], change counts [Bb]) as CPU tensors."""
    Bb = alpha.shape[0]
    loop = emq.EmLoop(prob, alpha, 2**31 - 1, mode=mode.astype(np.int64),
                      rounds=1)
    loop.set_bound(1)
    try:
        loop.run_chunk()
        st, bufs = loop.read(with_alpha=True)
    finally:
        loop.close()
    return (torch.from_numpy(bufs[1].T.copy()),
            torch.from_numpy(st[4 + 2 * Bb:].astype(np.int32)))


def _g_launches(rounds):
    """Kernel G's launches for one segment of `rounds` rounds: every
    graph replay counts the EM_CHUNK rounds it holds."""
    return -(-rounds // emq.EM_CHUNK) * emq.EM_CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("batched_eff", [False, True])
def test_kernel_g_step_bitwise(cuda, batched_eff):
    problem, counts_b, eff, rng = _batch_problem(6, 21)
    T = problem.num_trans
    sa_b, mc_b = emq.em_inputs(problem, counts_b)
    inv = 1.0 / (eff[None, :] * rng.uniform(0.8, 1.2, (6, T))
                 if batched_eff else eff)
    alpha = rng.uniform(0, 50, (6, T))
    alpha[:, ::5] = 1e-9
    mode = np.array([1, 0, 2, 1, 2, 0], np.int32)
    ng, cg = _g_update(emq.device_em_problem(problem, sa_b, mc_b, inv, cuda),
                       alpha, mode)
    nc, cc = emq.em_step_batch_plain(
        torch.from_numpy(alpha),
        emq.device_em_problem(problem, sa_b, mc_b, inv, "cpu"),
        torch.from_numpy(mode))
    assert torch.equal(ng, nc) and torch.equal(cg, cc)
    assert int(cc[1]) == 0 and torch.equal(nc[1], torch.from_numpy(alpha[1]))


@pytest.mark.cuda
def test_kernel_g_whole_batch_em_bitwise(cuda):
    """8 replicates to convergence: replicate 0 stops first and stays
    frozen while the others run; bitwise alpha, alpha_before_zeroes and
    equal rounds, card against CPU."""
    problem, counts_b, eff, _ = _batch_problem(8, 22)
    before = kernels.LAUNCHES["em_step_batch"]
    g = emq.run_em_batch(problem, counts_b, eff, device=cuda)
    launched = kernels.LAUNCHES["em_step_batch"] - before
    c = emq.run_em_batch(problem, counts_b, eff, device="cpu")
    assert np.array_equal(g.n_rounds, c.n_rounds)
    assert g.rounds == c.rounds == int(c.n_rounds.max()) + 1
    assert launched == _g_launches(g.rounds)
    assert g.n_rounds[0] < g.n_rounds[1:].min()
    assert np.array_equal(g.alpha, c.alpha)
    assert np.array_equal(g.alpha_before_zeroes, c.alpha_before_zeroes)


@pytest.mark.cuda
@pytest.mark.parametrize("Bb,own_lengths", [(1, False), (8, False),
                                            (100, False), (256, True)])
def test_kernel_g_update_bitwise(cuda, Bb, own_lengths):
    """One update through the replicate-minor lanes (a graph of one round)
    at Bb = 1, 8, 100 and 256 with their own lengths (quant-tcc's chunk),
    modes 0/1/2 mixed (Bb = 1: each mode in turn): next and change counts
    bitwise the plain version's on the CPU."""
    problem, counts_b, eff, rng = _batch_problem(Bb, 31)
    T = problem.num_trans
    sa_b, mc_b = emq.em_inputs(problem, counts_b)
    inv = 1.0 / (eff[None, :] * rng.uniform(0.8, 1.2, (Bb, T))
                 if own_lengths else eff)
    alpha = rng.uniform(0, 50, (Bb, T))
    alpha[:, ::5] = 1e-9
    modes = ([np.array([m], np.int32) for m in (1, 2, 0)] if Bb == 1
             else [(np.arange(Bb) % 3).astype(np.int32)])
    prob_g = emq.device_em_problem(problem, sa_b, mc_b, inv, cuda)
    prob_c = emq.device_em_problem(problem, sa_b, mc_b, inv, "cpu")
    for mode in modes:
        ng, cg = _g_update(prob_g, alpha, mode)
        nc, cc = emq.em_step_batch_plain(torch.from_numpy(alpha), prob_c,
                                         torch.from_numpy(mode))
        assert torch.equal(ng, nc) and torch.equal(cg, cc)
        assert int(cc.sum()) > 0 or not (mode != 0).any()


def _slow_problem():
    """Transcript 0 decays by ~2 % a round against transcript 1, so the
    EM runs ~660 rounds (tests/test_torch_em.py's problem)."""
    ec_sets = [np.array([t], np.int32) for t in range(6)] + [
        np.array([0, 1], np.int32), np.array([2, 3], np.int32)]
    counts = np.array([0, 200, 0, 100, 50, 70, 10000, 100], np.float64)
    return emq.build_em_problem(ec_sets, 6), counts, np.full(6, 1000.0)


@pytest.mark.cuda
@pytest.mark.parametrize("Bb", [1, 100])
def test_kernel_g_loop_bitwise(cuda, Bb):
    """The whole run_em_batch with its rounds on the card (CUDA graph
    chunks, the stop rule on the card) against the plain loop on the CPU:
    equal rounds per replicate, bitwise alpha and alpha_before_zeroes; G
    counted EM_CHUNK rounds per graph replay, the replays covering the
    rounds read back from the card; one host read per chunk plus one."""
    problem, counts_b, eff, _ = _batch_problem(max(Bb, 2), 32)
    if Bb == 1:
        counts_b = counts_b[1:2]
    before = kernels.LAUNCHES["em_step_batch"]
    g = emq.run_em_batch(problem, counts_b, eff, device=cuda)
    launched = kernels.LAUNCHES["em_step_batch"] - before
    c = emq.run_em_batch(problem, counts_b, eff, device="cpu")
    assert np.array_equal(g.n_rounds, c.n_rounds)
    assert np.array_equal(g.alpha, c.alpha)
    assert np.array_equal(g.alpha_before_zeroes, c.alpha_before_zeroes)
    rounds = int(c.n_rounds.max()) + 1
    assert g.rounds == c.rounds == rounds
    assert launched == _g_launches(rounds)
    assert g.host_reads == c.host_reads <= -(-rounds // emq.EM_CHUNK) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("min_rounds", [50, 163])
def test_kernel_g_bias_segments_bitwise(cuda, min_rounds):
    """run_em with a bias hook (lengths doubled, alpha reported back) over
    its three segments on the card: the hook sees the same alphas as on
    the CPU, the shared lengths are rewritten in place under the graph,
    and the result is bitwise the CPU's."""
    problem, counts, eff = _slow_problem()
    seen = {}

    def hook(tag):
        seen[tag] = []

        def f(alpha, e):
            seen[tag].append(alpha.copy())
            return e * 2.0, alpha.copy()
        return f

    g = emq.run_em(problem, counts, eff, min_rounds=min_rounds,
                   bias_update=hook("card"), device=cuda)
    c = emq.run_em(problem, counts, eff, min_rounds=min_rounds,
                   bias_update=hook("cpu"), device="cpu")
    assert g.n_rounds == c.n_rounds and len(seen["card"]) == 2
    assert all(np.array_equal(a, b) for a, b in zip(seen["card"],
                                                    seen["cpu"]))
    assert np.array_equal(g.alpha, c.alpha)
    assert np.array_equal(g.alpha_before_zeroes, c.alpha_before_zeroes)
    assert np.array_equal(g.eff_lens, c.eff_lens)


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [True, False])
def test_kernel_h_matches_plain(cuda, port_index, paired):
    """Kernel H, B's epilogue: read_keys(..., bias=) on the card gives the
    plain key, fragment length and hexamer ids (read_keys_plain +
    bias_hexamers_plain), and h and tl bitwise those of B without bias;
    B = 1 and rows 4 bytes off a 16-byte boundary too; the launch counts
    as read_keys and bias_hexamers; bias_hexamers on the card goes through
    it with any valid mask; the tables are checked once."""
    bs = _batches(port_index)
    res = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        s1 = _sides(d, bs["bundled_1"], dev)
        s2 = _sides(d, bs["bundled_2"], dev) if paired else None
        bt = pa.bias_tables_from_host(port_index, dev)
        if dev == cuda:
            before = dict(kernels.LAUNCHES)
        res[str(dev)] = (pa.read_keys(s1, s2, K, bias=bt),
                         pa.read_keys(s1, s2, K), s1, s2, bt)
    (g, gb, s1, s2, bt), (c, _, c1, c2, _) = res[str(cuda)], res["cpu"]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["read_keys"] == before["read_keys"] + 2
    assert kernels.LAUNCHES["bias_hexamers"] == before["bias_hexamers"] + 1
    valid = c2.has_hits if paired else torch.ones_like(c1.has_hits)
    want = pa.bias_hexamers_plain(_cpu_bt(bt), c1, valid, K)
    assert g[2].dtype == c[2].dtype == torch.int32
    assert torch.equal(g[2].cpu(), c[2]) and torch.equal(c[2], want)
    assert bool((want >= 0).any()) and bool((want == -1).any())
    for a, b, x in zip(g[:2], gb[:2], c[:2]):
        assert (a is None and b is None and x is None) or (
            torch.equal(a, b) and torch.equal(a.cpu(), x))
    one = pa.SideResult(*(t[:1] for t in s1))
    two = None if s2 is None else pa.SideResult(*(t[:1] for t in s2))
    assert torch.equal(kernels.read_keys(one, two, K, bias=bt)[2].cpu(),
                       c[2][:1])
    off = s1._replace(rows=_offset_rows(s1.rows, 1))
    assert torch.equal(kernels.read_keys(off, s2, K, bias=bt)[2].cpu(), c[2])
    # any valid mask through the fused launch
    vmask = torch.from_numpy(np.random.default_rng(5).random(
        c1.has_hits.shape[0]) < 0.7)
    n0 = kernels.LAUNCHES["bias_hexamers"]
    got = pa.bias_hexamers(bt, s1, vmask.to(cuda), K)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bias_hexamers"] == n0 + 1
    assert torch.equal(got.cpu(), pa.bias_hexamers_plain(_cpu_bt(bt), c1,
                                                         vmask, K))
    assert len(kernels._BIAS_VIEWS) >= 1


def _cpu_bt(bt):
    return pa.BiasTables(*(t.cpu() for t in bt))


@pytest.mark.cuda
def test_kernel_h_clip_matches_plain(cuda, port_index):
    """Random first-hit fields (many out of range: the start clipped to [0,
    S - 6], the last unitig_seq word read) through the fused launch, paired
    and single-end, against the plain version; tables whose unitig_seq is
    not padded are copied once into a padded buffer."""
    rng = np.random.default_rng(2)
    B = 5000
    NB = port_index.block_start.shape[0]
    U = port_index.unitig_seq_off.shape[0] - 1
    S = int(port_index.unitig_seq.shape[0])
    f = dict(
        rows=rng.integers(-1, 50, (B, 4)).astype(np.int32),
        n_rows=np.zeros(B, np.int32),
        has_hits=rng.random(B) < 0.9, overflow=rng.random(B) < 0.1,
        f_uid=rng.integers(-1, U, B).astype(np.int32),
        f_block=rng.integers(-1, NB, B).astype(np.int32),
        f_upos=rng.integers(-50, S + 50, B).astype(np.int32),
        f_rpos=rng.integers(0, 80, B).astype(np.int32),
        f_strand=rng.random(B) < 0.5, rng=np.zeros(B, np.int32))
    c1 = pa.SideResult(**{k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in f.items()})
    c2 = c1._replace(has_hits=torch.from_numpy(rng.random(B) < 0.9))
    g1 = pa.SideResult(*(t.to(cuda) for t in c1))
    g2 = pa.SideResult(*(t.to(cuda) for t in c2))
    bt = pa.bias_tables_from_host(port_index, "cpu")
    tight = pa.BiasTables(*(t.clone().to(cuda) for t in bt))
    for gbt in (pa.bias_tables_from_host(port_index, cuda), tight):
        for a, b, x, y in ((g1, g2, c1, c2), (g1, None, c1, None)):
            got = kernels.read_keys(a, b, K, bias=gbt)
            want = pa.read_keys(x, y, K, bias=bt)
            torch.cuda.synchronize()
            for u, v in zip(got, want):
                assert (u is None and v is None) or torch.equal(u.cpu(), v)
    assert len(np.unique(want[2].numpy())) > 100


def _anchor_case(index, single, L, rl, dev, n=3000):
    """A uniform-length turbo batch for the anchor kernel: reads of length
    L (0.5% Ns through the aux vector) padded to Bp > n rows; rl = 0 keeps
    the padded columns, rl = L trims them."""
    from kallisto_tpu_torch.ops import turbo
    from kallisto_tpu_torch.quant.pipeline import (
        _bucket_size, _pad_rows, _turbo_exceptions)

    bs = [_random_batch(index, n, L, s) for s in ((21,) if single else (21, 22))]
    for b in bs:
        b.lens[:] = L
    Bp = _bucket_size(n, lo=256)
    aux = turbo.make_aux(n, L, _turbo_exceptions(bs, Bp))
    packed = [torch.from_numpy(_pad_rows(b.packed, Bp)).to(dev) for b in bs]
    return packed, torch.from_numpy(aux).to(dev), bs[0].Lp, rl


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("L,trim", [(50, True), (50, False), (100, True),
                                    (31, True)])
def test_kernel_i_matches_plain(cuda, port_index, layout, single, L, trim):
    """Every SideResult field and n_fail; L = 31 = k is the one-slot wave-2
    row that fills all 16 slots."""
    from kallisto_tpu_torch.ops import anchor

    na = anchor.n_anchors_for(L, K)
    out = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        assert isinstance(d, layout)
        packed, aux, Lp, rl = _anchor_case(port_index, single, L,
                                           L if trim else 0, dev)
        before = kernels.LAUNCHES["pseudoalign_anchor"]
        out[str(dev)] = anchor.anchor_sides(d, packed, aux, K, Lp, 16, na, rl)
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["pseudoalign_anchor"] == before + 1
    (g, gf), (c, cf) = out[str(cuda)], out["cpu"]
    assert 0 < int(cf) < int(c.has_hits.sum())
    assert int(gf) == int(cf)
    for f in pa.SideResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
def test_kernel_i_matches_kernel_d(cuda, port_index, single):
    """Rows, row counts, hits and overflow flags equal to kernel D's on the
    same batch, and the key tables equal in first-read order."""
    from kallisto_tpu_torch.ops import anchor, turbo

    d = pa.device_index_from_host(port_index, cuda)
    packed, aux, Lp, rl = _anchor_case(port_index, single, 100, 100, cuda)
    kw = dict(k=K, L=Lp, rl=rl, max_keys=4097)
    if single:
        a1, ack = anchor.pseudoalign_single_anchor(
            d, packed[0], aux, n_anchors=anchor.n_anchors_for(100, K), **kw)
        t1, tck = turbo.pseudoalign_single_turbo(d, packed[0], aux, **kw)
        pairs = [(a1, t1)]
    else:
        a1, a2, ack = anchor.pseudoalign_pair_anchor(
            d, *packed, aux, n_anchors=anchor.n_anchors_for(100, K), **kw)
        t1, t2, tck = turbo.pseudoalign_pair_turbo(d, *packed, aux, **kw)
        pairs = [(a1, t1), (a2, t2)]
    for a, t in pairs:
        for f in ("rows", "n_rows", "has_hits", "overflow"):
            assert torch.equal(getattr(a, f), getattr(t, f)), f
    ack, tck = ack.cpu(), tck.cpu()
    assert int(ack[0, 1]) > 0 and int(tck[0, 1]) == 0
    assert torch.equal(ack[0, 0], tck[0, 0]) and torch.equal(ack[1:], tck[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
def test_kernel_i_key_table_matches_plain(cuda, port_index, single):
    """Kernels I, B and E on the card against the plain versions: the whole
    key table equal, n_fail in its meta row included."""
    from kallisto_tpu_torch.ops import anchor

    res = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        packed, aux, Lp, rl = _anchor_case(port_index, single, 100, 100, dev)
        kw = dict(k=K, L=Lp, rl=rl, max_keys=4097, n_anchors=4)
        if single:
            _, ck = anchor.pseudoalign_single_anchor(d, packed[0], aux, **kw)
        else:
            _, _, ck = anchor.pseudoalign_pair_anchor(d, *packed, aux, **kw)
        res[str(dev)] = ck.cpu()
    g, c = res[str(cuda)], res["cpu"]
    assert 0 < int(c[0, 0]) <= 4097 and int(c[0, 1]) > 0
    assert torch.equal(g, c)


def _unitig_reads(index, n, L, seed, miss0):
    """n reads of length L copied from inside unitigs of at least L bases
    (half reverse-complemented): kernel I verifies every one in wave 1;
    with miss0 a substitution at column 5 makes anchor 0 miss, which sends
    every one to wave 2."""
    rng = np.random.default_rng(seed)
    off = index.unitig_seq_off
    ulen = np.diff(off)
    ok = np.flatnonzero(ulen >= L)
    u = ok[rng.integers(0, ok.shape[0], n)]
    starts = off[u] + (rng.random(n) * (ulen[u] - L + 1)).astype(np.int64)
    codes = index.unitig_seq[starts[:, None] + np.arange(L)[None, :]]
    codes = codes.astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    if miss0:
        codes[:, 5] = (codes[:, 5] + 1) % 4
    return _read_batch_to_packed(
        ReadBatch(codes=codes, lens=np.full(n, L, np.int32)), K)


@pytest.mark.cuda
@pytest.mark.parametrize("L,miss0,single", [
    (100, False, False), (100, True, False), (100, True, True),
    (1000, False, True), (1000, True, False)])
def test_kernel_i_all_or_no_reads_in_wave_2(cuda, port_index, layout, L,
                                            miss0, single):
    """Kernel I with no read in wave 2 and with every real read in wave 2
    (padding rows beside them), 100 bp and 1,000 bp reads (33 anchors, past
    a warp's 32 lanes): every field and n_fail equal to the plain version,
    wave 1 and wave 2 launched once each."""
    from kallisto_tpu_torch.ops import anchor, turbo
    from kallisto_tpu_torch.quant.pipeline import (
        _bucket_size, _pad_rows, _turbo_exceptions)

    n = 700
    bs = [_unitig_reads(port_index, n, L, s, miss0)
          for s in ((31,) if single else (31, 32))]
    Bp = _bucket_size(n, lo=256)
    aux = turbo.make_aux(n, L, _turbo_exceptions(bs, Bp))
    na = anchor.n_anchors_for(L, K)
    out = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        assert isinstance(d, layout)
        packed = [torch.from_numpy(_pad_rows(b.packed, Bp)).to(dev) for b in bs]
        kernels.reset_launches()
        out[str(dev)] = anchor.anchor_sides(d, packed,
                                            torch.from_numpy(aux).to(dev), K,
                                            bs[0].Lp, 16, na, L)
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["pseudoalign_anchor"] == 1
            assert kernels.LAUNCHES["pseudoalign_anchor_wave2"] == 1
    (g, gf), (c, cf) = out[str(cuda)], out["cpu"]
    assert int(cf) == (n * len(bs) if miss0 else 0)
    assert int(gf) == int(cf)
    for f in pa.SideResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def _side_batch(index, which):
    """Kernel A's two-wave cases: _batches' kinds, 40 bp reads (R = 10 <
    16), and reads from inside unitigs of 100 and 1,000 bp (all verified
    in wave 1; 1,000 bp reads have 33 anchors, past a warp's 32 lanes),
    the 100 bp ones also with a substitution at column 5 (all in wave
    2)."""
    if which == "rand40":
        return _random_batch(index, 4000, 40, 4)
    if which.startswith("unitig"):
        L = 1000 if which == "unitig1000" else 100
        return _unitig_reads(index, 700, L, 33, which.endswith("miss"))
    return _batches(index)[which]


@pytest.mark.cuda
@pytest.mark.parametrize("which", [
    "bundled_1", "rand100", "rand76", "rand40", "rand_short", "unitig100",
    "unitig100_miss", "unitig1000"])
def test_kernel_a_waves_match_plain(cuda, port_index, layout, which):
    """Kernel A's two launches on the card: every field equal to its plain
    version (the dense core) on the CPU, and its wave-2 count equal to the
    failing reads of the plain two-wave composition
    (anchor.side_waves_plain); wave 1 and wave 2 launched once each by
    one call, the same fields when the waves are launched apart, and no
    launch on no reads."""
    from kallisto_tpu_torch.ops import anchor

    pb = _side_batch(port_index, which)
    R = min(16, pb.Lp - K + 1)
    dg = pa.device_index_from_host(port_index, cuda)
    dc = pa.device_index_from_host(port_index, "cpu")
    assert isinstance(dg, layout) and isinstance(dc, layout)
    gin = pa.upload_batch(pb, cuda)
    kernels.reset_launches()
    g, _, nf = kernels.pseudoalign_side(dg, *gin, K, pb.Lp, R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pseudoalign_side"] == 1
    assert kernels.LAUNCHES["pseudoalign_side_wave2"] == 1
    apart = kernels.pseudoalign_side(
        dg, *gin, K, pb.Lp, R, waves=2,
        lists=kernels.pseudoalign_side(dg, *gin, K, pb.Lp, R, waves=1))
    kernels.pseudoalign_side(dg, *(t[:0] for t in gin), K, pb.Lp, R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pseudoalign_side"] == 2
    assert kernels.LAUNCHES["pseudoalign_side_wave2"] == 2
    assert int(apart[2]) == int(nf)
    for a, b in zip(apart[0], g):
        assert torch.equal(a, b)
    up = pa.upload_batch(pb, "cpu")
    c = pa.pseudoalign_batch_packed_plain(dc, *up, K, pb.Lp)
    w, fail = anchor.side_waves_plain(dc, *up, K, pb.Lp)
    for f, a in zip(pa.SideResult._fields, g):
        b = getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f
        assert torch.equal(getattr(w, f), b), f
    assert int(nf) == int(fail.sum())
    if which.startswith("unitig"):
        assert int(nf) == (pb.n if which.endswith("miss") else 0)
    else:
        assert 0 < int(nf) < pb.n or which == "rand_short"


def _f_sides(index, form):
    """Two mates' SideResult on the CPU for kernel F: kernel A's plain
    version on 5,000 reads of 100 and of 76 bp (R = 16); for "r15" their
    rows cut to 15 slots (odd: one word a load) and for "r10" reads of
    40 bp (R = 10: two words a load)."""
    d = pa.device_index_from_host(index, "cpu")
    bs = _batches(index)
    b1, b2 = bs["rand100"], bs["rand76"]
    if form == "r10":
        b1 = b2 = _random_batch(index, 5000, 40, 6)
    s1, s2 = (pa.pseudoalign_batch_packed(d, *pa.upload_batch(b, "cpu"), k=K,
                                          L=b.Lp) for b in (b1, b2))
    if form == "r15":
        s1, s2 = (s._replace(rows=s.rows[:, :15].contiguous())
                  for s in (s1, s2))
    return s1, s2


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["paired", "single", "paired_all",
                                  "single_all", "r15", "r10", "slim"])
@pytest.mark.parametrize("n", [0, 1, 37, 1001])
def test_kernel_f_edges_match_plain(cuda, port_index, form, n):
    """Kernel F (and its slim layout) on n keys -- none, one, a count that
    fills no whole block or warp -- with idx ascending and, past one key,
    holding reads outside [0, B) (-1, B, B + 7), which get a zero row:
    every other row equal to the plain version, options off and every
    option on, paired and single-end, row widths 16, 15 and 10; launched
    once where there are keys and not at all on none."""
    s1, s2 = _f_sides(port_index, form)
    B = int(s1.rows.shape[0])
    rng = np.random.default_rng(n)
    idx = np.sort(rng.integers(0, B, n))
    bad = np.zeros(n, bool)
    if n > 1:
        pos = rng.choice(n, 3, replace=False)
        idx[pos] = [-1, B, B + 7]
        bad[pos] = True
    allopt = form.endswith("_all")
    spec = pa.KeySpec(k=K, min_range=50 if allopt else 0, strand_key=allopt,
                      pos_fl=180 if allopt else -1)
    if form.startswith("single"):
        s2 = None
    ti = torch.from_numpy(idx)
    safe = torch.from_numpy(np.where(bad, 0, idx))
    if form == "slim":
        want = pa.gather_slim_plain(safe, s1, s2)
    else:
        want = pa.gather_exemplars_plain(safe, s1, s2, spec)
    want[torch.from_numpy(bad)] = 0
    g1 = pa.SideResult(*(t.to(cuda) for t in s1))
    g2 = None if s2 is None else pa.SideResult(*(t.to(cuda) for t in s2))
    before = kernels.LAUNCHES["gather_slim" if form == "slim"
                              else "gather_exemplars"]
    if form == "slim":
        got = kernels.gather_slim(ti.to(cuda), g1, g2)
    else:
        got = kernels.gather_exemplars(ti.to(cuda), g1, g2, spec)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)
    after = kernels.LAUNCHES["gather_slim" if form == "slim"
                             else "gather_exemplars"]
    assert after - before == (n > 0)


def _code_batch(index, L, seed, lens_cut):
    """Unpacked [n, L] uint8 codes for kernel A on codes: reads of the
    unitig sequences with 1% Ns (code 4) and 0.2% codes above 4, some
    lengths cut below L and some below k (lens_cut)."""
    rng = np.random.default_rng(seed)
    n = 3000
    seq = index.unitig_seq
    starts = rng.integers(0, seq.shape[0] - L, n)
    codes = seq[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    codes[rng.random((n, L)) < 0.01] = 4
    codes[rng.random((n, L)) < 0.002] = 7
    lens = np.full(n, L, np.int32)
    if lens_cut:
        cut = rng.random(n) < 0.3
        lens[cut] = rng.integers(1, L + 1, int(cut.sum()))
    return np.ascontiguousarray(codes), lens


@pytest.mark.cuda
@pytest.mark.parametrize("L,lens_cut", [(100, False), (93, True), (45, True),
                                        (230, True), (1000, False)])
def test_kernel_a_on_codes_matches_plain(cuda, port_index, layout, L,
                                         lens_cut):
    """pseudoalign_batch on unpacked codes (Ns and codes above 4, widths
    not a multiple of 8, lengths below the width and below k, 200 windows,
    33 anchors at 1,000 columns: past a warp's lanes) on the card: every
    field equal to _pseudoalign_core on the CPU, wave 1 and wave 2
    launched once each; the wave-2 reads and the windows wave 2 probed
    equal to the plain two-wave model's (anchor.codes_waves_plain); wave 1
    alone equal to the model on the reads it verifies, wave 2 alone then
    completing every field; no launch on no reads."""
    from kallisto_tpu_torch.ops import anchor

    codes, lens = _code_batch(port_index, L, L, lens_cut)
    out = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        assert isinstance(d, layout)
        kernels.reset_launches()
        out[str(dev)] = pa.pseudoalign_batch(
            d, torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev),
            K)
        assert kernels.LAUNCHES["pseudoalign_codes"] == (dev == cuda)
        assert kernels.LAUNCHES["pseudoalign_codes_wave2"] == (dev == cuda)
    g, c = out[str(cuda)], out["cpu"]
    assert bool(c.has_hits.any())
    for f in pa.SideResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f

    dc = pa.device_index_from_host(port_index, "cpu")
    w, fail, probed = anchor.codes_waves_plain(
        dc, torch.from_numpy(codes), torch.from_numpy(lens), K)
    for f in pa.SideResult._fields:
        assert torch.equal(getattr(w, f), getattr(c, f)), f
    dg = pa.device_index_from_host(port_index, cuda)
    gc, gl = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    R = min(16, L - K + 1)
    n_pr = torch.zeros(1, dtype=torch.int64, device=cuda)
    kernels.reset_launches()
    lists = kernels.pseudoalign_codes(dg, gc, gl, K, R, waves=1)
    torch.cuda.synchronize()
    assert int(lists[2]) == int(fail.sum())
    assert int(fail.sum()) > 0
    ver = ~fail
    for f, a in zip(pa.SideResult._fields, lists[0]):
        assert torch.equal(a.cpu()[ver], getattr(w, f)[ver]), f
    apart = kernels.pseudoalign_codes(dg, gc, gl, K, R, waves=2, lists=lists,
                                      probes=n_pr)
    kernels.pseudoalign_codes(dg, gc[:0], gl[:0], K, R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pseudoalign_codes"] == 1
    assert kernels.LAUNCHES["pseudoalign_codes_wave2"] == 1
    assert int(n_pr) == int(probed.sum())
    for f, a in zip(pa.SideResult._fields, apart[0]):
        assert torch.equal(a.cpu(), getattr(c, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("L", [100, 200])
@pytest.mark.parametrize("varlen", [False, True])
def test_kernel_d_past_64_windows_matches_plain(cuda, port_index, layout, L,
                                                varlen):
    """Kernel D on 100 bp pairs (70 windows: three per lane) and 200 bp
    pairs (170 windows: two passes of the core), uniform and mixed
    lengths, Ns through the aux vector and padding rows: every field equal
    to the plain version."""
    from kallisto_tpu_torch.ops import turbo
    from kallisto_tpu_torch.quant.pipeline import (
        _bucket_size, _pad_rows, _turbo_exceptions, _uniform_len)

    bs = [_random_batch(port_index, 3000, L, s) for s in (13, 14)]
    if not varlen:
        for b in bs:
            b.lens[:] = L
    Bp = _bucket_size(3000, lo=256)
    rl = _uniform_len(*bs) or 0
    aux = turbo.make_aux(3000, rl, _turbo_exceptions(bs, Bp))
    out = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        assert isinstance(d, layout)
        packed = [torch.from_numpy(_pad_rows(b.packed, Bp)).to(dev) for b in bs]
        lens = None
        if varlen:
            lens = torch.from_numpy(np.concatenate(
                [_pad_rows(b.lens.astype(np.uint16), Bp) for b in bs])).to(dev)
        out[str(dev)] = turbo.turbo_sides(d, packed,
                                          torch.from_numpy(aux).to(dev), lens,
                                          K, bs[0].Lp, 16, rl)
    g, c = out[str(cuda)], out["cpu"]
    assert bool(c.has_hits.any())
    for f in pa.SideResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def _long_batch(index, which, tmp_dir):
    """A packed batch of long reads: the bundled PacBio-style reads, reads
    generated from the bundled transcripts (whole and 5'-truncated
    transcripts, chimeras, mosaics past 128 groups, random reads, reads
    shorter than k, Ns), or three reads of 140,000, 9,000 and 40 bases cut
    from the unitig sequences (kernel J's global workspaces)."""
    from kallisto_tpu_torch.utils.benchdata import generate_long_reads

    if which == "bundled_lr":
        return _bundled_batch("reads_lr.fastq.gz")
    if which == "generated":
        path = os.path.join(str(tmp_dir), "lr.fastq.gz")
        generate_long_reads(os.path.join(DATA, "transcripts.fasta.gz"), path,
                            48, seed=8, novel_frac=0.1, chimera_frac=0.2,
                            mosaic_frac=0.2, short_frac=0.1, n_rate=0.002)
        return next(packed_single_batches(path, 1000, K))
    rng = np.random.default_rng(12)
    seq = index.unitig_seq
    L = 140000
    codes = np.full((3, L), 4, np.uint8)
    lens = np.array([L, 9000, 40], np.int32)
    for r, n in enumerate(lens):
        pos = 0
        while pos < n:
            m = min(int(rng.integers(200, 2000)), n - pos)
            s = int(rng.integers(0, seq.shape[0] - m))
            codes[r, pos:pos + m] = seq[s:s + m]
            pos += m
    codes[:, ::997] = 4
    return _read_batch_to_packed(ReadBatch(codes=codes, lens=lens), K)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["bundled_lr", "generated", "huge"])
@pytest.mark.parametrize("budgets", [(64, 128), (2, 4)])
def test_kernel_j_matches_plain(cuda, port_index, layout, tmp_path, which,
                               budgets):
    """Every LongResult field equal, with the default budgets and with
    budgets small enough that n_rows and n_groups count past them."""
    R, G = budgets
    pb = _long_batch(port_index, which, tmp_path)
    out = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        assert isinstance(d, layout)
        before = kernels.LAUNCHES["pseudoalign_long"]
        out[str(dev)] = pa.pseudoalign_long_packed(
            d, *pa.upload_batch(pb, dev), k=K, L=pb.Lp, max_rows=R,
            max_groups=G)
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["pseudoalign_long"] == before + 1
    g, c = out[str(cuda)], out["cpu"]
    assert bool(c.has_hits.any())
    if budgets == (2, 4):
        assert bool(c.overflow.any()) and bool(c.g_overflow.any())
    for f in pa.LongResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def _mixed_long_batch(index):
    """Long reads of 600 and 5,500 bases (5d's range), reads shorter than
    k, and two 60,000-base mosaics of 40-100-base pieces from random
    places in the unitig sequences, whose group openers pass the 512 rows
    that kernel J keeps in shared memory; 0.1 % Ns."""
    rng = np.random.default_rng(41)
    seq = index.unitig_seq
    lens = np.array([600] * 6 + [5500] * 6 + [0, 12, 30] + [60000] * 2,
                    np.int32)
    L = int(lens.max())
    codes = np.full((lens.shape[0], L), 4, np.uint8)
    for r, n in enumerate(lens):
        pos = 0
        while pos < n:
            hi = 100 if n == 60000 else 3000
            m = min(int(rng.integers(40, hi)), n - pos)
            s = int(rng.integers(0, seq.shape[0] - m))
            codes[r, pos:pos + m] = seq[s:s + m]
            pos += m
        codes[r, :n][rng.random(n) < 0.001] = 4
    return _read_batch_to_packed(ReadBatch(codes=codes, lens=lens), K)


@pytest.mark.cuda
@pytest.mark.parametrize("budgets", [(64, 128), (64, 4096)])
def test_kernel_j_mixed_lengths_and_spill(cuda, port_index, layout, budgets):
    """Kernel J on reads of 600 and 5,500 bases, reads shorter than k and
    mosaics past its shared row list: every LongResult field equal to the
    plain version in both layouts (G = 4096 keeps every group)."""
    R, G = budgets
    pb = _mixed_long_batch(port_index)
    out = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        assert isinstance(d, layout)
        out[str(dev)] = pa.pseudoalign_long_packed(
            d, *pa.upload_batch(pb, dev), k=K, L=pb.Lp, max_rows=R,
            max_groups=G)
    g, c = out[str(cuda)], out["cpu"]
    if G == 4096:
        listed = (c.groups >= 0).sum(dim=1)
        assert int(listed.max()) > kernels.LONG_SLIST
    assert (c.n_groups[12:15] == 0).all() and bool(c.has_hits[:12].all())
    for f in pa.LongResult._fields:
        a, b = getattr(g, f).cpu(), getattr(c, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.cuda
def test_long_read_quant_on_the_card_matches_the_cpu(cuda, port_index,
                                                     tmp_path):
    """quant --long through kernel J: abundance.tsv and novel.fastq
    byte-equal to the CPU run."""
    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.quant.pipeline import run_quant

    outs = {}
    for dev in (cuda, "cpu"):
        kernels.reset_launches()
        out = str(tmp_path / str(dev))
        res = run_quant(Options(
            files=[os.path.join(DATA, "reads_lr.fastq.gz")], single_end=True,
            long_read=True, platform="PacBio", plaintext=True,
            output_dir=out), index=port_index, device=dev)
        if dev == cuda:
            assert kernels.LAUNCHES["pseudoalign_long"] == res.timings["long"]
            assert kernels.LAUNCHES["em_step_batch"] > 0
        outs[str(dev)] = out
    for fname in ("abundance.tsv", "novel.fastq"):
        with open(os.path.join(outs[str(cuda)], fname)) as f, \
                open(os.path.join(outs["cpu"], fname)) as g:
            assert f.read() == g.read(), fname


def _uniform_pairs(index, n, L, seed):
    """Two mates of n uniform-length reads from the unitig sequences, 2%
    substitutions and 0.3% Ns (so that many pairs have one failed mate)."""
    out = []
    for s in (seed, seed + 1):
        rng = np.random.default_rng(s)
        seq = index.unitig_seq
        starts = rng.integers(0, max(seq.shape[0] - L, 1), n)
        codes = seq[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
        rc = rng.random(n) < 0.5
        codes[rc] = (3 - codes[rc])[:, ::-1]
        err = rng.random((n, L)) < 0.02
        codes[err] = (codes[err] + 1) % 4
        codes[rng.random((n, L)) < 0.003] = 4
        out.append(_read_batch_to_packed(
            ReadBatch(codes=codes, lens=np.full(n, L, np.int32)), K))
    return out


def _halffail_slice(index, n, L, seed):
    """A half-fail wave-2 slice as quant/pipeline.py builds it."""
    from kallisto_tpu_torch.ops import turbo
    from kallisto_tpu_torch.ops.hostprobe import HostProbe
    from kallisto_tpu_torch.quant import pipeline as qp

    b1, b2 = _uniform_pairs(index, n, L, seed)
    hk = HostProbe(index).probe_pair(b1, b2, L)
    half = np.flatnonzero(hk.fail_side != 3)
    sub = hk.fail_idx[half].astype(np.int64)
    side = hk.fail_side[half]
    Bp = qp._bucket_size(sub.shape[0], lo=1024)
    m1 = (side == 1)[:, None]
    pkf = np.where(m1, b1.packed[sub], b2.packed[sub])
    nmf = np.where(m1, b1.nmask[sub], b2.nmask[sub])
    exc = qp._rows_exceptions([(nmf, b1.lens[sub])], Bp, b1.Lp)
    aux = turbo.make_aux(sub.shape[0], L, exc)
    assert sub.shape[0] > 100 and exc.size > 0
    return (qp._pad_rows(pkf, Bp), qp._pad_rows(hk.fail_vsum[half], Bp),
            qp._pad_rows(side.astype(np.int32), Bp), aux, b1.Lp)


@pytest.mark.cuda
@pytest.mark.parametrize("L,max_rows", [(50, 16), (100, 32), (100, 16)])
@pytest.mark.parametrize("opts", [False, True])
def test_kernel_k_matches_plain(cuda, port_index, layout, L, max_rows,
                               opts):
    from kallisto_tpu_torch.ops import turbo

    args = _halffail_slice(port_index, 6000, L, 5)
    kw = dict(k=K, L=args[4], max_rows=max_rows, rl=L, with_slots=True,
              max_keys=args[0].shape[0] + 1)
    if opts:
        kw.update(min_range=60, strand_key=True, pos_fl=180,
                  pos_depth=pa.pf_probe_depth(port_index))
    res = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev, with_pos_tables=True)
        assert isinstance(d, layout)
        t = [torch.from_numpy(a).to(dev) for a in args[:4]]
        before = kernels.LAUNCHES["pseudoalign_halffail"]
        res[str(dev)] = turbo.pseudoalign_pair_halffail(d, *t, **kw)
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["pseudoalign_halffail"] == before + 1
    (g1, g2, gck, gsl), (c1, c2, cck, csl) = res[str(cuda)], res["cpu"]
    for g, c in ((g1, c1), (g2, c2)):
        for f in pa.SideResult._fields:
            a, b = getattr(g, f).cpu(), getattr(c, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
    assert torch.equal(gck.cpu(), cck) and torch.equal(gsl.cpu(), csl)
    # the failed mates' windows that the covered-interval core probed: the
    # plain model's mask (anchor.skip_core_plain), fewer than the windows
    from kallisto_tpu_torch.ops import anchor

    t = [torch.from_numpy(a) for a in args[:4]]
    codes, lens_v = turbo.codes_and_lens_plain((t[0],), t[3], None, args[4],
                                               L)
    dc = pa.device_index_from_host(port_index, "cpu")
    _, probed = anchor.skip_core_plain(dc, codes, lens_v, K, max_rows)
    dg = pa.device_index_from_host(port_index, cuda)
    n_pr = torch.zeros(1, dtype=torch.int64, device=cuda)
    kernels.pseudoalign_halffail(dg, *(a.to(cuda) for a in t), K, args[4], L,
                                 min(max_rows, L - K + 1), probes=n_pr)
    torch.cuda.synchronize()
    assert int(n_pr) == int(probed.sum()) < probed.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1000, 200, 31])
def test_kernel_k_read_lengths_match_plain(cuda, port_index, layout, L):
    """Kernel K past the host probe's read lengths: 1,000 bp failed mates
    (33 anchors: one read a warp, passes of 31 intervals), 200 bp (eight
    anchors, four reads a warp) and reads of k bases (one window), with
    random verified-mate summaries, sidev and padding pairs: both mates
    equal to the plain halffail_core, and the probed windows to the plain
    model's mask."""
    from kallisto_tpu_torch.ops import anchor, turbo
    from kallisto_tpu_torch.quant import pipeline as qp

    b1 = _uniform_pairs(port_index, 700, L, 21)[0]
    n, Bp = b1.n, b1.n + 45
    rng = np.random.default_rng(L)
    nb = port_index.block_ec.shape[0]
    vsum = np.stack([rng.integers(0, max(nb - 16, 1), n),
                     (rng.integers(0, 5000, n) << 5)
                     | (rng.integers(0, 9, n) << 1) | rng.integers(0, 2, n)],
                    axis=1).astype(np.int32)
    sidev = rng.integers(1, 3, n).astype(np.int32)
    exc = qp._rows_exceptions([(b1.nmask, b1.lens)], Bp, b1.Lp)
    args = (qp._pad_rows(b1.packed, Bp), qp._pad_rows(vsum, Bp),
            qp._pad_rows(sidev, Bp), turbo.make_aux(n, L, exc))
    R = min(16, L - K + 1)
    dg = pa.device_index_from_host(port_index, cuda)
    dc = pa.device_index_from_host(port_index, "cpu")
    assert isinstance(dg, layout)
    t = [torch.from_numpy(a) for a in args]
    n_pr = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = kernels.pseudoalign_halffail(dg, *(a.to(cuda) for a in t), K, b1.Lp,
                                       L, R, probes=n_pr)
    want = turbo.halffail_core(dc, *t, K, b1.Lp, 16, L)
    torch.cuda.synchronize()
    for g, c in zip(got, want):
        for f, a in zip(pa.SideResult._fields, g):
            b = getattr(c, f)
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f
    codes, lens_v = turbo.codes_and_lens_plain((t[0],), t[3], None, b1.Lp, L)
    assert int(n_pr) == int(anchor.skip_core_plain(dc, codes, lens_v, K,
                                                   16)[1].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("K_", [1, 100, 6000])
def test_kernel_e_slots_match_plain(cuda, K_):
    th, tf = _crafted_keys(K_ + 7)
    before = dict(kernels.LAUNCHES)
    g, gs, _, _ = kernels.compact_keys(None, None, None, K_, True,
                                       keys=(th.to(cuda), tf.to(cuda)))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["key_histogram_slots"] == \
        before["key_histogram_slots"] + 1
    assert kernels.LAUNCHES["key_histogram"] == before["key_histogram"]
    c, cs = pa.key_histogram_plain(th, tf, K_, with_slots=True)
    assert torch.equal(g.cpu(), c) and torch.equal(gs.cpu(), cs)
    assert gs.dtype == torch.int32 and int(gs.max()) <= K_ - 1


@pytest.mark.cuda
def test_kernel_f_slim_matches_plain(cuda, port_index):
    idx = np.random.default_rng(8).integers(0, 5000, 900)
    res = {}
    for dev in (cuda, "cpu"):
        d = pa.device_index_from_host(port_index, dev)
        bs = _batches(port_index)
        s1 = _sides(d, bs["rand100"], dev)
        s2 = _sides(d, bs["rand76"], dev)
        res[str(dev)] = pa.gather_slim(torch.from_numpy(idx).to(dev), s1, s2)
    assert torch.equal(res[str(cuda)].cpu(), res["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["paired_l", "pseudobam", "single"])
def test_host_wave1_on_the_card_matches_the_cpu(cuda, port_index, tmp_path,
                                                monkeypatch, case):
    """run_quant with host wave 1 on: hw1 (-l), hw1pb (--pseudobam) and
    hw1s (single-end) on the card equal the CPU run, abundance.tsv and
    the BAM bytes; K and E with slots are launched on pairs, F's slim rows
    where no filter is on."""
    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.io.bam import read_bgzf
    from kallisto_tpu_torch.quant.pipeline import run_quant

    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "1")
    r1 = os.path.join(DATA, "reads_1.fastq.gz")
    r2 = os.path.join(DATA, "reads_2.fastq.gz")
    kw = {"paired_l": dict(files=[r1, r2], fld_mean=180, fld_sd=20),
          "pseudobam": dict(files=[r1, r2], pseudobam=True),
          "single": dict(files=[r1], single_end=True, fld_mean=180,
                         fld_sd=20)}[case]
    outs = {}
    for dev in (cuda, "cpu"):
        kernels.reset_launches()
        out = str(tmp_path / str(dev))
        res = run_quant(Options(output_dir=out, plaintext=True, **kw),
                        index=port_index, device=dev)
        route = {"paired_l": "hw1", "pseudobam": "hw1pb",
                 "single": "hw1s"}[case]
        assert res.timings[route] > 0
        files = ["abundance.tsv"]
        if case == "pseudobam":
            files.append("pseudoalignments.bam")
        outs[str(dev)] = [read_bgzf(os.path.join(out, f)) if f.endswith(
            ".bam") else open(os.path.join(out, f), "rb").read()
            for f in files]
        if dev == cuda:
            names = ["key_histogram" if case == "single"
                     else "key_histogram_slots"]
            if case != "single":
                names.append("pseudoalign_halffail")
            if case == "pseudobam":
                # no filter: the resolver reads new pair keys' slim rows;
                # kernel B's fragment lengths while the FLD is learned
                names += ["gather_slim", "read_keys"]
            for name in names:
                assert kernels.LAUNCHES[name] > 0, name
    assert outs[str(cuda)] == outs["cpu"]


@pytest.mark.cuda
def test_four_shards_match_one_device(cuda, port_index, tmp_path,
                                      monkeypatch):
    """quant over four shards (per read while the FLD is learned, then
    cmesh: kernels A, B and E per shard), and bus over four shards, equal
    one device; with one card all four shards sit on cuda:0, with four
    each has its own."""
    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.quant.pipeline import run_quant
    from kallisto_tpu_torch.sc.bus import run_bus

    monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", "1000")
    kw = dict(files=[os.path.join(DATA, "reads_1.fastq.gz"),
                     os.path.join(DATA, "reads_2.fastq.gz")], batch_size=1250)
    ref = run_quant(Options(**kw), index=port_index, device=cuda)
    kernels.reset_launches()
    got = run_quant(Options(n_devices=4, **kw), index=port_index,
                    device=cuda)
    assert got.timings["cmesh"] > 0 and got.timings["full"] > 0
    for name in ("pseudoalign_side", "read_keys", "key_histogram",
                 "gather_exemplars", "em_step_batch"):
        assert kernels.LAUNCHES[name] > 0, name
    for name in ("pseudoalign_anchor", "pseudoalign_turbo",
                 "pseudoalign_halffail"):
        assert kernels.LAUNCHES[name] == 0, name
    assert np.array_equal(got.counts, ref.counts)
    assert [s.tolist() for s in got.ec_sets] == \
        [s.tolist() for s in ref.ec_sets]
    assert np.array_equal(got.est_counts, ref.est_counts)
    assert np.array_equal(got.flens, ref.flens)
    sc = [os.path.join(DATA, f) for f in ("sc_reads_1.fastq.gz",
                                          "sc_reads_2.fastq.gz")]
    for n in (1, 4):
        run_bus(Options(files=sc, technology="10xv2", n_devices=n,
                        output_dir=str(tmp_path / f"bus{n}")),
                index=port_index, device=cuda)
    for name in ("output.bus", "matrix.ec"):
        with open(tmp_path / "bus1" / name, "rb") as f, \
                open(tmp_path / "bus4" / name, "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.cuda
def test_kernel_a_on_the_second_card(port_index):
    """Kernel A with its inputs on cuda:1 while cuda:0 is current equals
    its plain version (the wrapper launches on its inputs' device and
    that device's stream), and a quant sharded over both cards equals one
    card.  Needs two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.parallel.mesh import make_mesh
    from kallisto_tpu_torch.quant.pipeline import run_quant

    dev = torch.device("cuda:1")
    dc = pa.device_index_from_host(port_index, "cpu")
    with torch.cuda.device(0):
        dg = pa.device_index_from_host(port_index, dev)
        for pb in _batches(port_index).values():
            g = _sides(dg, pb, dev)
            torch.cuda.synchronize(dev)
            c = _sides(dc, pb, "cpu")
            for f in pa.SideResult._fields:
                a = getattr(g, f)
                assert a.device == dev
                assert torch.equal(a.cpu(), getattr(c, f)), f
    assert make_mesh(2, "cuda:0") == [torch.device("cuda", 0),
                                      torch.device("cuda", 1)]
    kw = dict(files=[os.path.join(DATA, "reads_1.fastq.gz")],
              single_end=True, fld_mean=180, fld_sd=20, batch_size=1250)
    ref = run_quant(Options(**kw), index=port_index, device="cuda:0")
    got = run_quant(Options(n_devices=2, **kw), index=port_index,
                    device="cuda:0")
    assert got.timings["cmesh"] > 0
    assert np.array_equal(got.counts, ref.counts)
    assert np.array_equal(got.est_counts, ref.est_counts)
