"""The covered-interval core's premise, on the CPU.

Kernel K's failed mates and A on codes' wave 2 (csrc/pseudoalign.cu
kt_skip_anchors + kt_skip_finish, and kt_core_skip) look up a read's anchors first -- n_anchors_for(len, k) of
them, at most k apart -- and then only the windows of the intervals that
no pair of agreeing anchors covers.  Two adjacent anchors that hit one
unitig on one strand at positions exactly their distance apart prove that
the read between them is that stretch of the unitig, so every window
between them hits it, and its EC rows are the block ECs of the blocks
between theirs (read from block_ec8 while the range lies in two of its
8-wide rows; a wider range leaves the interval open).  That is exact only
if the fields it gives equal the dense core's in every bit.
ops/anchor.py skip_core_plain is the mechanism in plain PyTorch (its
probed-window mask is what the card tests hold the kernels' counts
against) and codes_waves_plain A on codes' two waves on top of it: here
both must equal _pseudoalign_core, and JAX's pseudoalign_batch; and kernel
K's composition (the failed mates through skip_core_plain, the verified
mates from their summaries) must equal JAX's half-fail step, in both
device index layouts, on the bundled index, a small simulated one (one
block per unitig) and a mosaic one (a unitig with a block per k-mer
position), with reads made from a numpy seed: error-free reads of both
strands, one substitution at each position, two substitutions, reads
across unitig boundaries, an N inside an interval and at an anchor,
lengths k, k + 1, ragged below L and past it, 0 and below k, random junk
(hitless reads) and codes above 4, at L = 100 and at L = 40 (R < 16).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
import kallisto_tpu.ops.turbo as jturbo
from kallisto_tpu.index import build_index as jbuild
from kallisto_tpu_torch.index import build_index as tbuild
from kallisto_tpu_torch.io.fastx import ReadBatch, _read_batch_to_packed
from kallisto_tpu_torch.ops import anchor as tanchor
from kallisto_tpu_torch.ops import pseudoalign as tpa
from kallisto_tpu_torch.ops import turbo as tturbo
from kallisto_tpu_torch.quant import pipeline as tpipe
from kallisto_tpu_torch.utils.simtx import generate_transcriptome

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
K = 31
# the mosaic transcriptome: a random sequence S, and S's prefixes of K + i
# bases for i < MOSAIC_PREFIXES, so that S's k-mer positions below
# MOSAIC_PREFIXES each lie in a block of their own
MOSAIC_LEN, MOSAIC_PREFIXES = 400, 60


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """name -> (JAX index, port index, S or None): the bundled
    transcriptome, a 40-gene simulated one and the mosaic one."""
    tmp = tmp_path_factory.mktemp("skip")
    sim = str(tmp / "simtx.fasta.gz")
    generate_transcriptome(sim, n_genes=40, seed=3)
    rng = np.random.default_rng(0)
    S = "".join("ACGT"[i] for i in rng.integers(0, 4, MOSAIC_LEN))
    mosaic = str(tmp / "mosaic.fa")
    with open(mosaic, "w") as f:
        f.write(f">S\n{S}\n")
        for i in range(MOSAIC_PREFIXES):
            f.write(f">P{i}\n{S[:K + i]}\n")
    out = {}
    for name, fa in (("bundled", os.path.join(DATA, "transcripts.fasta.gz")),
                     ("simtx", sim), ("mosaic", mosaic)):
        out[name] = (jbuild([fa], k=K), tbuild([fa], k=K),
                     S if name == "mosaic" else None)
    return out


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


def _anchors(L):
    """The anchor columns of a read of L bases."""
    wl = L - K
    na = tanchor.n_anchors_for(L, K)
    return [wl * j // (na - 1) for j in range(na)]


def _draw(seq, off, n, L, rng):
    """n error-free reads of L bases from inside the sequences [off[i],
    off[i + 1]) of seq that are at least L long, half reverse-complemented."""
    ln = np.diff(off)
    ok = np.flatnonzero(ln >= L)
    t = ok[rng.integers(0, ok.shape[0], n)]
    st = off[t] + (rng.random(n) * (ln[t] - L + 1)).astype(np.int64)
    codes = seq[st[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    return codes


def _cases(tindex, L, seed, uniform=False):
    """Reads of every case as unpacked codes [n, L], lens [n] and a kind
    per read: error-free reads from inside unitigs ("clean"); the same
    with one substitution at column p, one read for each p < L ("subst");
    two substitutions ("subst2"); reads from transcripts, across unitig
    boundaries, error-free or with 1 % substitutions ("tx"); an N at an
    anchor column or between two ("n"); random junk ("junk"); and unless
    uniform, lengths k, k + 1, ragged below L, past L, 0 and below k
    ("len") and codes above 4 ("code7")."""
    rng = np.random.default_rng(seed)
    useq, uoff = tindex.unitig_seq, tindex.unitig_seq_off
    parts, kinds = [], []

    def add(kind, c):
        parts.append(c)
        kinds.extend([kind] * c.shape[0])

    add("clean", _draw(useq, uoff, 60, L, rng))
    c = _draw(useq, uoff, L, L, rng)
    c[np.arange(L), np.arange(L)] = (c[np.arange(L), np.arange(L)] + 1) % 4
    add("subst", c)
    c = _draw(useq, uoff, 150, L, rng)
    for _ in range(2):
        p = rng.integers(0, L, c.shape[0])
        c[np.arange(c.shape[0]), p] = (c[np.arange(c.shape[0]), p] + 1) % 4
    add("subst2", c)
    c = _draw(tindex.target_seq, tindex.target_seq_off, 300, L, rng)
    e = (rng.random(c.shape[0]) < 0.6)[:, None] & (rng.random(c.shape) < 0.01)
    c[e] = (c[e] + 1) % 4
    add("tx", c)
    cols = sorted(set(_anchors(L)) | {a + K // 2 for a in _anchors(L)[:-1]})
    c = _draw(useq, uoff, 4 * len(cols), L, rng)
    c[np.arange(c.shape[0]), np.tile(cols, 4)] = 4
    add("n", c)
    add("junk", rng.integers(0, 4, (40, L)).astype(np.uint8))
    if not uniform:
        add("len", _draw(useq, uoff, 120, L, rng))
        c = _draw(useq, uoff, 40, L, rng)
        c[rng.random(c.shape) < 0.01] = 7
        add("code7", c)
    codes = np.ascontiguousarray(np.concatenate(parts))
    kinds = np.array(kinds)
    lens = np.full(codes.shape[0], L, np.int32)
    sel = np.flatnonzero(kinds == "len")
    if sel.size:
        m = sel.shape[0] // 6
        lens[sel[:m]] = K
        lens[sel[m:2 * m]] = K + 1
        lens[sel[2 * m:3 * m]] = rng.integers(K + 2, L, m)
        lens[sel[3 * m:4 * m]] = L + 3
        lens[sel[4 * m:5 * m]] = 0
        lens[sel[5 * m:]] = rng.integers(1, K, sel.shape[0] - 5 * m)
    return codes, lens, kinds


def _assert_equal(got, want, what):
    for f in tpa.SideResult._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {f}"
        else:
            assert a.numpy().dtype == np.asarray(b).dtype, f"{what}: {f}"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{what}: {f}")


@pytest.mark.parametrize("L", [100, 40])
@pytest.mark.parametrize("layout", ["padded", "bucketed"])
@pytest.mark.parametrize("which", ["bundled", "simtx", "mosaic"])
def test_skip_core_equals_dense_and_jax(indexes, monkeypatch, which, layout,
                                        L):
    """skip_core_plain and codes_waves_plain equal _pseudoalign_core and
    JAX's pseudoalign_batch in every field; the windows looked up are the
    anchors, window 0 and valid windows only, and some windows are
    skipped."""
    jindex, tindex, _ = indexes[which]
    jdidx, tdidx = _layout(jindex, tindex, monkeypatch, layout)
    codes, lens, kinds = _cases(tindex, L, seed=L + 11 * len(which))
    c, ln = torch.from_numpy(codes), torch.from_numpy(lens)
    skip, probed = tanchor.skip_core_plain(tdidx, c, ln, K)
    dense = tpa._pseudoalign_core(tdidx, c, ln, K, 16)
    waves, fail, wprobed = tanchor.codes_waves_plain(tdidx, c, ln, K)
    jx = jpa.pseudoalign_batch(jdidx, jnp.asarray(codes), jnp.asarray(lens),
                               k=K)
    _assert_equal(skip, dense, "skip_core_plain")
    _assert_equal(waves, dense, "codes_waves_plain")
    _assert_equal(dense, jx, "JAX pseudoalign_batch")
    assert dense.rows.shape[1] == min(16, L - K + 1)

    _, _, valid = tpa.rolling_canonical_kmers(c, ln, K)
    assert bool(probed[:, 0].all())
    assert not bool((probed[:, 1:] & ~valid[:, 1:]).any())
    full = torch.from_numpy(lens >= L)
    cols = torch.tensor(_anchors(L))
    assert bool((probed[:, cols] | ~valid[:, cols])[full].all())
    assert int(probed.sum()) < int(valid.sum())
    # wave 2 looks up only its own reads' windows, as the core on them
    assert torch.equal(wprobed[~fail], torch.zeros_like(wprobed[~fail]))
    assert torch.equal(wprobed[fail],
                       tanchor.skip_core_plain(tdidx, c[fail], ln[fail],
                                               K)[1])
    # error-free reads from inside one-block unitigs look up their anchors
    # alone; wave 1 verifies them
    if which == "simtx":
        clean = torch.from_numpy(kinds == "clean")
        assert bool((probed[clean].sum(dim=1) == len(cols)).all())
        assert not bool(fail[clean].any())
    assert bool(dense.has_hits.any()) and not bool(dense.has_hits.all())


@pytest.mark.parametrize("layout", ["padded", "bucketed"])
def test_probes_follow_the_substitution(indexes, monkeypatch, layout):
    """One substitution at column p kills the anchors whose windows hold p
    and opens the intervals that touch them: the windows looked up are the
    anchors and those intervals' windows, for every p (reads from inside
    the one-block unitigs of the simulated index)."""
    jindex, tindex, _ = indexes["simtx"]
    _, tdidx = _layout(jindex, tindex, monkeypatch, layout)
    L = 100
    codes, lens, kinds = _cases(tindex, L, seed=5)
    sel = np.flatnonzero(kinds == "subst")
    c, ln = torch.from_numpy(codes[sel]), torch.from_numpy(lens[sel])
    skip, probed = tanchor.skip_core_plain(tdidx, c, ln, K)
    _assert_equal(skip, tpa._pseudoalign_core(tdidx, c, ln, K, 16), "subst")
    a = _anchors(L)
    want = []
    for p in range(L):
        dead = [w <= p < w + K for w in a]
        want.append(len(a) + sum(a[j + 1] - a[j] - 1
                                 for j in range(len(a) - 1)
                                 if dead[j] or dead[j + 1]))
    assert probed.sum(dim=1).tolist() == want
    assert min(want) < max(want) == L - K + 1


@pytest.mark.parametrize("layout", ["padded", "bucketed"])
def test_block_range_past_two_rows_is_open(indexes, monkeypatch, layout):
    """On the mosaic index (one unitig, a block per k-mer position below
    MOSAIC_PREFIXES): an interval whose anchors' blocks lie in more than
    two 8-wide rows of block_ec8 is open (every window between them looked
    up); one whose blocks lie in two rows is covered, and its rows come
    from the blocks between its anchors'; one block is covered by its
    anchors alone.  Every field equals the dense core's."""
    jindex, tindex, S = indexes["mosaic"]
    _, tdidx = _layout(jindex, tindex, monkeypatch, layout)
    L = 100
    a = _anchors(L)
    seq = np.array(["ACGT".index(ch) for ch in S], np.uint8)
    starts = [0, 48, 200]
    fw = np.stack([seq[s:s + L] for s in starts])
    codes = np.ascontiguousarray(np.concatenate([fw, (3 - fw)[:, ::-1]]))
    lens = np.full(codes.shape[0], L, np.int32)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lens)
    skip, probed = tanchor.skip_core_plain(tdidx, c, ln, K)
    dense = tpa._pseudoalign_core(tdidx, c, ln, K, 16)
    _assert_equal(skip, dense, "mosaic")
    n = probed.sum(dim=1).tolist()
    # from 0: blocks 0..23, 23..46 and 46..60 each past two rows
    assert n[0] == n[3] == L - K + 1
    # from 48: blocks 48..60 in two rows (11 between), then one block
    assert n[1] == n[4] == len(a)
    assert dense.n_rows[1] == dense.n_rows[4] == 13
    # from 200: one block
    assert n[2] == n[5] == len(a) and dense.n_rows[2] == 1


def _half_slice(tindex, L, seed):
    """A half-fail wave-2 slice as quant/pipeline.py builds it, from the
    uniform-length cases: the failed mates' packed codes, the verified
    mates' summaries (random blocks, spans, positions and strands), sidev
    and aux, padded past the real pairs; and the packed length."""
    codes, lens, _ = _cases(tindex, L, seed, uniform=True)
    pb = _read_batch_to_packed(ReadBatch(codes=codes, lens=lens), K)
    rng = np.random.default_rng(seed)
    n = pb.n
    Bp = n + 37
    nb = tindex.block_ec.shape[0]
    blo = rng.integers(0, max(nb - 16, 1), n)
    meta = ((rng.integers(0, 5000, n) << 5) | (rng.integers(0, 9, n) << 1)
            | rng.integers(0, 2, n))
    vsum = np.stack([blo, meta], axis=1).astype(np.int32)
    sidev = rng.integers(1, 3, n).astype(np.int32)
    exc = tpipe._rows_exceptions([(pb.nmask, pb.lens)], Bp, pb.Lp)
    assert exc.size > 0
    return (tpipe._pad_rows(pb.packed, Bp), tpipe._pad_rows(vsum, Bp),
            tpipe._pad_rows(sidev, Bp), tturbo.make_aux(n, L, exc), pb.Lp)


@pytest.mark.parametrize("L,max_rows", [(100, 16), (100, 32), (40, 16)])
@pytest.mark.parametrize("layout", ["padded", "bucketed"])
def test_halffail_skip_equals_jax(indexes, monkeypatch, layout, L, max_rows):
    """Kernel K's composition with the covered-interval core (the failed
    mates through skip_core_plain on their decoded codes, the verified
    mates from their summaries with the same row width) equals JAX's
    half-fail step (pseudoalign_pair_halffail: halffail_core) and the
    port's plain halffail_core on both mates in every field, padding pairs
    included."""
    jindex, tindex, _ = indexes["bundled"]
    jdidx, tdidx = _layout(jindex, tindex, monkeypatch, layout)
    pkf, vsum, sidev, aux, Lp = _half_slice(tindex, L, seed=L + max_rows)
    j1, j2, _ = jturbo.pseudoalign_pair_halffail(
        jdidx, pkf, vsum, sidev, aux, k=K, L=Lp, max_rows=max_rows,
        max_keys=pkf.shape[0] + 1, rl=L)
    t = [torch.from_numpy(x) for x in (pkf, vsum, sidev, aux)]
    codes, lens_v = tturbo.codes_and_lens_plain((t[0],), t[3], None, Lp, L)
    rf, probed = tanchor.skip_core_plain(tdidx, codes, lens_v, K, max_rows)
    rv = tturbo.verified_side_plain(tdidx, t[1], int(rf.rows.shape[1]),
                                    lens_v, K)
    m1 = t[2] == 1

    def sel(a, b):
        return torch.where(m1[:, None] if a.dim() == 2 else m1, a, b)

    s1 = tpa.SideResult(*(sel(f, v) for f, v in zip(rf, rv)))
    s2 = tpa.SideResult(*(sel(v, f) for f, v in zip(rf, rv)))
    p1, p2 = tturbo.halffail_core(tdidx, *t, K, Lp, max_rows, L)
    _assert_equal(s1, j1, "mate 1 against JAX")
    _assert_equal(s2, j2, "mate 2 against JAX")
    _assert_equal(s1, p1, "mate 1 against halffail_core")
    _assert_equal(s2, p2, "mate 2 against halffail_core")
    # padding pairs look up window 0 alone
    n = int(aux[1])
    assert bool((probed[n:].sum(dim=1) == 1).all())
    assert int(probed[:n].sum()) < int((lens_v[:n] > 0).sum()) * (L - K + 1)
