"""The port's long-read path (`quant --long`) against the JAX package, on
the CPU (kernel J's plain PyTorch version).

Kernel J's plain version must equal JAX's pseudoalign_long_packed field by
field on the bundled PacBio-style reads and on reads generated from the
bundled transcripts (chimeras, mosaics past 128 groups, random reads,
reads shorter than k, Ns), with the default budgets and with budgets small
enough that n_rows and n_groups count past them.  The host resolution
(modeECs, resolve_long_batch) and the long-read EM are held to JAX's
exactly, and `quant --long` gives JAX's bytes.  The reference's match_long
skips k-mers where both evaluate every one, so against the reference's
golden the tolerances of tests/test_longread.py hold.
"""

import os

import numpy as np
import pytest
import torch

import kallisto_tpu.ops.pseudoalign as jpa
from kallisto_tpu.common import Options as JOptions
from kallisto_tpu.index import build_index as jbuild
from kallisto_tpu.quant import em as jem
from kallisto_tpu.quant import longread as jlr
from kallisto_tpu.quant.ecmap import EcResolver as JEcResolver
from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
from kallisto_tpu_torch import cli
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index, save_index
from kallisto_tpu_torch.io.fastx import packed_single_batches
from kallisto_tpu_torch.ops import pseudoalign as tpa
from kallisto_tpu_torch.quant import em as tem
from kallisto_tpu_torch.quant import longread as tlr
from kallisto_tpu_torch.quant.ecmap import EcResolver
from kallisto_tpu_torch.quant.pipeline import run_quant
from kallisto_tpu_torch.utils.benchdata import generate_long_reads

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")
FASTA = os.path.join(DATA, "transcripts.fasta.gz")
LR = os.path.join(DATA, "reads_lr.fastq.gz")
K = 31


@pytest.fixture(scope="module")
def indexes():
    t = build_index([FASTA], k=K)
    return jbuild([FASTA], k=K), t, tpa.device_index_from_host(t, "cpu")


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lr") / "gen.fastq.gz")
    generate_long_reads(FASTA, path, 48, seed=8, novel_frac=0.1,
                        chimera_frac=0.2, mosaic_frac=0.2, short_frac=0.1,
                        n_rate=0.002)
    return path


def _batch(which, generated):
    return next(packed_single_batches(
        LR if which == "bundled_lr" else generated, 16384, K))


def _port_long(tdidx, pb, **kw):
    return tpa.pseudoalign_long_packed(
        tdidx, *tpa.upload_batch(pb, "cpu"), k=K, L=pb.Lp, **kw)


@pytest.mark.parametrize("budgets", [(64, 128), (2, 4)])
@pytest.mark.parametrize("layout", ["padded", "bucketed"])
@pytest.mark.parametrize("which", ["bundled_lr", "generated"])
def test_long_result_matches_jax(indexes, generated, monkeypatch, which,
                                 layout, budgets):
    jindex, tindex, _ = indexes
    if layout == "bucketed":
        monkeypatch.setattr(jpa, "_PADDED_BYTES_BUDGET", 0)
        monkeypatch.setattr(tpa, "_PADDED_BYTES_BUDGET", 0)
    jdidx = jpa.device_index_from_host(jindex)
    tdidx = tpa.device_index_from_host(tindex, "cpu")
    assert type(tdidx).__name__ == type(jdidx).__name__
    pb = _batch(which, generated)
    R, G = budgets
    rj = jpa.pseudoalign_long_packed(jdidx, pb.packed, pb.nmask, pb.lens,
                                     k=K, L=pb.Lp, max_rows=R, max_groups=G)
    rt = _port_long(tdidx, pb, max_rows=R, max_groups=G)
    assert bool(rt.has_hits.any())
    if budgets == (2, 4):
        assert bool(rt.overflow.any()) and bool(rt.g_overflow.any())
    if which == "generated":
        # reads shorter than k, and mosaics past the default group budget
        assert (pb.lens < K).any() and int(rt.n_groups.max()) > 128
    for f in jpa.LongResult._fields:
        a = np.asarray(getattr(rj, f))
        b = getattr(rt, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_long_result_counts_every_window(indexes, generated):
    """unmapped + hits = the valid windows, the padded tail of short reads
    excluded; groups hold -2 exactly past n_groups."""
    _, _, tdidx = indexes
    pb = _batch("generated", generated)
    r = _port_long(tdidx, pb)
    codes = tpa.unpack_codes(*tpa.upload_batch(pb, "cpu")[:2], pb.Lp)
    canon, _, valid = tpa.rolling_canonical_kmers(
        codes, torch.from_numpy(pb.lens), K)
    n_valid = valid.sum(dim=1)
    assert (n_valid[torch.from_numpy(pb.lens < K)] == 0).all()
    _, hit, _ = tpa.lookup_kmers(tdidx, canon, valid)
    assert torch.equal(r.unmapped + hit.sum(dim=1).to(torch.int32),
                       n_valid.to(torch.int32))
    G = r.groups.shape[1]
    past = torch.arange(G)[None, :] >= r.n_groups.clamp(max=G)[:, None]
    assert torch.equal(r.groups == -2, past)


@pytest.mark.parametrize("L,cap,spill", [
    (32, 2, 0), (536, 512, 0), (544, 1024, 1024), (5504, 8192, 8192),
    (140000, 262144, 262144)])
def test_kernel_j_row_list_plan(L, cap, spill):
    """Kernel J's row-list plan (ops/kernels.py long_plan): cap is the
    power of two >= W = L - k + 1, and a global spill of cap ints per
    block is planned exactly when cap passes the 512 entries that shared
    memory holds."""
    from kallisto_tpu_torch.ops import kernels

    assert kernels.long_plan(L, K) == (cap, spill)
    assert cap >= L - K + 1 > cap // 2


def test_kernel_j_plan_holds_every_listed_row(indexes, generated):
    """A read lists at most one row per group opener, and n_groups <= its
    windows <= cap; mosaic reads list more rows than the shared list
    holds, so their batch plans a spill."""
    from kallisto_tpu_torch.ops import kernels

    _, _, tdidx = indexes
    pb = _batch("generated", generated)
    r = _port_long(tdidx, pb)
    cap, spill = kernels.long_plan(pb.Lp, K)
    listed = ((r.groups >= 0) & (r.groups != -2)).sum(dim=1)
    assert int(r.n_groups.max()) <= pb.Lp - K + 1 <= cap
    assert (listed <= r.n_groups).all()
    if int(r.n_groups.max()) > kernels.LONG_SLIST:
        assert spill == cap


def test_mode_ecs_batch_matches_jax(indexes):
    jindex, tindex, _ = indexes
    resolver = EcResolver(tindex, mask_offlist=False)
    jresolver = JEcResolver(jindex, mask_offlist=False)
    rng = np.random.default_rng(21)
    B, G = 512, 24
    groups = np.full((B, G), -2, np.int32)
    n_groups = rng.integers(0, G + 1, B).astype(np.int32)
    for r in range(B):
        n = int(n_groups[r])
        seq = rng.integers(-1, tindex.num_ec_rows, n)
        for i in range(1, n):
            if rng.random() < 0.4:
                seq[i] = seq[i - 1]
        groups[r, :n] = seq
    row_card = np.diff(tindex.ec_ptr)
    got = tlr.mode_ecs_batch(groups, n_groups, row_card)
    np.testing.assert_array_equal(
        got, jlr.mode_ecs_batch(groups, n_groups, row_card))
    for r in range(0, B, 7):
        g = groups[r, : n_groups[r]]
        want = jlr.mode_ecs(g, jresolver)
        mine = tlr.mode_ecs(g, resolver)
        assert (want is None) == (mine is None)
        if want is not None:
            np.testing.assert_array_equal(mine, want)


@pytest.mark.parametrize("which", ["bundled_lr", "generated"])
def test_resolve_long_batch_matches_jax(indexes, generated, which):
    jindex, tindex, tdidx = indexes
    pb = _batch(which, generated)
    h = _port_long(tdidx, pb).to_numpy()
    mine = tlr.resolve_long_batch(h.rows, h.groups, h.n_groups,
                                  EcResolver(tindex, mask_offlist=False),
                                  tindex.num_onlist, {})
    want = jlr.resolve_long_batch(h.rows, h.groups, h.n_groups,
                                  JEcResolver(jindex, mask_offlist=False),
                                  jindex.num_onlist, {})
    assert len(mine) == len(want) == pb.n
    assert sum(s is None for s in mine) < pb.n
    for a, b in zip(mine, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_run_em_singletons_after_matches_jax():
    rng = np.random.default_rng(17)
    T = 200
    ec_sets = [np.array([t], np.int32) for t in range(0, T, 2)]
    for _ in range(300):
        n = int(rng.integers(2, 9))
        ec_sets.append(np.unique(rng.choice(T, n, replace=False))
                       .astype(np.int32))
    counts = rng.integers(0, 300, len(ec_sets)).astype(np.float64)
    eff = rng.uniform(100, 4000, T)
    tp = tem.build_em_problem(ec_sets, T)
    jp = jem.build_em_problem(ec_sets, T)
    mine = tem.run_em(tp, counts, eff, device="cpu", singletons_after=True)
    want = jem.run_em(jp, counts, eff, singletons_after=True)
    plain = tem.run_em(tp, counts, eff, device="cpu")
    assert mine.n_rounds == want.n_rounds
    np.testing.assert_array_equal(mine.alpha, np.asarray(want.alpha))
    assert not np.array_equal(mine.alpha, plain.alpha)
    # the singleton mass comes back after the loop
    assert abs(mine.alpha.sum() - counts.sum()) <= 1e-6 * counts.sum()


def _golden_abundance():
    rows = {}
    with open(os.path.join(GOLDEN, "quant_long", "abundance.tsv")) as f:
        next(f)
        for line in f:
            p = line.split("\t")
            rows[p[0]] = (float(p[2]), float(p[3]))
    return rows


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("platform", ["PacBio", "ONT", ""])
def test_quant_long_matches_jax_and_golden(indexes, tmp_path, platform):
    jindex, tindex, _ = indexes
    kw = dict(files=[LR], single_end=True, long_read=True, platform=platform,
              plaintext=True)
    res = run_quant(Options(output_dir=str(tmp_path / "port"), **kw),
                    index=tindex, device="cpu")
    jres = jrun_quant(JOptions(output_dir=str(tmp_path / "jax"), **kw),
                      index=jindex)
    for fname in ("abundance.tsv", "novel.fastq"):
        assert _read(tmp_path / "port" / fname) == \
            _read(tmp_path / "jax" / fname), fname
    assert res.num_pseudoaligned == jres.num_pseudoaligned
    t = res.timings
    assert t["long"] == 1 and t["full"] == t["turbo"] == 0
    headers = [ln for ln in _read(tmp_path / "port" / "novel.fastq")
               .splitlines() if ln.startswith("@")]
    assert 40 <= len(headers) <= 42
    assert set(headers) <= {"@novel_disjointIntersect",
                            "@novel_tooManyEmptyKmers"}
    assert t["novel"] <= len(headers)
    # the reference's golden (PacBio; an empty platform is PacBio too)
    assert abs(res.num_pseudoaligned - 399) <= 1
    if platform != "ONT":
        golden = _golden_abundance()
        dev = 0.0
        for name, eff, est in zip(res.target_names, res.eff_lens,
                                  res.est_counts):
            geff, gest = golden[name]
            assert eff == pytest.approx(geff)
            dev += abs(est - gest)
        assert dev <= 2.0 + 1e-6


def test_quant_long_threshold_and_batches_match_jax(indexes, tmp_path):
    """A lower novelty threshold and batches of 100 reads: JAX's bytes."""
    jindex, tindex, _ = indexes
    kw = dict(files=[LR], single_end=True, long_read=True, platform="PacBio",
              plaintext=True, threshold=0.3, batch_size=100)
    res = run_quant(Options(output_dir=str(tmp_path / "port"), **kw),
                    index=tindex, device="cpu")
    jrun_quant(JOptions(output_dir=str(tmp_path / "jax"), **kw), index=jindex)
    for fname in ("abundance.tsv", "novel.fastq"):
        assert _read(tmp_path / "port" / fname) == \
            _read(tmp_path / "jax" / fname), fname
    assert res.timings["long"] == 5


def test_cli_quant_long_on_the_cpu(indexes, tmp_path):
    _, tindex, _ = indexes
    idx = str(tmp_path / "idx.npz")
    save_index(tindex, idx)
    out = str(tmp_path / "cli")
    assert cli.main(["quant", "-i", idx, "-o", out, "--long", "-P", "PacBio",
                     "--plaintext", "--device", "cpu", LR]) == 0
    run_quant(Options(files=[LR], single_end=True, long_read=True,
                      platform="PacBio", plaintext=True,
                      output_dir=str(tmp_path / "api")),
              index=tindex, device="cpu")
    for fname in ("abundance.tsv", "novel.fastq"):
        assert _read(os.path.join(out, fname)) == \
            _read(tmp_path / "api" / fname), fname
