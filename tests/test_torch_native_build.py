"""The index build's native helpers (csrc/ktio.cpp through io/native.py)
against their numpy versions, and the whole build with them against the
port's numpy build and the JAX package's build, on the CPU.

kmer_scan, revcomp64 and u64_lookup run on at least 1 << 16 seeded
inputs (numpy's RNG) for every odd k in 3..31, with Ns.  The whole build
uses a simulated transcriptome large enough that the build reaches the
native helpers (their calls are counted), at threads 1 and 4; the numpy
build is the same build with the native threshold out of reach.  The
indexes must be equal array for array, and so must `index -t 4` through
the CLI against JAX's CLI.
"""

import dataclasses
import os

import numpy as np
import pytest

from kallisto_tpu import cli as jcli
from kallisto_tpu.index import build_index as jbuild
from kallisto_tpu.index.build import _KmerLookup as JLookup
from kallisto_tpu_torch import cli as tcli
from kallisto_tpu_torch.index import build as tbuild_mod
from kallisto_tpu_torch.index import build_index as tbuild
from kallisto_tpu_torch.index import kmers
from kallisto_tpu_torch.index.format import load_index
from kallisto_tpu_torch.io import native
from kallisto_tpu_torch.utils.simtx import generate_transcriptome

ODD_K = list(range(3, 32, 2))
N = (1 << 16) + 4099


def _numpy_only(monkeypatch):
    monkeypatch.setattr(kmers, "NATIVE_MIN", 1 << 62)


def _codes(seed, n=N, n_frac=0.01):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n).astype(np.uint8)
    c[rng.random(n) < n_frac] = 4
    return c


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("k", ODD_K)
def test_kmer_scan_matches_numpy(monkeypatch, k, threads):
    codes = _codes(k)
    canon, is_fw, valid = native.kmer_scan(codes, k, threads)
    _numpy_only(monkeypatch)
    km, v = kmers.pack_kmers(codes, k)
    c, fw = kmers.canonicalize(km, k)
    np.testing.assert_array_equal(valid, v)
    assert 0 < v.sum() < v.shape[0]
    np.testing.assert_array_equal(canon[v], c[v])
    np.testing.assert_array_equal(is_fw[v], fw[v])
    # the routed function takes the native scan from NATIVE_MIN codes on
    monkeypatch.setattr(kmers, "NATIVE_MIN", 1 << 16)
    r = kmers.scan_canonical(codes, k, threads)
    np.testing.assert_array_equal(r[0], canon)


@pytest.mark.parametrize("k", ODD_K)
def test_revcomp64_matches_numpy(monkeypatch, k):
    rng = np.random.default_rng(100 + k)
    x = rng.integers(0, 1 << (2 * k), N, dtype=np.uint64)
    got1 = native.revcomp64(x, k, 1)
    got4 = native.revcomp64(x, k, 4)
    _numpy_only(monkeypatch)
    want = kmers.revcomp_kmers(x, k)
    np.testing.assert_array_equal(got1, want)
    np.testing.assert_array_equal(got4, want)
    np.testing.assert_array_equal(kmers.revcomp_kmers(want, k), x)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("k", [3, 15, 31])
def test_u64_lookup_matches_numpy_and_jax(monkeypatch, k, threads):
    """_KmerLookup.find through u64_lookup: hits equal the numpy search's,
    and every output (misses clamped and mapped through the table's order)
    equals JAX's native lookup."""
    rng = np.random.default_rng(200 + k)
    space = 1 << (2 * k)
    if space <= 2 * N:  # half of all k-mers, so that misses exist
        keys = np.sort(rng.permutation(space)[: space // 2]).astype(np.uint64)
    else:
        keys = np.unique(rng.integers(0, space, N, dtype=np.uint64))
    q = np.where(rng.random(N) < 0.5, keys[rng.integers(0, keys.shape[0], N)],
                 rng.integers(0, space, N, dtype=np.uint64))
    lk = tbuild_mod._KmerLookup(keys, threads)
    calls = []
    real = native.u64_lookup
    monkeypatch.setattr(native, "u64_lookup",
                        lambda *a: calls.append(a[-1]) or real(*a))
    idx, hit = lk.find(q)
    assert calls == [threads]
    jidx, jhit = JLookup(keys).find(q)
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(idx, jidx)
    _numpy_only(monkeypatch)
    nidx, nhit = lk.find(q)
    np.testing.assert_array_equal(hit, nhit)
    assert 0 < hit.sum() < N
    np.testing.assert_array_equal(idx[hit], nidx[hit])
    np.testing.assert_array_equal(keys[idx[hit]], q[hit])


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tx") / "tx.fa.gz")
    generate_transcriptome(path, n_genes=60, seed=7)
    return path


@pytest.fixture(scope="module")
def numpy_index(fasta):
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(kmers, "NATIVE_MIN", 1 << 62)
        mp.setattr(native, "load", None)  # the numpy build loads nothing
        return tbuild([fasta])
    finally:
        mp.undo()


def _assert_same_index(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _count_native(monkeypatch):
    calls = {"kmer_scan": [], "u64_lookup": [], "revcomp64": []}
    for name, seen in calls.items():
        real = getattr(native, name)

        def counted(*a, real=real, seen=seen):
            seen.append(a[-1])
            return real(*a)

        monkeypatch.setattr(native, name, counted)
    return calls


@pytest.mark.parametrize("threads", [1, 4])
def test_build_with_native_helpers_matches_numpy_and_jax(
        monkeypatch, fasta, numpy_index, threads):
    calls = _count_native(monkeypatch)
    idx = tbuild([fasta], threads=threads)
    for name, seen in calls.items():
        assert seen and set(seen) == {threads}, (name, seen)
    assert idx.num_kmers >= (1 << 16)
    _assert_same_index(idx, numpy_index)
    _assert_same_index(idx, jbuild([fasta], threads=threads))


def test_build_threads_zero_is_min_8_cpus(monkeypatch, fasta, numpy_index):
    calls = _count_native(monkeypatch)
    _assert_same_index(tbuild([fasta], threads=0), numpy_index)
    want = min(8, os.cpu_count() or 1)
    assert {t for seen in calls.values() for t in seen} == {want}


def test_cli_index_threads_matches_jax(monkeypatch, tmp_path, fasta,
                                       capsys):
    """`index -t 4`: the port's CLI gives its build 4 threads, and the
    saved index equals JAX's `index -t 4`, array for array, with the same
    stderr."""
    calls = _count_native(monkeypatch)
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert tcli.main(["index", "-t", "4", "-i", tp, fasta]) == 0
    terr = capsys.readouterr().err
    assert jcli.main(["index", "-t", "4", "-i", jp, fasta]) == 0
    jerr = capsys.readouterr().err
    assert terr == jerr
    assert {t for seen in calls.values() for t in seen} == {4}
    _assert_same_index(load_index(tp), load_index(jp))


def test_cli_index_threads_help_matches_jax(capsys):
    helps = []
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit):
            main(["index", "--help"])
        out = capsys.readouterr().out
        i = out.index("  -t THREADS")
        helps.append(" ".join(out[i:out.index("  -T TMP")].split()))
    assert helps[0] == helps[1]
    assert "native build kernels" in helps[0]
