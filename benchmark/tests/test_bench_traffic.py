"""The benchmark's generators: a seed gives the same bytes twice, another
seed other bytes, and the FASTQ reads back as the codes written."""

import gzip
import hashlib

import numpy as np
import pytest

from kbench import deploy, traffic
from reference import seqio


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_transcriptome_is_fixed_by_its_seed(tmp_path):
    a, b, c = (str(tmp_path / f"{x}.fa.gz") for x in "abc")
    assert traffic.transcriptome(a, 30, 5, 8, 250, 42) == \
        traffic.transcriptome(b, 30, 5, 8, 250, 42)
    traffic.transcriptome(c, 30, 5, 8, 250, 43)
    assert _digest(a) == _digest(b) != _digest(c)


def _reads(tmp_path, seed, tag):
    fa = str(tmp_path / "tx.fa.gz")
    traffic.transcriptome(fa, 30, 5, 8, 250, 42)
    pool = deploy.read_pool(fa)
    rng = traffic.rng_for(seed, 1)
    r1, r2 = traffic.paired(pool, rng, 5000, 100, 180, 20, 0.005)
    p1, p2 = (str(tmp_path / f"{tag}_{m}.fq.gz") for m in (1, 2))
    traffic.write_fastq(p1, r1, b"a")
    traffic.write_fastq(p2, r2, b"b")
    return (p1, p2), (r1, r2)


def test_reads_are_fixed_by_the_seed(tmp_path):
    big = 2**31 + 977  # seeds may pass 32 signed bits
    (a1, a2), _ = _reads(tmp_path, big, "a")
    (b1, b2), _ = _reads(tmp_path, big, "b")
    (c1, _), _ = _reads(tmp_path, big + 1, "c")
    assert _digest(a1) == _digest(b1) and _digest(a2) == _digest(b2)
    assert _digest(a1) != _digest(c1)


def test_fastq_reads_back(tmp_path):
    (p1, p2), (r1, r2) = _reads(tmp_path, 7, "x")
    for p, r in ((p1, r1), (p2, r2)):
        codes, lens = seqio.read_fastq(p)
        assert (lens == r.shape[1]).all()
        np.testing.assert_array_equal(codes, r)
        with gzip.open(p, "rb") as f:  # BGZF is plain gzip to a reader
            assert f.read().count(b"\n") == 4 * r.shape[0]


def test_barcodes_and_sense_reads(tmp_path):
    fa = str(tmp_path / "tx.fa.gz")
    traffic.transcriptome(fa, 30, 5, 8, 250, 42)
    pool = deploy.read_pool(fa)
    bcs = traffic.barcode_pool(64, 16, 11)
    r1 = traffic.barcode_reads(bcs, traffic.rng_for(3, 1), 1000, 10)
    assert r1.shape == (1000, 26)
    assert {bytes(x) for x in r1[:, :16]} <= {bytes(x) for x in bcs}
    s = traffic.sense(pool, traffic.rng_for(3, 2), 1000, 98, 180, 20, 0.0)
    # error-free sense reads are substrings of the transcripts
    text = pool.codes.tobytes()
    assert all(bytes(x) in text for x in s[:50])


def _pool(tmp_path):
    fa = str(tmp_path / "tx.fa.gz")
    traffic.transcriptome(fa, 30, 5, 8, 250, 42)
    return deploy.read_pool(fa)


def test_three_prime_fragments_end_at_the_transcripts_end(tmp_path):
    pool = _pool(tmp_path)
    base, flen = traffic.fragments(pool, traffic.rng_for(5, 1), 2000, 98,
                                   300, 80, positions={"model": "three_prime"})
    tx = np.searchsorted(pool.off, base, side="right") - 1
    np.testing.assert_array_equal(base + flen, pool.off[tx + 1])
    assert (flen >= 98).all()


def test_lognormal_expression_is_fixed_by_its_own_seed(tmp_path):
    pool = _pool(tmp_path)
    expr = {"model": "lognormal", "sigma": 2.0, "seed": 3}
    a = traffic.abundances(pool.lens.shape[0], expr)
    assert np.array_equal(a, traffic.abundances(pool.lens.shape[0], expr))
    assert a.max() / a.min() > 50  # skewed, unlike the uniform model
    base, _ = traffic.fragments(pool, traffic.rng_for(5, 1), 20000, 100,
                                180, 20, expression=expr)
    tx = np.searchsorted(pool.off, base, side="right") - 1
    hits = np.bincount(tx, minlength=pool.lens.shape[0])
    top = np.argmax(a * pool.lens)
    assert hits[top] == hits.max()


def test_uniform_models_are_the_default(tmp_path):
    """Naming the uniform models gives the bytes of naming none."""
    pool = _pool(tmp_path)
    a = traffic.paired(pool, traffic.rng_for(9, 1), 500, 100, 180, 20, 0.005)
    b = traffic.paired(pool, traffic.rng_for(9, 1), 500, 100, 180, 20, 0.005,
                       {"model": "uniform"}, {"model": "uniform"})
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("key,model", (("expression", "zipf"),
                                       ("positions", "five_prime")))
def test_an_unknown_model_is_refused(tmp_path, key, model):
    pool = _pool(tmp_path)
    with pytest.raises(ValueError, match=model):
        traffic.fragments(pool, traffic.rng_for(1, 1), 10, 100, 180, 20,
                          **{key: {"model": model}})
