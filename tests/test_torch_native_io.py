"""The port's native FASTQ reader (kallisto_tpu_torch/csrc/ktio.cpp through
io/native.py) against the JAX package's native reader and the port's
Python reader, on the CPU.

Batch for batch it must equal JAX's kallisto_tpu.native.NativeFastqReader
(n, Lp, packed, nmask, lens, names); its rows, once batches are
concatenated, must equal the Python reader's (io/fastx.py single_batches
packed by _read_batch_to_packed).  Inputs: the bundled FASTQs that JAX's
tests/test_native_io.py reads, plus one of them as plain text, whole-file
gzip and BGZF, at batch sizes 1, 7 and 3,000 and with 1 and 4 threads.
The zlib-only build gives the same batches as the build with libdeflate.
`quant` reads through this reader, except under keep_quals (the BAM
replay), which keeps the Python reader as JAX does.
"""

import gzip
import os

import numpy as np
import pytest

from kallisto_tpu import native as jnative
from kallisto_tpu_torch.io import fastx
from kallisto_tpu_torch.io import native
from kallisto_tpu_torch.io.bam import BgzfWriter

DATA = os.path.join(os.path.dirname(__file__), "data")
K = 31
BUNDLED = ["reads_1.fastq.gz", "reads_2.fastq.gz", "sc_reads_1.fastq.gz"]
FORMS = ["plain", "gzip", "bgzf"]


def _write(path, text: bytes, form: str):
    if form == "plain":
        with open(path, "wb") as f:
            f.write(text)
    elif form == "gzip":
        with open(path, "wb") as f:
            f.write(gzip.compress(text))
    else:
        w = BgzfWriter(path)
        w.write(text)
        w.close()
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> path: the bundled files and reads_1 in the three forms."""
    d = tmp_path_factory.mktemp("fq")
    text = gzip.open(os.path.join(DATA, "reads_1.fastq.gz")).read()
    out = {f: os.path.join(DATA, f) for f in BUNDLED}
    for form in FORMS:
        out[form] = _write(str(d / f"r1.{form}"), text, form)
    return out


def _port(path, batch, threads=1, keep_names=True, zlib_only=False,
          min_len=K):
    r = native.NativeFastqReader(path, batch, pad_to=8, min_len=min_len,
                                 keep_names=keep_names, io_threads=threads,
                                 zlib_only=zlib_only)
    out = []
    try:
        while True:
            b = r.next_batch()
            if b is None:
                return out
            out.append(b)
    finally:
        r.close()


def _jax(path, batch, threads=1, keep_names=True, min_len=K):
    r = jnative.NativeFastqReader(path, batch, pad_to=8, min_len=min_len,
                                  keep_names=keep_names, io_threads=threads)
    out = []
    try:
        while True:
            b = r.next_batch()
            if b is None:
                return out
            out.append(b)
    finally:
        r.close()


def _assert_same_batches(got, want):
    assert [b.n for b in got] == [b.n for b in want]
    for g, w in zip(got, want):
        assert g.Lp == w.Lp
        assert g.packed.shape == w.packed.shape
        np.testing.assert_array_equal(g.packed, w.packed)
        np.testing.assert_array_equal(g.nmask, w.nmask)
        np.testing.assert_array_equal(g.lens, w.lens)
        assert g.lens.dtype == np.int32
        assert g.names == w.names


def _rows(batches):
    """Concatenated rows, padded to the widest batch (padding is N)."""
    Lp = max(b.Lp for b in batches)
    pk = np.concatenate([np.pad(b.packed, ((0, 0), (0, Lp // 4 - b.Lp // 4)))
                         for b in batches])
    nm = np.concatenate([np.pad(b.nmask, ((0, 0), (0, Lp // 8 - b.Lp // 8)),
                                constant_values=255) for b in batches])
    lens = np.concatenate([b.lens for b in batches])
    names = [n for b in batches for n in b.names]
    return pk, nm, lens, names


def _python(path, batch):
    return [fastx._read_batch_to_packed(rb, K)
            for rb in fastx.single_batches(path, batch, keep_names=True)]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("batch", [1, 7, 3000])
@pytest.mark.parametrize("name", BUNDLED + FORMS)
def test_native_reader_matches_jax_batch_for_batch(inputs, name, batch,
                                                   threads):
    path = inputs[name]
    _assert_same_batches(_port(path, batch, threads),
                         _jax(path, batch, threads))


@pytest.mark.parametrize("batch", [1, 7, 3000])
@pytest.mark.parametrize("name", BUNDLED + FORMS)
def test_native_reader_rows_match_python_reader(inputs, name, batch):
    path = inputs[name]
    got = _port(path, batch, threads=2)
    want = _python(path, batch)
    assert [b.n for b in got] == [b.n for b in want]
    for g, w in zip(_rows(got), _rows(want)):
        if isinstance(g, list):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("name", ["gzip", "bgzf"])
def test_zlib_only_build_gives_the_same_batches(inputs, name, threads):
    """The build without libdeflate (zlib inflates the BGZF blocks) loads
    its own library and reads the same batches."""
    assert native.load(zlib_only=True) is not native.load()
    path = inputs[name]
    _assert_same_batches(_port(path, 777, threads, zlib_only=True),
                         _port(path, 777, threads))


def test_native_strict_batching(inputs):
    """Every batch but the last holds batch_reads reads (JAX's
    test_native_strict_batching), with packed width Lp / 4."""
    nb = _port(inputs["reads_1.fastq.gz"], 3000, keep_names=False)
    assert [b.n for b in nb] == [3000, 3000, 3000, 1000]
    assert all(b.packed.shape[1] * 4 == b.Lp for b in nb)
    assert all(b.names is None for b in nb)


EDGE = (
    b"@r1 desc\nACGTNacgt\n+\nIIIIIIIII\n"
    b"@r2\tx\r\nNNNN\r\n+\r\n!!!!\r\n"
    b"@r3\nRYKMSWBDHVacgtuU.-\n+r3\nIIIIIIIIIIIIIIIIII\n"
    b"\n"
    b"@r4\n\n+\n\n"
    b"@r5\n" + b"ACGT" * 20 + b"\n+\n" + b"I" * 80 + b"\n"
    b"@r6\nACGT"  # no trailing newline
)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("threads", [1, 2])
def test_native_edge_cases(tmp_path, form, threads):
    """Ns, lowercase and IUPAC codes, CRLF line ends, a blank line between
    records, an empty read, reads shorter than min_len and no trailing
    newline: the same batches as JAX's native reader, and the codes
    expected."""
    path = _write(str(tmp_path / f"e.{form}"), EDGE, form)
    got = _port(path, 10, threads)
    _assert_same_batches(got, _jax(path, 10, threads))
    b = got[0]
    assert b.n == 6
    assert list(b.lens) == [9, 4, 18, 0, 80, 4]
    assert b.Lp == 80
    assert b.names == [b"r1", b"r2", b"r3", b"r4", b"r5", b"r6"]
    np.testing.assert_array_equal(b.row_codes(0)[:9],
                                  [0, 1, 2, 3, 4, 0, 1, 2, 3])
    assert (b.row_codes(1) == 4).all()
    np.testing.assert_array_equal(
        b.row_codes(2)[:18], [4] * 10 + [0, 1, 2, 3, 4, 4, 4, 4])
    assert (b.row_codes(3) == 4).all()
    assert (b.row_codes(5)[4:] == 4).all()
    # reads shorter than min_len: Lp is min_len rounded up to pad_to
    short = _port(path, 2, threads, min_len=K)
    assert [x.Lp for x in short] == [32, 32, 80]
    _assert_same_batches(short, _jax(path, 2, threads, min_len=K))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bad", ["header", "separator"])
def test_malformed_record_raises(tmp_path, form, bad):
    """A record without '@' or '+' raises ValueError naming the file and
    the record, like the Python reader; the batches before it come out."""
    good = b"".join(b"@r%d\nACGT\n+\nIIII\n" % i for i in range(5))
    rec = (b"r5-missing-at\nACGT\n+\nIIII\n" if bad == "header"
           else b"@r5\nACGT\n-\nIIII\n")
    path = _write(str(tmp_path / f"m.{form}"), good + rec + good, form)
    r = native.NativeFastqReader(path, 5, keep_names=True, io_threads=2)
    try:
        assert r.next_batch().n == 5
        with pytest.raises(ValueError, match=f"malformed FASTQ record in "
                           f".*record ~5: bad {bad} line"):
            r.next_batch()
    finally:
        r.close()
    with pytest.raises(ValueError, match=f"record ~5: bad {bad} line"):
        list(fastx.single_batches(path, 100))


def test_junk_before_header_is_accepted(tmp_path):
    """Non-alphanumeric junk before '@' passes, as in the Python reader."""
    path = _write(str(tmp_path / "j.fastq"),
                  b"@r0\nACGT\n+\nIIII\n\\@r1\nACGA\n+\nIIII\n", "plain")
    b = _port(path, 10)[0]
    assert b.n == 2 and list(b.lens) == [4, 4]
    w = _python(path, 10)[0]
    np.testing.assert_array_equal(b.packed[:, :w.packed.shape[1]], w.packed)


@pytest.mark.parametrize("short", ["part_of_a_batch", "a_whole_batch"])
def test_mismatched_pair_counts_raise(tmp_path, short):
    rec = b"@r\nACGTACGTAC\n+\nIIIIIIIIII\n"
    n2 = 7 if short == "part_of_a_batch" else 5
    p1 = _write(str(tmp_path / "a.fq.gz"), rec * 10, "gzip")
    p2 = _write(str(tmp_path / "b.fq.gz"), rec * n2, "bgzf")
    with pytest.raises(ValueError, match="different record counts"):
        list(fastx.packed_paired_batches(p1, p2, 5, K))


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.NativeFastqReader(str(tmp_path / "none.fq"), 10)


def test_long_reads_match_jax_and_python(tmp_path):
    """Reads of several kb (the --long batches): Lp follows the longest
    read of each batch."""
    rng = np.random.default_rng(11)
    recs = []
    for i in range(300):
        n = int(rng.integers(500, 6000))
        s = np.frombuffer(b"ACGTN", np.uint8)[
            np.where(rng.random(n) < 0.002, 4, rng.integers(0, 4, n))]
        recs.append(b"@lr%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * n))
    path = _write(str(tmp_path / "lr.fq.gz"), b"".join(recs), "bgzf")
    got = _port(path, 128, threads=2)
    _assert_same_batches(got, _jax(path, 128, threads=2))
    assert max(b.Lp for b in got) >= 5000
    want = _python(path, 128)
    for g, w in zip(_rows(got), _rows(want)):
        if isinstance(g, list):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


def test_paired_batches_match_jax(inputs):
    """packed_paired_batches (quant's reader) against JAX's, which reads
    through JAX's native reader."""
    from kallisto_tpu.io.fastx import packed_paired_batches as jpaired

    r1 = inputs["reads_1.fastq.gz"]
    r2 = os.path.join(DATA, "reads_2.fastq.gz")
    got = list(fastx.packed_paired_batches(r1, r2, 4096, K, keep_names=True))
    want = list(jpaired(r1, r2, 4096, K, keep_names=True))
    assert len(got) == len(want) == 3
    for side in (0, 1):
        _assert_same_batches([g[side] for g in got], [w[side] for w in want])


def test_quant_reads_through_the_native_reader(monkeypatch):
    """packed_*_batches open NativeFastqReader, with JAX's 4 I/O threads;
    keep_quals (the BAM replay) reads with the Python reader, with the
    same packed rows."""
    opened = []

    class Counting(native.NativeFastqReader):
        def __init__(self, path, *a, **kw):
            super().__init__(path, *a, **kw)
            opened.append((path, self._threads))

    monkeypatch.setattr(native, "NativeFastqReader", Counting)
    r1 = os.path.join(DATA, "reads_1.fastq.gz")
    r2 = os.path.join(DATA, "reads_2.fastq.gz")
    got = list(fastx.packed_paired_batches(r1, r2, 4096, K))
    assert opened == [(r1, 4), (r2, 4)]
    opened.clear()
    quals = list(fastx.packed_paired_batches(r1, r2, 4096, K,
                                             keep_names=True,
                                             keep_quals=True))
    assert opened == []
    assert all(len(b1.quals) == b1.n for b1, _ in quals)
    for (g1, g2), (q1, q2) in zip(got, quals):
        np.testing.assert_array_equal(g1.packed, q1.packed)
        np.testing.assert_array_equal(g2.nmask, q2.nmask)
