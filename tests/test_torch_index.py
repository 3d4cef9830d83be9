"""The port's index build and .npz format against the JAX package's.

The port keeps its own numpy copy of the index builder; on the bundled
transcriptome it must produce the same arrays, and an .npz written by
either package must load in the other.
"""

import os

import numpy as np
import pytest

import kallisto_tpu.index as jidx
import kallisto_tpu_torch.index as tidx

DATA = os.path.join(os.path.dirname(__file__), "data")
FASTA = os.path.join(DATA, "transcripts.fasta.gz")


@pytest.fixture(scope="module")
def both():
    return jidx.build_index([FASTA], k=31), tidx.build_index([FASTA], k=31)


def _assert_same(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def test_build_matches_jax(both):
    _assert_same(*both)


@pytest.mark.parametrize("k", [21, 25])
def test_build_matches_jax_other_k(k):
    _assert_same(jidx.build_index([FASTA], k=k), tidx.build_index([FASTA], k=k))


def test_build_with_dlist_matches_jax():
    dl = [os.path.join(DATA, "dlist.fasta")]
    _assert_same(
        jidx.build_index([FASTA], k=31, dlist_paths=dl),
        tidx.build_index([FASTA], k=31, dlist_paths=dl),
    )


def test_npz_written_by_jax_loads_in_port(both, tmp_path):
    j, t = both
    p = str(tmp_path / "jax.npz")
    jidx.save_index(j, p)
    _assert_same(t, tidx.load_index(p))


def test_npz_written_by_port_loads_in_jax(both, tmp_path):
    j, t = both
    p = str(tmp_path / "port.npz")
    tidx.save_index(t, p)
    _assert_same(j, jidx.load_index(p))


def test_index_from_numpy_takes_jax_fields(both):
    j, t = both
    arrays = {f: getattr(j, f) for f in j.__dataclass_fields__}
    _assert_same(t, tidx.index_from_numpy(arrays))


def test_index_from_numpy_rejects_other_format(both):
    j, _ = both
    arrays = {f: getattr(j, f) for f in j.__dataclass_fields__}
    arrays["format_version"] = 99
    with pytest.raises(ValueError):
        tidx.index_from_numpy(arrays)
