"""The native resolver of first-seen keys (quant/ecresolve.py over
csrc/ecresolve.cpp) against the Python resolver it stands in for:
EcResolver._resolve_key + ec_id_for key by key, on the per-read route
(resolve_batch_hashed) and the compact routes (process_compact_parts),
with EC numbering and counts equal over several batches; and the
`ec_native_keys` counter of a run."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.quant import ecmap
from kallisto_tpu_torch.quant.ecmap import INT32_MAX, EcResolver
from kallisto_tpu_torch.quant.pipeline import run_quant

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

GENES, PER_GENE, ROWS_PER_GENE = 400, 8, 12


def _index(n_offlist: int = 0, seed: int = 0):
    """A synthetic EC-row CSR: each gene's rows are random subsets of its
    PER_GENE targets, so rows of one gene mostly intersect and rows of two
    genes never do; the last n_offlist targets are off-list."""
    rng = np.random.default_rng(seed)
    rows = []
    for g in range(GENES):
        for _ in range(ROWS_PER_GENE):
            n = int(rng.integers(1, PER_GENE + 1))
            rows.append(np.sort(rng.choice(PER_GENE, n, replace=False))
                        + g * PER_GENE)
    ptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([r.shape[0] for r in rows], out=ptr[1:])
    T = GENES * PER_GENE
    return SimpleNamespace(
        ec_ptr=ptr, ec_tx=np.concatenate(rows).astype(np.int32),
        num_onlist=T - n_offlist, num_trans=T,
        target_names=[f"t{i}" for i in range(T)])


def _keys(rng, n: int, R: int, paired: bool, kinds=("any",)):
    """n keys in the exemplar layout (rows1, rows2 if paired, flags, a tail
    column the native call does not read).  Kinds: `any` (a mate holds
    0-3 rows of one gene, now and then one of another), `one_mate` (only
    one mate hit), `empty` (no rows; hit bits random), `veto` (each mate's
    rows from another gene, both hit), `padded` (rows with padding between
    them)."""
    W = 2 * R + 2 if paired else R + 2
    keys = np.full((n, W), INT32_MAX, np.int32)
    keys[:, -1] = rng.integers(0, 1 << 20, n)
    nm = 2 if paired else 1
    for i in range(n):
        kind = kinds[int(rng.integers(len(kinds)))]
        g = int(rng.integers(GENES))
        flags = 0
        for m in range(nm):
            if kind == "empty":
                c = 0
            elif kind == "one_mate":
                c = int(rng.integers(1, 4)) if m == i % nm else 0
            else:
                c = int(rng.integers(0, 4)) if kind == "any" else \
                    int(rng.integers(1, 4))
            gm = g + m if kind == "veto" else g
            rows = gm % GENES * ROWS_PER_GENE + rng.choice(
                ROWS_PER_GENE, c, replace=False)
            if kind == "any" and c and rng.random() < 0.1:
                rows[0] = int(rng.integers(GENES * ROWS_PER_GENE))
            rows = np.unique(rows)
            if kind == "padded" and rows.shape[0]:
                slots = np.sort(rng.choice(R, rows.shape[0], replace=False))
                keys[i, m * R + slots] = rows
            else:
                keys[i, m * R : m * R + rows.shape[0]] = rows
            if c or (kind == "empty" and rng.random() < 0.5):
                flags |= 1 << m
        keys[i, nm * R] = flags
    return keys


def _python_ecs(res: EcResolver, keys, R: int, paired: bool):
    return [-1 if u is None else res.ec_id_for(u)
            for u in (res._resolve_key(k, R, paired, False) for k in keys)]


def _sets(res: EcResolver):
    return [s.tolist() for s in res.ec_sets]


KEY_CASES = {
    "paired_r16": (True, 16, ("any",), 0),
    "paired_r32": (True, 32, ("any",), 0),
    "single_r16": (False, 16, ("any",), 0),
    "single_r32": (False, 32, ("any",), 0),
    "one_mate_hit": (True, 16, ("one_mate",), 0),
    "both_mates_empty": (True, 16, ("empty", "any"), 0),
    "veto": (True, 16, ("veto", "any"), 0),
    "padding": (True, 32, ("padded",), 0),
    "offlist_paired": (True, 16, ("any", "one_mate"), 300),
    "offlist_single": (False, 16, ("any",), 300),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_native_keys_equal_the_python_resolver(case):
    """Key by key: the native call's set (through ec_id_for, in key order)
    is _resolve_key's, and the EC table comes out the same."""
    paired, R, kinds, n_off = KEY_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    index = _index(n_off)
    keys = _keys(rng, 3000, R, paired, kinds)
    py, nat = EcResolver(index), EcResolver(index)
    want = _python_ecs(py, keys, R, paired)
    key_set, sets = nat._native_sets(False).resolve(keys, R, paired)
    got = [-1 if s < 0 else nat.ec_id_for(sets[s]) for s in key_set]
    assert got == want
    assert _sets(nat) == _sets(py)
    assert 0 < sum(e < 0 for e in want) < len(want)
    if n_off:
        assert all(s.max() < index.num_onlist for s in nat.ec_sets)
    # the distinct sets are distinct and in first-key order
    firsts = [int(np.flatnonzero(key_set == j)[0]) for j in range(len(sets))]
    assert firsts == sorted(firsts)
    assert len({tuple(s.tolist()) for s in sets}) == len(sets)


def _hashes(tag: int, idx: np.ndarray) -> np.ndarray:
    """Stand-ins for the 128-bit key hashes: one per (pool, key)."""
    return np.stack([np.full(idx.shape[0], tag, np.int64),
                     idx.astype(np.int64)], axis=1)


@pytest.mark.parametrize("paired", [True, False])
def test_per_read_route_equals_the_python_resolver(paired):
    """resolve_batch_hashed over two batches of reads that share keys: each
    read's set is _resolve_key's, and only first-seen keys are fetched."""
    rng = np.random.default_rng(5)
    index = _index(100)
    R = 16
    pool = _keys(rng, 2000, R, paired, ("any", "one_mate", "veto"))
    nat, py = EcResolver(index), EcResolver(index)
    fetched = []
    for lo, hi in ((0, 1200), (800, 2000)):
        ridx = rng.integers(lo, hi, 3 * (hi - lo))
        ridx[: hi - lo] = np.arange(lo, hi)  # every key of the range once
        rng.shuffle(ridx)

        def fetch(sel, ridx=ridx):
            fetched.append(len(sel))
            return pool[ridx[sel]]

        uidx, usets = nat.resolve_batch_hashed(_hashes(0, ridx), fetch, R,
                                               paired)
        for r, q in enumerate(ridx):
            want = py._resolve_key(pool[q], R, paired, False)
            got = usets[uidx[r]]
            assert (got is None) == (want is None)
            assert want is None or got.tolist() == want.tolist()
    assert fetched == [1200, 800]


def _part(pool, tag, idx, first, R, slim_ok):
    """One part of process_compact_parts over pool[idx] (the part's own
    rows), with the slim fetch (rows 0-1 of each mate and the flags) where
    slim_ok."""
    keys = pool[idx]
    slim = None
    if slim_ok:
        def slim(sel):
            return keys[sel][:, [0, 1, R, R + 1, 2 * R]]
    return (_hashes(tag, idx), np.ones(idx.shape[0], np.int64), first,
            lambda sel: keys[sel], R, slim)


@pytest.mark.parametrize("slim", [True, False])
def test_compact_parts_of_two_widths_number_ecs_in_read_order(slim):
    """A host part at R = 16 and a card part at R = 32 interleaved by first
    read, over three batches that repeat keys: the per-key EC ids, the EC
    table and its counts equal a key-by-key Python resolution in global
    first-read order."""
    rng = np.random.default_rng(11)
    index = _index(0)
    nat, py = EcResolver(index), EcResolver(index)
    pools = {16: _keys(rng, 1500, 16, True, ("any", "one_mate", "veto")),
             32: _keys(rng, 1500, 32, True, ("any", "one_mate"))}
    seen = {}
    for _ in range(3):
        idx = {R: rng.choice(1500, n, replace=False)
               for R, n in ((16, 500), (32, 400))}
        first = rng.permutation(900).astype(np.int64)
        parts = [_part(pools[16], 16, idx[16], first[:500], 16, slim),
                 _part(pools[32], 32, idx[32], first[500:], 32, slim)]
        got = np.concatenate(nat.process_compact_parts(
            parts, paired=True, return_key_ecs=True))
        want = np.empty(900, np.int64)
        for pos in np.argsort(first, kind="stable"):
            R = 16 if pos < 500 else 32
            q = int(idx[R][pos if R == 16 else pos - 500])
            if (R, q) not in seen:
                u = py._resolve_key(pools[R][q], R, True, False)
                seen[R, q] = -1 if u is None else py.ec_id_for(u)
            want[pos] = seen[R, q]
            if want[pos] >= 0:
                py.counts[want[pos]] += 1
        np.testing.assert_array_equal(got, want)
        assert _sets(nat) == _sets(py)
        np.testing.assert_array_equal(nat.counts_array(), py.counts_array())
        assert nat.num_mapped == int(py.counts_array().sum())


def test_rows_outside_the_index_raise():
    index = _index(0)
    keys = np.full((2, 33), INT32_MAX, np.int32)
    keys[0, 0] = index.ec_ptr.shape[0] - 1
    keys[:, 32] = 1
    with pytest.raises(ValueError, match="outside the index"):
        EcResolver(index)._native_sets(False).resolve(keys, 16, True)


@pytest.fixture(scope="module")
def port_index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)


NATIVE_RUNS = {
    "plain": (dict(), True),
    "fr": (dict(strand="fr"), False),
}


@pytest.mark.parametrize("case", sorted(NATIVE_RUNS))
def test_native_key_count_is_every_first_seen_key(port_index, monkeypatch,
                                                  case):
    """ec_native_keys is every first-seen key of the run, the per-read
    route's and the anchor route's, where the modes allow the native call,
    and 0 where they all take the Python path (a strand filter)."""
    kw, native = NATIVE_RUNS[case]
    monkeypatch.setenv("KALLISTO_TPU_HOST_WAVE1", "0")
    monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", "1000")
    seen = set()
    per_read_new = [0]
    resolve = EcResolver.resolve_batch_hashed

    def counted(self, h128, *a, **k):
        for row in np.ascontiguousarray(h128).reshape(-1, 2).tolist():
            if tuple(row) not in seen:
                seen.add(tuple(row))
                per_read_new[0] += 1
        return resolve(self, h128, *a, **k)

    monkeypatch.setattr(ecmap.EcResolver, "resolve_batch_hashed", counted)
    res = run_quant(Options(files=[os.path.join(DATA, "reads_1.fastq.gz"),
                                   os.path.join(DATA, "reads_2.fastq.gz")],
                            batch_size=1024, **kw),
                    index=port_index, device="cpu")
    t = res.timings
    compact_new = t["ec_cache_lookups"] - t["ec_cache_hits"]
    assert t["turbo"] > 0 and t["full"] > 0 and compact_new > 0
    assert per_read_new[0] > 0
    want = compact_new + per_read_new[0] if native else 0
    assert t["ec_native_keys"] == want
