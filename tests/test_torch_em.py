"""The port's float64 EM (plain PyTorch version, on the CPU) against the
JAX package's run_em.

Tolerance: equal n_rounds, and alpha / alpha_before_zeroes within rtol
1e-12, plus atol 1e-300 for the few values that decay towards the bottom
of the float64 range: XLA's CPU backend flushes subnormal intermediates to
zero, so where the reference and the port carry 1e-305 JAX may carry 0.
They are not bitwise equal over a whole run: XLA fuses the jitted
while-loop body and rounds a few last bits differently.  A single update
is bitwise equal to JAX's op-by-op _em_iteration (asserted below): both sum
every segment sequentially in ascending flat order from zero.  The CUDA
kernel is held bitwise to this plain version (tests/test_torch_kernels.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kallisto_tpu.quant.em as jem
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.quant import em as tem
from kallisto_tpu_torch.quant.pipeline import run_quant

# The test workers share the machine's cores: one intra-op thread per
# worker keeps torch's thread pools from oversubscribing them, which
# slows the many small CPU ops of these tests several times over.
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def bundled():
    index = build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)
    res = run_quant(
        Options(files=[os.path.join(DATA, "reads_1.fastq.gz"),
                       os.path.join(DATA, "reads_2.fastq.gz")]),
        index=index, device="cpu",
    )
    return res, index


@pytest.fixture(scope="module")
def paired_problem(bundled):
    res, index = bundled
    return res, index.num_trans


def _random_problem(seed, T=400, n_ec=600):
    rng = np.random.default_rng(seed)
    ec_sets = [np.array([t], np.int32) for t in range(0, T, 4)]
    for _ in range(n_ec):
        n = int(rng.integers(2, 16))
        ec_sets.append(np.unique(rng.choice(T, n, replace=False)).astype(np.int32))
    counts = rng.integers(0, 1000, len(ec_sets)).astype(np.int64)
    counts[rng.random(len(ec_sets)) < 0.1] = 0
    eff = rng.uniform(20, 5000, T)
    return ec_sets, counts, eff, T


def _compare(want, got):
    assert got.n_rounds == want.n_rounds
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(
        got.alpha_before_zeroes, want.alpha_before_zeroes, rtol=1e-12,
        atol=1e-300)


@pytest.mark.parametrize("priors_file", [None, "priors.txt", "priors_prob.txt"])
def test_run_em_matches_jax_on_bundled_paired(paired_problem, priors_file):
    res, T = paired_problem
    priors = None
    if priors_file:
        priors = tem.read_priors(os.path.join(DATA, priors_file), T)
        assert priors is not None
    jp = jem.build_em_problem(res.ec_sets, T)
    tp = tem.build_em_problem(res.ec_sets, T)
    for f in jp._fields:
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
    want = jem.run_em(jp, res.counts, res.eff_lens, priors=priors)
    got = tem.run_em(tp, res.counts, res.eff_lens, priors=priors, device="cpu")
    _compare(want, got)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_priors", [False, True])
def test_run_em_matches_jax_random(seed, use_priors):
    ec_sets, counts, eff, T = _random_problem(seed)
    priors = np.random.default_rng(seed + 10).dirichlet(np.ones(T)) \
        if use_priors else None
    want = jem.run_em(jem.build_em_problem(ec_sets, T), counts, eff,
                      priors=priors)
    got = tem.run_em(tem.build_em_problem(ec_sets, T), counts, eff,
                     priors=priors, device="cpu")
    _compare(want, got)


def test_run_em_iteration_cap_matches_jax():
    """Stopping at n_iter before convergence (and right after the final
    round starts) keeps the reference's bookkeeping."""
    ec_sets, counts, eff, T = _random_problem(3)
    for n_iter in (5, 60):
        want = jem.run_em(jem.build_em_problem(ec_sets, T), counts, eff,
                          n_iter=n_iter)
        got = tem.run_em(tem.build_em_problem(ec_sets, T), counts, eff,
                         n_iter=n_iter, device="cpu")
        _compare(want, got)
    full = tem.run_em(tem.build_em_problem(ec_sets, T), counts, eff,
                      device="cpu")
    # the iteration that starts the final round is full.n_rounds
    for n_iter in (full.n_rounds, full.n_rounds + 1):
        want = jem.run_em(jem.build_em_problem(ec_sets, T), counts, eff,
                          n_iter=n_iter)
        got = tem.run_em(tem.build_em_problem(ec_sets, T), counts, eff,
                         n_iter=n_iter, device="cpu")
        _compare(want, got)


def test_em_step_plain_matches_jax_iteration():
    """One update of one replicate is bitwise JAX's op-by-op
    _em_iteration."""
    ec_sets, counts, eff, T = _random_problem(4)
    p = tem.build_em_problem(ec_sets, T)
    sa, mc = tem.em_inputs(p, counts[None])
    alpha = np.random.default_rng(9).uniform(0, 50, T)
    want = np.asarray(jem._em_iteration(
        jnp.asarray(alpha), jnp.asarray(sa[0]), jnp.asarray(p.flat_tx),
        jnp.asarray(p.flat_ec), jnp.asarray(mc[0]), jnp.asarray(1.0 / eff),
        int(p.multi_ec_ids.shape[0])))
    prob = tem.device_em_problem(p, sa, mc, 1.0 / eff, "cpu")
    got, changed = tem.em_step_batch_plain(
        torch.from_numpy(alpha[None]), prob,
        torch.tensor([tem.UPDATE], dtype=torch.int32))
    assert np.array_equal(got[0].numpy(), want)
    assert changed.dtype == torch.int32 and int(changed[0]) > 0


def test_em_problem_transposed_csr():
    ec_sets, counts, eff, T = _random_problem(5, T=50, n_ec=40)
    p = tem.build_em_problem(ec_sets, T)
    prob = tem.device_em_problem(p, np.zeros(T), np.ones(len(p.multi_ec_ids)),
                                 1.0 / eff, "cpu")
    tx_ptr = prob.tx_ptr.numpy()
    tx_ec = prob.tx_ec.numpy()
    for t in range(T):
        want = p.flat_ec[p.flat_tx == t]
        np.testing.assert_array_equal(tx_ec[tx_ptr[t]:tx_ptr[t + 1]], want)
    ec_ptr = prob.ec_ptr.numpy()
    for e in range(p.multi_ec_ids.shape[0]):
        assert (p.flat_ec[ec_ptr[e]:ec_ptr[e + 1]] == e).all()


def test_run_em_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ec_sets, counts, eff, T = _random_problem(6, T=20, n_ec=10)
    with pytest.raises(RuntimeError):
        tem.run_em(tem.build_em_problem(ec_sets, T), counts, eff)


# ------------------------------------------------------------ batched EM


def _replicate_counts(counts, n, seed):
    """n multinomial resamples of `counts` (the callers keep only the
    singleton ECs' counts in replicate 0, so that it converges right after
    min_rounds, well before the others)."""
    rng = np.random.default_rng(seed)
    p = counts / counts.sum()
    out = np.stack([rng.multinomial(int(counts.sum()), p) for _ in range(n)])
    return out.astype(np.float64)


def _jax_batch(p, counts_b, eff, n_iter, min_rounds, batched_eff, priors):
    sa_b, mc_b = tem.em_inputs(p, counts_b)
    alpha, before, rounds = jem._run_em_batch_jax(
        sa_b, p.flat_tx, p.flat_ec, mc_b, 1.0 / eff,
        num_trans=p.num_trans, num_multi=int(p.multi_ec_ids.shape[0]),
        n_iter=n_iter, min_rounds=min_rounds, batched_eff=batched_eff,
        alpha_init=None if priors is None else jnp.asarray(priors))
    return np.asarray(alpha), np.asarray(before), np.asarray(rounds)


@pytest.mark.parametrize("batched_eff", [False, True])
@pytest.mark.parametrize("use_priors", [False, True])
@pytest.mark.parametrize("n_iter", [10000, 60])
def test_run_em_batch_matches_jax(batched_eff, use_priors, n_iter):
    """5 replicates against the vmapped JAX EM (float64 on the CPU): alpha
    and alpha_before_zeroes to rtol 1e-12, equal rounds per replicate.
    n_iter = 60 stops some replicates at the cap, some right after their
    final round started, and lets others finish."""
    ec_sets, counts, eff, T = _random_problem(7)
    p = tem.build_em_problem(ec_sets, T)
    counts_b = _replicate_counts(counts, 5, 8)
    counts_b[0, p.multi_ec_ids] = 0
    rng = np.random.default_rng(9)
    eff_b = eff[None, :] * rng.uniform(0.8, 1.2, (5, T)) if batched_eff else eff
    priors = rng.dirichlet(np.ones(T)) if use_priors else None
    got = tem.run_em_batch(p, counts_b, eff_b, n_iter=n_iter, priors=priors,
                           device="cpu")
    wa, wb, wr = _jax_batch(p, counts_b, eff_b, n_iter, 50, batched_eff,
                            priors)
    np.testing.assert_array_equal(got.n_rounds, wr)
    np.testing.assert_allclose(got.alpha, wa, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(got.alpha_before_zeroes, wb, rtol=1e-12,
                               atol=1e-300)
    if n_iter == 10000:
        assert got.n_rounds[0] < got.n_rounds[1:].min()


@pytest.mark.parametrize("batched_eff", [False, True])
def test_run_em_batch_replicate_equals_lone_run_em(batched_eff):
    """Every replicate, the early one included, is bitwise a lone run_em
    on its own counts (and lengths)."""
    ec_sets, counts, eff, T = _random_problem(11)
    p = tem.build_em_problem(ec_sets, T)
    counts_b = _replicate_counts(counts, 5, 12)
    counts_b[0, p.multi_ec_ids] = 0
    eff_b = np.stack([eff * (1 + 0.1 * b) for b in range(5)]) \
        if batched_eff else eff
    got = tem.run_em_batch(p, counts_b, eff_b, device="cpu")
    for b in range(5):
        lone = tem.run_em(p, counts_b[b], eff_b[b] if batched_eff else eff,
                          device="cpu")
        assert got.n_rounds[b] == lone.n_rounds
        assert np.array_equal(got.alpha[b], lone.alpha)
        assert np.array_equal(got.alpha_before_zeroes[b],
                              lone.alpha_before_zeroes)
    assert got.n_rounds[0] == 52 < got.n_rounds[1:].min()


def test_em_step_batch_plain_rows_equal_em_step_plain():
    """One batched update: each updated row is that of a one-replicate
    update of the row alone, a frozen row is copied with no change
    counted, and the zeroing mode zeroes the input."""
    ec_sets, counts, eff, T = _random_problem(13)
    p = tem.build_em_problem(ec_sets, T)
    counts_b = _replicate_counts(counts, 3, 14)
    sa_b, mc_b = tem.em_inputs(p, counts_b)
    alpha = np.random.default_rng(15).uniform(0, 50, (3, T))
    alpha[:, ::7] = 1e-9
    prob = tem.device_em_problem(p, sa_b, mc_b, 1.0 / eff, "cpu")
    mode = torch.tensor([tem.UPDATE, tem.FROZEN, tem.UPDATE_ZEROED],
                        dtype=torch.int32)
    nxt, changed = tem.em_step_batch_plain(torch.from_numpy(alpha), prob, mode)
    for b in (0, 2):
        one = tem.device_em_problem(p, sa_b[b:b + 1], mc_b[b:b + 1],
                                    1.0 / eff, "cpu")
        want, ch = tem.em_step_batch_plain(
            torch.from_numpy(alpha[b:b + 1]), one, mode[b:b + 1])
        assert torch.equal(nxt[b], want[0]) and int(changed[b]) == int(ch[0])
    zeroed = alpha[2] < 1e-8
    assert zeroed.any()
    assert not torch.equal(
        nxt[2], tem.em_step_batch_plain(
            torch.from_numpy(alpha[2:3]), tem.device_em_problem(
                p, sa_b[2:3], mc_b[2:3], 1.0 / eff, "cpu"),
            torch.tensor([tem.UPDATE], dtype=torch.int32))[0][0])
    assert torch.equal(nxt[1], torch.from_numpy(alpha[1]))
    assert int(changed[1]) == 0


# ------------------------------------------------------- bias EM segments


def test_bias_em_matches_jax_on_bundled(bundled):
    """run_em with the sequence-bias hook (quant/bias.py update_eff_lens
    on the bundled index) against JAX's: the bundled problem converges
    after the update at iteration 50, so the loop breaks before 550."""
    from kallisto_tpu_torch.quant import bias as tbias
    from kallisto_tpu_torch.quant.fld import (
        compute_mean_frag_lens_trunc, get_frag_len_means)

    res, index = bundled
    T = index.num_trans
    means = get_frag_len_means(index.target_lens,
                               compute_mean_frag_lens_trunc(res.flens))
    bias5 = np.random.default_rng(3).integers(0, 40, tbias.NUM_6MERS)
    hx = tbias.TranscriptHexamers(index)
    calls = []

    def f(alpha, eff):
        calls.append(alpha.copy())
        return tbias.update_eff_lens(means, bias5, hx, index.target_lens,
                                     alpha, eff, None)

    want = jem.run_em(jem.build_em_problem(res.ec_sets, T), res.counts,
                      res.eff_lens, bias_update=f)
    n_jax = len(calls)
    got = tem.run_em(tem.build_em_problem(res.ec_sets, T), res.counts,
                     res.eff_lens, bias_update=f, device="cpu")
    assert n_jax == 1 and len(calls) == 2 and got.n_rounds < 550
    _compare(want, got)
    np.testing.assert_allclose(got.eff_lens, want.eff_lens, rtol=1e-12)
    np.testing.assert_allclose(got.post_bias, want.post_bias, rtol=1e-12)
    assert not np.allclose(got.eff_lens, res.eff_lens)


def _slow_problem():
    """Transcript 0 shares an EC with transcript 1, which has 2% more
    evidence of its own, so alpha_0 decays by ~2% per round and the EM
    stops only once it is below 1e-2 (~660 rounds); transcript 2 halves
    each round and is far below the zeroing limit by then."""
    ec_sets = [np.array([t], np.int32) for t in range(6)] + [
        np.array([0, 1], np.int32), np.array([2, 3], np.int32)]
    counts = np.array([0, 200, 0, 100, 50, 70, 10000, 100], np.float64)
    return ec_sets, counts, np.full(6, 1000.0), 6


@pytest.mark.parametrize("where", ["final_round_at_550", "third_segment"])
def test_bias_em_segments_match_jax(where):
    """A hook that scales every length by 2 (which leaves the EM's path
    unchanged) and reports the alpha it was given as post_bias.  With
    min_rounds chosen so that the final round starts exactly at the second
    boundary, the hook must get the zeroed alpha, as JAX's state holds it;
    with min_rounds 50 the loop runs into the third segment."""
    ec_sets, counts, eff, T = _slow_problem()
    p = tem.build_em_problem(ec_sets, T)
    # the iteration that starts the final round when min_rounds is 0
    i_s = tem.run_em(p, counts, eff, min_rounds=0, device="cpu").n_rounds - 1
    assert i_s > 600
    m = i_s - 499 if where == "final_round_at_550" else 50
    seen = []

    def f(alpha, eff):
        seen.append(alpha.copy())
        return eff * 2.0, alpha.copy()

    want = jem.run_em(jem.build_em_problem(ec_sets, T), counts, eff,
                      min_rounds=m, bias_update=f)
    got = tem.run_em(p, counts, eff, min_rounds=m, bias_update=f,
                     device="cpu")
    assert len(seen) == 4
    _compare(want, got)
    np.testing.assert_array_equal(got.eff_lens, want.eff_lens)
    np.testing.assert_allclose(got.post_bias, want.post_bias, rtol=1e-12,
                               atol=0)
    if where == "final_round_at_550":
        assert got.n_rounds == m + 500
        assert seen[-1][2] == 0.0 and got.alpha_before_zeroes[2] > 0.0
    else:
        assert got.n_rounds > m + 500 and seen[-1][2] > 0.0
