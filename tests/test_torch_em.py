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


# --------------------------------------------- the loop's state on the device


def _parent_loop(problem, counts_b, eff_lens, n_iter=10000, min_rounds=50,
                 priors=None, bias_update=None, singletons_after=False):
    """The host-driven loop that run_em_batch ran before its rounds moved
    into EmLoop (one update per step, the stop rule on the host after
    every round): the bitwise reference of the new loop on the CPU."""
    counts_b = np.asarray(counts_b)
    Bb = counts_b.shape[0]
    cur_eff = eff_lens.astype(np.float64)
    singleton_b, multi_b = tem.em_inputs(problem, counts_b)
    post = None
    if singletons_after:
        post, singleton_b = singleton_b, np.zeros_like(singleton_b)
    prob = tem.device_em_problem(problem, singleton_b, multi_b, 1.0 / cur_eff,
                                 "cpu")
    alpha = torch.from_numpy(np.tile(tem._alpha0(problem, priors), (Bb, 1)))
    before = alpha
    mode = np.full(Bb, tem.UPDATE, np.int32)
    done_at = np.full(Bb, -1, np.int64)
    running, zeroing, i, post_bias = Bb, False, 0, None
    bounds = (n_iter,) if bias_update is None else (
        min_rounds, min_rounds + 500, n_iter)
    for seg, bound in enumerate(bounds):
        if seg:
            if not running:
                break
            a = alpha[0].numpy()
            cur_eff, post_bias = bias_update(tem._zeroed(a) if zeroing else a,
                                             cur_eff)
            prob = prob._replace(inv_eff=torch.from_numpy(1.0 / cur_eff))
        while i < bound and running:
            nxt, changed = tem.em_step_batch_plain(alpha, prob,
                                                   torch.from_numpy(mode))
            if i > min_rounds:
                ch = changed.numpy()
                start = (mode == tem.UPDATE) & (ch == 0)
                ended = mode == tem.UPDATE_ZEROED
                done_at[ended] = i + 1
                running -= int(ended.sum())
                zeroing = bool(start.any())
                before = torch.where(torch.from_numpy(start)[:, None], nxt,
                                     before)
                mode = np.where(ended, tem.FROZEN, np.where(
                    start, tem.UPDATE_ZEROED, mode)).astype(np.int32)
            alpha = nxt
            i += 1
    alpha_h = alpha.numpy().copy()
    pending = mode == tem.UPDATE_ZEROED
    alpha_h[pending] = tem._zeroed(alpha_h[pending])
    done = done_at >= 0
    before_h = np.where(done[:, None], before.numpy(), alpha_h)
    if post is not None:
        alpha_h = alpha_h + post
    return alpha_h, before_h, np.where(done, done_at - 1, i), post_bias


def _reads_bound(n_rounds, chunk, n_segments):
    """The loop's host reads: at most ceil(rounds / chunk) plus one per
    segment (the chunks of each segment end at its bound, and alpha comes
    back once at the end)."""
    return -(-int(n_rounds) // chunk) + n_segments


LOOP_CASES = ["mixed", "cap_in_chunk", "priors", "singletons_after",
              "batched_eff"]


@pytest.mark.parametrize("chunk", [7, 32])
@pytest.mark.parametrize("case", LOOP_CASES)
def test_loop_matches_jax_and_parent_loop(monkeypatch, case, chunk):
    """run_em_batch through EmLoop on the CPU (em_round_plain: the plain
    update and the plain stop step), for 5 replicates that converge at
    different rounds: equal n_rounds and alpha to rtol 1e-12 against JAX's
    vmapped EM, bitwise equal to the parent's host loop, and at most
    ceil(rounds / chunk) + 1 host reads.  cap_in_chunk stops at n_iter =
    60, inside a chunk of 7 and of 32."""
    monkeypatch.setattr(tem, "EM_CHUNK", chunk)
    ec_sets, counts, eff, T = _random_problem(21)
    p = tem.build_em_problem(ec_sets, T)
    counts_b = _replicate_counts(counts, 5, 22)
    counts_b[0, p.multi_ec_ids] = 0
    rng = np.random.default_rng(23)
    n_iter = 60 if case == "cap_in_chunk" else 10000
    priors = rng.dirichlet(np.ones(T)) if case == "priors" else None
    batched = case == "batched_eff"
    eff_b = eff[None, :] * rng.uniform(0.8, 1.2, (5, T)) if batched else eff
    sa = case == "singletons_after"
    got = tem.run_em_batch(p, counts_b, eff_b, n_iter=n_iter, priors=priors,
                           device="cpu", singletons_after=sa)
    pa_, pb_, pr_, _ = _parent_loop(p, counts_b, eff_b, n_iter=n_iter,
                                    priors=priors, singletons_after=sa)
    assert np.array_equal(got.n_rounds, pr_)
    assert np.array_equal(got.alpha, pa_)
    assert np.array_equal(got.alpha_before_zeroes, pb_)
    assert got.host_reads <= _reads_bound(got.n_rounds.max() + 1, chunk, 1)
    if sa:  # JAX adds the singletons after its loop in run_em only
        for b in range(5):
            want = jem.run_em(jem.build_em_problem(ec_sets, T), counts_b[b],
                              eff, singletons_after=True)
            assert got.n_rounds[b] == want.n_rounds
            np.testing.assert_allclose(got.alpha[b], want.alpha, rtol=1e-12,
                                       atol=1e-300)
        return
    wa, wb, wr = _jax_batch(p, counts_b, eff_b, n_iter, 50, batched, priors)
    np.testing.assert_array_equal(got.n_rounds, wr)
    np.testing.assert_allclose(got.alpha, wa, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(got.alpha_before_zeroes, wb, rtol=1e-12,
                               atol=1e-300)
    if case == "mixed":
        assert len(set(got.n_rounds.tolist())) > 2
    if case == "cap_in_chunk":
        assert (got.n_rounds == 60).any() and (got.n_rounds < 60).any()


@pytest.mark.parametrize("chunk", [1, 7, 32, 1000])
@pytest.mark.parametrize("where", ["final_round_at_550", "third_segment"])
def test_loop_bias_segments_match_jax_and_parent_loop(monkeypatch, where,
                                                      chunk):
    """The bias segments through EmLoop: the hook sees the alpha of the
    segment's bound (zeroed when the final round starts there), the chunks
    end at min_rounds and min_rounds + 500, the result is bitwise the
    parent loop's and within rtol 1e-12 of JAX's, and the host reads stay
    within ceil(rounds / chunk) + 3 (three segments)."""
    monkeypatch.setattr(tem, "EM_CHUNK", chunk)
    ec_sets, counts, eff, T = _slow_problem()
    p = tem.build_em_problem(ec_sets, T)
    i_s = tem.run_em(p, counts, eff, min_rounds=0, device="cpu").n_rounds - 1
    m = i_s - 499 if where == "final_round_at_550" else 50
    seen = {"port": [], "parent": [], "jax": []}

    def hook(tag):
        def f(alpha, eff):
            seen[tag].append(alpha.copy())
            return eff * 2.0, alpha.copy()
        return f

    got = tem.run_em(p, counts, eff, min_rounds=m, bias_update=hook("port"),
                     device="cpu")
    pa_, pb_, pr_, pbias = _parent_loop(p, counts[None], eff, min_rounds=m,
                                        bias_update=hook("parent"))
    want = jem.run_em(jem.build_em_problem(ec_sets, T), counts, eff,
                      min_rounds=m, bias_update=hook("jax"))
    assert got.n_rounds == int(pr_[0]) == want.n_rounds
    assert np.array_equal(got.alpha, pa_[0])
    assert np.array_equal(got.alpha_before_zeroes, pb_[0])
    assert np.array_equal(got.post_bias, pbias)
    assert len(seen["port"]) == len(seen["parent"]) == 2
    for x, y in zip(seen["port"], seen["parent"]):
        assert np.array_equal(x, y)
    _compare(want, got)
    assert got.host_reads <= _reads_bound(got.n_rounds + 1, chunk, 3)


def test_loop_frozen_from_round_0():
    """A replicate whose mode is FROZEN before round 0 does no work: its
    alpha stays alpha0, it is never counted as running, and the others
    end exactly as lone runs."""
    ec_sets, counts, eff, T = _random_problem(24)
    p = tem.build_em_problem(ec_sets, T)
    counts_b = _replicate_counts(counts, 3, 25)
    sa_b, mc_b = tem.em_inputs(p, counts_b)
    prob = tem.device_em_problem(p, sa_b, mc_b, 1.0 / eff, "cpu")
    a0 = tem._alpha0(p, None)
    mode = np.array([tem.UPDATE, tem.FROZEN, tem.UPDATE], np.int64)
    loop = tem.EmLoop(prob, a0, 50, mode=mode, rounds=16)
    loop.set_bound(10000)
    running, n_chunks = 2, 0
    while running:
        loop.run_chunk()
        st, _ = loop.read()
        running, n_chunks = int(st[2]), n_chunks + 1
    st, bufs = loop.read(with_alpha=True)
    assert st[4 + 1] == tem.FROZEN and st[4 + 3 + 1] == -1
    assert np.array_equal(bufs[0, :, 1], a0) and np.array_equal(bufs[1, :, 1], a0)
    for b in (0, 2):
        lone = tem.run_em(p, counts_b[b], eff, device="cpu")
        done_at = int(st[4 + 3 + b])
        assert done_at - 1 == lone.n_rounds
        assert np.array_equal(bufs[done_at % 2, :, b], lone.alpha)
        assert np.array_equal(bufs[(done_at - 1) % 2, :, b],
                              lone.alpha_before_zeroes)
    # rounds after every replicate froze neither ran nor advanced i
    assert int(st[0]) == int(st[4 + 3:4 + 6].max()) <= 16 * n_chunks
    assert loop.reads == n_chunks + 1


def test_stop_plain_step():
    """em_stop_plain: nothing before round min_rounds + 1; then a final
    round starts for an updating replicate without changes and ends one
    round later (done_at = i + 1, running down by one); the round's change
    counts are kept in the state's last slots; no change past the
    bound."""
    st = torch.tensor([0, 100, 3, 0, 1, 1, 0, -1, -1, -1, 0, 0, 0],
                      dtype=torch.int64)
    none = torch.zeros(3, dtype=torch.int32)
    some = torch.tensor([0, 4, 0], dtype=torch.int32)
    tem.em_stop_plain(st, none, 0)          # i = 0: not after min_rounds
    assert st.tolist() == [1, 100, 3, 0, 1, 1, 0, -1, -1, -1, 0, 0, 0]
    tem.em_stop_plain(st, some, 0)          # replicate 0 starts its final round
    assert st.tolist() == [2, 100, 3, 0, 2, 1, 0, -1, -1, -1, 0, 4, 0]
    tem.em_stop_plain(st, some, 0)          # ... and ends after it
    assert st.tolist() == [3, 100, 2, 0, 0, 1, 0, 3, -1, -1, 0, 4, 0]
    st[1] = 3                                # the bound stops the loop
    tem.em_stop_plain(st, none, 0)
    assert st.tolist() == [3, 3, 2, 0, 0, 1, 0, 3, -1, -1, 0, 4, 0]


@pytest.mark.parametrize("batched_eff", [False, True])
def test_loop_one_round_is_one_update(batched_eff):
    """EmLoop from alpha0 [Bb, T] with modes 0/1/2 mixed, one round and
    the stop rule out of reach: the other buffer holds the plain update's
    next (a frozen replicate's alpha0 column untouched) and the state's
    last slots its change counts; i = 1 and no mode changed."""
    ec_sets, counts, eff, T = _random_problem(28)
    p = tem.build_em_problem(ec_sets, T)
    counts_b = _replicate_counts(counts, 6, 29)
    sa_b, mc_b = tem.em_inputs(p, counts_b)
    rng = np.random.default_rng(30)
    inv = 1.0 / (eff[None, :] * rng.uniform(0.8, 1.2, (6, T))
                 if batched_eff else eff)
    prob = tem.device_em_problem(p, sa_b, mc_b, inv, "cpu")
    alpha = rng.uniform(0, 50, (6, T))
    alpha[:, ::5] = 1e-9
    mode = np.array([1, 0, 2, 1, 2, 0], np.int64)
    loop = tem.EmLoop(prob, alpha, 2**31 - 1, mode=mode, rounds=1)
    loop.set_bound(1)
    loop.run_chunk()
    st, bufs = loop.read(with_alpha=True)
    nxt, changed = tem.em_step_batch_plain(
        torch.from_numpy(alpha), prob, torch.from_numpy(mode.astype(np.int32)))
    assert np.array_equal(bufs[0].T, alpha)
    assert np.array_equal(bufs[1].T, nxt.numpy())
    assert np.array_equal(bufs[1][:, 1], alpha[1])
    assert np.array_equal(st[4 + 12:], changed.numpy())
    assert changed[0] > 0 and changed[1] == 0
    assert st[0] == 1 and st[2] == 4 and np.array_equal(st[4:10], mode)


@pytest.mark.parametrize("batched_eff", [False, True])
def test_em_layout_round_trip(batched_eff):
    """Kernel G's replicate-minor rows ([item, Bb], contiguous) are the
    transposes of the problem's [Bb, item] rows and come back unchanged;
    a shared inv_eff is the problem's own tensor (the bias segments
    rewrite it in place)."""
    from kallisto_tpu_torch.ops import kernels

    ec_sets, counts, eff, T = _random_problem(26, T=60, n_ec=50)
    p = tem.build_em_problem(ec_sets, T)
    counts_b = _replicate_counts(counts, 4, 27)
    sa_b, mc_b = tem.em_inputs(p, counts_b)
    inv = 1.0 / (np.stack([eff * (1 + 0.1 * b) for b in range(4)])
                 if batched_eff else eff)
    prob = tem.device_em_problem(p, sa_b, mc_b, inv, "cpu")
    sing, multi, inv_rm = kernels.em_layout(prob)
    E = p.multi_ec_ids.shape[0]
    assert sing.shape == (T, 4) and multi.shape == (E, 4)
    assert sing.is_contiguous() and multi.is_contiguous()
    assert torch.equal(sing.t(), prob.singleton_alpha)
    assert torch.equal(multi.t(), prob.multi_counts)
    if batched_eff:
        assert inv_rm.shape == (T, 4) and inv_rm.is_contiguous()
        assert torch.equal(inv_rm.t(), prob.inv_eff)
    else:
        assert inv_rm is prob.inv_eff
    # the loop's buffers in the same layout: column b is replicate b
    loop = tem.EmLoop(prob, tem._alpha0(p, None), 50)
    assert loop.bufs.shape == (2, T, 4) and loop.bufs.is_contiguous()
    assert torch.equal(loop.bufs[0].t().contiguous()[2], loop.bufs[1][:, 2])
