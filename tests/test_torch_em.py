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
def paired_problem():
    index = build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)
    res = run_quant(
        Options(files=[os.path.join(DATA, "reads_1.fastq.gz"),
                       os.path.join(DATA, "reads_2.fastq.gz")]),
        index=index, device="cpu",
    )
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
    ec_sets, counts, eff, T = _random_problem(4)
    p = tem.build_em_problem(ec_sets, T)
    sa = np.zeros(T)
    sa[p.singleton_tx] = counts[p.singleton_ec]
    mc = counts[p.multi_ec_ids].astype(np.float64)
    alpha = np.random.default_rng(9).uniform(0, 50, T)
    want = np.asarray(jem._em_iteration(
        jnp.asarray(alpha), jnp.asarray(sa), jnp.asarray(p.flat_tx),
        jnp.asarray(p.flat_ec), jnp.asarray(mc), jnp.asarray(1.0 / eff),
        int(p.multi_ec_ids.shape[0])))
    prob = tem.device_em_problem(p, sa, mc, 1.0 / eff, "cpu")
    got, changed = tem.em_step_plain(torch.from_numpy(alpha), prob, False)
    assert np.array_equal(got.numpy(), want)
    assert changed.dtype == torch.int32 and int(changed) > 0


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
