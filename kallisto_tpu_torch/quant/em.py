"""The EM abundance quantifier, float64, one kernel launch per update.

Port of kallisto_tpu/quant/em.py (the reference's EMAlgorithm::run,
src/EMAlgorithm.h:95-375) with segment reductions over a flattened
EC -> transcript CSR:

  per iteration:
    s_ec        = segment_sum(alpha[tx] / eff_len[tx])          (denominator)
    next_alpha  = singleton_counts
                + scatter_add(count_ec * alpha[tx] / (eff_len[tx] * s_ec))

Convergence matches EMAlgorithm.h:171-222: stop when no transcript with
next_alpha > 1e-2 changes by more than 1% relative, after min_rounds; then
zero out alpha < 1e-8 and run one final iteration.

On the card each update is kernel C (csrc/em.cu); on the CPU it is the
plain version below.  Both sum in the same fixed ascending order, so they
agree bitwise.  The loop reads the change count to the host once per
iteration to apply the stop rule.
"""

import sys
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..common import (
    EM_ALPHA_CHANGE,
    EM_ALPHA_CHANGE_LIMIT,
    EM_ALPHA_LIMIT,
    EM_TOLERANCE,
)
from ..ops import kernels


class EmProblem(NamedTuple):
    """Flattened EC->transcript structure for the EM update."""

    num_trans: int            # static
    singleton_tx: np.ndarray  # [S] transcript of each singleton EC
    singleton_ec: np.ndarray  # [S] ec id of each singleton EC
    flat_tx: np.ndarray       # [M] transcript ids of multi-tx ECs
    flat_ec: np.ndarray       # [M] position of the owning EC in the multi list
    multi_ec_ids: np.ndarray  # [E] original ec ids of multi-tx ECs


def build_em_problem(ec_sets: List[np.ndarray], num_trans: int) -> EmProblem:
    singleton_tx, singleton_ec = [], []
    flat_tx, flat_ec, multi_ec_ids = [], [], []
    for ec, s in enumerate(ec_sets):
        if s.shape[0] == 1:
            singleton_tx.append(int(s[0]))
            singleton_ec.append(ec)
        elif s.shape[0] > 1:
            flat_tx.append(s)
            flat_ec.append(np.full(s.shape[0], len(multi_ec_ids), np.int32))
            multi_ec_ids.append(ec)
    return EmProblem(
        num_trans=num_trans,
        singleton_tx=np.array(singleton_tx, np.int32),
        singleton_ec=np.array(singleton_ec, np.int64),
        flat_tx=(
            np.concatenate(flat_tx).astype(np.int32)
            if flat_tx else np.empty(0, np.int32)
        ),
        flat_ec=(
            np.concatenate(flat_ec).astype(np.int32)
            if flat_ec else np.empty(0, np.int32)
        ),
        multi_ec_ids=np.array(multi_ec_ids, np.int64),
    )


class DeviceEmProblem(NamedTuple):
    """The EM inputs on one device, with both CSR directions: ec_ptr over
    the (EC-contiguous) flat entries for pass 1, and tx_ptr/tx_ec -- the
    flat entries regrouped by transcript, ascending flat order within each
    transcript -- for pass 2."""

    num_trans: int
    num_multi: int
    singleton_alpha: torch.Tensor  # [T] f64
    inv_eff: torch.Tensor          # [T] f64
    flat_tx: torch.Tensor          # [M] int32
    flat_ec: torch.Tensor          # [M] int32 (nondecreasing)
    ec_ptr: torch.Tensor           # [E+1] int64
    multi_counts: torch.Tensor     # [E] f64
    tx_ptr: torch.Tensor           # [T+1] int64
    tx_ec: torch.Tensor            # [M] int32


def device_em_problem(problem: EmProblem, singleton_alpha: np.ndarray,
                      multi_counts: np.ndarray, inv_eff: np.ndarray,
                      device) -> DeviceEmProblem:
    T = problem.num_trans
    E = int(problem.multi_ec_ids.shape[0])
    flat_tx = problem.flat_tx.astype(np.int32)
    flat_ec = problem.flat_ec.astype(np.int32)
    ec_ptr = np.zeros(E + 1, np.int64)
    np.cumsum(np.bincount(flat_ec, minlength=E), out=ec_ptr[1:])
    perm = np.argsort(flat_tx, kind="stable")
    tx_ptr = np.zeros(T + 1, np.int64)
    np.cumsum(np.bincount(flat_tx, minlength=T), out=tx_ptr[1:])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DeviceEmProblem(
        num_trans=T, num_multi=E,
        singleton_alpha=put(singleton_alpha.astype(np.float64)),
        inv_eff=put(inv_eff.astype(np.float64)),
        flat_tx=put(flat_tx), flat_ec=put(flat_ec), ec_ptr=put(ec_ptr),
        multi_counts=put(multi_counts.astype(np.float64)),
        tx_ptr=put(tx_ptr), tx_ec=put(flat_ec[perm]),
    )


def em_step_plain(alpha: torch.Tensor, prob: DeviceEmProblem,
                  zero_input: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C: (next_alpha, changed count [1]).

    index_add_ on the CPU accumulates sequentially in index order from the
    zero it starts with -- the order of a sequential segment_sum."""
    a = alpha
    if zero_input:
        a = torch.where(alpha < EM_ALPHA_LIMIT / 10.0,
                        torch.zeros_like(alpha), alpha)
    tx = prob.flat_tx.to(torch.int64)
    ec = prob.flat_ec.to(torch.int64)
    a_over_l = a[tx] * prob.inv_eff[tx]
    s_ec = torch.zeros(prob.num_multi, dtype=torch.float64,
                       device=a.device).index_add_(0, ec, a_over_l)
    mc = prob.multi_counts
    denom = mc * s_ec
    valid = (mc > 0) & (denom >= EM_TOLERANCE)
    scale = torch.where(
        valid, mc / torch.where(s_ec > 0, s_ec, torch.ones_like(s_ec)),
        torch.zeros_like(s_ec),
    )
    contrib = a_over_l * scale[ec]
    nxt = prob.singleton_alpha + torch.zeros_like(a).index_add_(0, tx, contrib)
    changed = (nxt > EM_ALPHA_CHANGE_LIMIT) & (
        (nxt - a).abs() / torch.where(nxt > 0, nxt, torch.ones_like(nxt))
        > EM_ALPHA_CHANGE
    )
    return nxt, changed.sum().to(torch.int32).reshape(1)


def em_step(alpha: torch.Tensor, prob: DeviceEmProblem, zero_input: bool):
    """One EM update: kernel C for CUDA tensors, the plain version else."""
    if alpha.is_cuda:
        return kernels.em_step(alpha, prob, zero_input)
    return em_step_plain(alpha, prob, zero_input)


def read_priors(path: str, num_trans: int) -> Optional[np.ndarray]:
    """Parse a priors file (one float per line, same order as targets).

    If the values sum to more than 1 (+eps) they are raw counts: add a
    pseudocount of 1 to every entry and normalize, so no prior is exactly
    zero (reference: EMAlgorithm::read_priors, src/EMAlgorithm.h:52-81).
    A length mismatch warns and falls back to uniform priors
    (EMAlgorithm::set_priors, src/EMAlgorithm.h:83-93).
    """
    print(f"[   em] reading priors from file {path}", file=sys.stderr)
    with open(path) as f:
        priors = np.array(
            [float(line) for line in f if line.strip() != ""], np.float64
        )
    s = priors.sum()
    if s >= 1.0 + 1e-3:
        priors = (priors + 1.0) / (s + priors.shape[0])
    if priors.shape[0] != num_trans:
        print("[   em] number of priors does not match number of "
              "transcripts.", file=sys.stderr)
        print("        defaulting to uniform priors.", file=sys.stderr)
        return None
    return priors


class EmResult(NamedTuple):
    alpha: np.ndarray
    alpha_before_zeroes: np.ndarray
    n_rounds: int
    eff_lens: Optional[np.ndarray] = None


def run_em(
    problem: EmProblem,
    counts: np.ndarray,
    eff_lens: np.ndarray,
    n_iter: int = 10000,
    min_rounds: int = 50,
    priors: Optional[np.ndarray] = None,
    device=None,
) -> EmResult:
    """Run the EM to convergence in float64 on `device` (default: the card;
    raises without one unless device='cpu').

    The host keeps the loop state of the reference (EMAlgorithm.h:171-222,
    JAX em.py _em_loop): after each update it reads the change count, and
    the update that starts the final round leaves its raw output as
    alpha_before_zeroes while the next update reads it zeroed below
    EM_ALPHA_LIMIT / 10 (kernel C's zero_input)."""
    from .. import resolve_device

    dev = resolve_device(device)
    T = problem.num_trans
    singleton_alpha = np.zeros(T, np.float64)
    if problem.singleton_tx.size:
        # next_alpha[t] = counts[singleton ec of t] (assignment; each t has
        # at most one singleton EC) -- reference: EMAlgorithm.h:119-123
        singleton_alpha[problem.singleton_tx] = counts[problem.singleton_ec]
    multi_counts = counts[problem.multi_ec_ids].astype(np.float64)
    inv_eff = 1.0 / eff_lens.astype(np.float64)
    prob = device_em_problem(problem, singleton_alpha, multi_counts, inv_eff, dev)

    if priors is None:
        alpha0 = np.full(T, 1.0 / T, np.float64)
    else:
        alpha0 = np.asarray(priors, np.float64)
    alpha = torch.from_numpy(alpha0.copy()).to(dev)
    before = alpha
    i = 0
    final_round = done = zero_pending = False
    while not done and i < n_iter:
        nxt, changed = em_step(alpha, prob, zero_pending)
        chcount = int(changed.item())
        stop_em = chcount == 0 and i > min_rounds
        done = final_round          # the previous iteration started the
        #                             final round; this update was it
        start_final = stop_em and not final_round
        if start_final:
            before = nxt
        final_round = final_round or start_final
        zero_pending = start_final
        alpha = nxt
        i += 1

    alpha_h = alpha.cpu().numpy()
    if zero_pending:
        # ran out of iterations right after starting the final round: the
        # state alpha is the zeroed one
        alpha_h = np.where(alpha_h < EM_ALPHA_LIMIT / 10.0, 0.0, alpha_h)
    # if we ran out of iterations without converging, alpha_before_zeroes
    # is simply the final alpha (reference: EMAlgorithm.h:359-365); the
    # reference reports the 0-based index at break (EMAlgorithm.h:369)
    before_h = before.cpu().numpy() if done else alpha_h
    n_rounds = i - 1 if done else i
    return EmResult(
        alpha=alpha_h,
        alpha_before_zeroes=before_h,
        n_rounds=int(n_rounds),
        eff_lens=np.asarray(eff_lens, np.float64),
    )


def counts_to_tpm(est_counts: np.ndarray, eff_lens: np.ndarray) -> np.ndarray:
    """reference: counts_to_tpm (src/PlaintextWriter.cpp:5-27)."""
    tpm = est_counts / eff_lens
    return tpm / tpm.sum() * 1e6
