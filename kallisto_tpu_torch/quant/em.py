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

One loop serves the main EM (run_em: one replicate) and the bootstraps
(run_em_batch: Bb replicates sharing one EC structure, JAX em.py
_run_em_batch_jax).  Each round is one update of every running replicate:
kernel G (csrc/em.cu em_step_batch) on the card, the plain version below
on the CPU; both sum in the same fixed ascending order, so they agree
bitwise.  The host keeps each replicate's loop state, as JAX's vmapped
while-loop does, so replicate b's result equals a lone run_em on its
counts.  It runs in float64 on the card: the JAX package drops the
batched EM to float32 on its accelerator only because the TPU has no
float64 (em.py:46-71), while the H100 has it natively, so the card's
replicates stay equal to the float64 CPU leg.
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
    transcript -- for pass 2.  A batch of Bb replicates shares the CSR and
    carries one row per replicate in singleton_alpha and multi_counts, and
    in inv_eff when each replicate has its own lengths."""

    num_trans: int
    num_multi: int
    singleton_alpha: torch.Tensor  # [Bb, T] f64
    inv_eff: torch.Tensor          # [T] f64 shared, or [Bb, T]
    flat_tx: torch.Tensor          # [M] int32
    flat_ec: torch.Tensor          # [M] int32 (nondecreasing)
    ec_ptr: torch.Tensor           # [E+1] int64
    multi_counts: torch.Tensor     # [Bb, E] f64
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


# per-replicate mode of a batched update (kernel G's `mode` array)
FROZEN, UPDATE, UPDATE_ZEROED = 0, 1, 2


def em_step_batch_plain(alpha: torch.Tensor, prob: DeviceEmProblem,
                        mode: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel G: (next [Bb, T], changed [Bb]
    int32).  Each replicate whose mode is UPDATE gets one EM update of its
    alpha (of its zeroed alpha under UPDATE_ZEROED, the reference's final
    round) and the count of transcripts that changed; a FROZEN replicate
    keeps its alpha and counts no change.

    The updated replicates are flattened into one index_add_ per pass with
    segment ids b * E + ec and b * T + tx: on the CPU it adds sequentially
    in index order, so each segment is summed in ascending flat order from
    zero -- the order of a sequential segment_sum, and of kernel G."""
    Bb, T = alpha.shape
    E = prob.num_multi
    nxt = alpha.clone()
    changed = torch.zeros(Bb, dtype=torch.int32, device=alpha.device)
    act = torch.nonzero(mode != FROZEN).flatten()
    n = int(act.shape[0])
    if n == 0:
        return nxt, changed
    a = alpha[act]
    zero = (mode[act] == UPDATE_ZEROED)[:, None] & (a < EM_ALPHA_LIMIT / 10.0)
    a = torch.where(zero, torch.zeros_like(a), a)
    tx = prob.flat_tx.to(torch.int64)
    ec = prob.flat_ec.to(torch.int64)
    inv = prob.inv_eff[act] if prob.inv_eff.dim() == 2 else prob.inv_eff[None, :]
    a_over_l = a[:, tx] * inv[:, tx]                               # [n, M]
    row = torch.arange(n, device=alpha.device)[:, None]
    s_ec = torch.zeros(n * E, dtype=torch.float64, device=alpha.device)
    s_ec = s_ec.index_add_(0, (row * E + ec).flatten(),
                           a_over_l.flatten()).view(n, E)
    mc = prob.multi_counts[act]
    denom = mc * s_ec
    valid = (mc > 0) & (denom >= EM_TOLERANCE)
    scale = torch.where(
        valid, mc / torch.where(s_ec > 0, s_ec, torch.ones_like(s_ec)),
        torch.zeros_like(s_ec),
    )
    contrib = a_over_l * scale[:, ec]
    acc = torch.zeros(n * T, dtype=torch.float64, device=alpha.device)
    acc = acc.index_add_(0, (row * T + tx).flatten(),
                         contrib.flatten()).view(n, T)
    upd = prob.singleton_alpha[act] + acc
    ch = (upd > EM_ALPHA_CHANGE_LIMIT) & (
        (upd - a).abs() / torch.where(upd > 0, upd, torch.ones_like(upd))
        > EM_ALPHA_CHANGE
    )
    nxt[act] = upd
    changed[act] = ch.sum(dim=1).to(torch.int32)
    return nxt, changed


def em_stepper(prob: DeviceEmProblem):
    """step(alpha, mode) -> (next, changed): one batched EM update over
    `prob`, kernel G for a problem on the card (kernels.bind_em_step checks
    its tensors once), the plain version else."""
    if prob.flat_tx.is_cuda:
        return kernels.bind_em_step(prob)
    return lambda alpha, mode: em_step_batch_plain(alpha, prob, mode)


def em_step_batch(alpha: torch.Tensor, prob: DeviceEmProblem,
                  mode: torch.Tensor):
    """One batched EM update: em_stepper(prob)(alpha, mode)."""
    return em_stepper(prob)(alpha, mode)


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
    eff_lens: Optional[np.ndarray] = None   # bias-corrected (when bias ran)
    post_bias: Optional[np.ndarray] = None  # [4096] expected hexamer dist


def _zeroed(a: np.ndarray) -> np.ndarray:
    """The reference's final-round zeroing (EMAlgorithm.h:205-212)."""
    return np.where(a < EM_ALPHA_LIMIT / 10.0, 0.0, a)


def em_inputs(problem: EmProblem, counts: np.ndarray):
    """(singleton_alpha [..., T], multi_counts [..., E]) of EC counts
    [..., n_ec]: next_alpha[t] = counts[singleton ec of t] (assignment;
    each t has at most one singleton EC) -- reference: EMAlgorithm.h:119-123."""
    lead = counts.shape[:-1]
    singleton_alpha = np.zeros(lead + (problem.num_trans,), np.float64)
    if problem.singleton_tx.size:
        singleton_alpha[..., problem.singleton_tx] = \
            counts[..., problem.singleton_ec]
    return singleton_alpha, counts[..., problem.multi_ec_ids].astype(np.float64)


def _alpha0(problem: EmProblem, priors: Optional[np.ndarray]) -> np.ndarray:
    T = problem.num_trans
    if priors is None:
        return np.full(T, 1.0 / T, np.float64)
    return np.asarray(priors, np.float64)


def run_em(
    problem: EmProblem,
    counts: np.ndarray,
    eff_lens: np.ndarray,
    n_iter: int = 10000,
    min_rounds: int = 50,
    priors: Optional[np.ndarray] = None,
    bias_update=None,
    device=None,
    singletons_after: bool = False,
) -> EmResult:
    """Run the EM to convergence in float64 on `device` (default: the card;
    raises without one unless device='cpu'): the loop of run_em_batch with
    one replicate.

    bias_update: optional callable(alpha, eff_lens) -> (eff_lens,
    post_bias), called on the host at the top of global iterations
    min_rounds and min_rounds + 500 unless the loop is done (reference:
    EMAlgorithm.h:113-116; JAX em.py:321-338 runs the same segments).  It
    sees the state alpha, which is the zeroed one when the final round
    starts at that boundary.

    singletons_after: the long-read (PacBio) EM keeps singleton-EC counts
    out of the iterations and adds them to alpha once after the loop
    (reference: EMAlgorithm.h:224-357; JAX em.py:286-299, :342-343)."""
    r = run_em_batch(problem, np.asarray(counts)[None], eff_lens,
                     n_iter=n_iter, min_rounds=min_rounds, priors=priors,
                     bias_update=bias_update, device=device,
                     singletons_after=singletons_after)
    return EmResult(
        alpha=r.alpha[0],
        alpha_before_zeroes=r.alpha_before_zeroes[0],
        n_rounds=int(r.n_rounds[0]),
        eff_lens=r.eff_lens,
        post_bias=r.post_bias,
    )


class EmBatchResult(NamedTuple):
    alpha: np.ndarray                # [Bb, T]
    alpha_before_zeroes: np.ndarray  # [Bb, T]
    n_rounds: np.ndarray             # [Bb] int64
    eff_lens: np.ndarray             # as given, or bias-corrected
    post_bias: Optional[np.ndarray] = None


def run_em_batch(
    problem: EmProblem,
    counts_b: np.ndarray,
    eff_lens: np.ndarray,
    n_iter: int = 10000,
    min_rounds: int = 50,
    priors: Optional[np.ndarray] = None,
    bias_update=None,
    device=None,
    singletons_after: bool = False,
) -> EmBatchResult:
    """The EM of Bb replicates sharing one EC structure (JAX em.py
    _run_em_batch_jax, a vmapped _em_full), in float64 on `device`
    (default: the card; raises without one unless device='cpu').

    counts_b: [Bb, n_ec] EC counts of each replicate; eff_lens: [T] shared
    or [Bb, T] per replicate (JAX's batched_eff); priors: [T] shared
    starting alpha (JAX's alpha_init) or None for uniform; bias_update:
    run_em's hook, for one replicate with shared lengths; singletons_after:
    run_em's long-read variant, per replicate.

    A vmapped while-loop runs while any member's condition holds and
    freezes the others, so each replicate keeps its own iteration count,
    final-round flags and alpha_before_zeroes, exactly as a lone EM would.
    Every replicate still running has run the same number of rounds, i, so
    the host keeps per replicate only its mode: UPDATE, UPDATE_ZEROED
    while it runs its final round (the update reads its alpha zeroed below
    EM_ALPHA_LIMIT / 10, em.py:162-164), FROZEN once done.  Each round is
    one update of the running replicates; from round min_rounds + 1 on, the
    host also reads their change counts (one small device-to-host copy)
    and applies the stop rule (EMAlgorithm.h:171-222)."""
    from .. import resolve_device

    dev = resolve_device(device)
    counts_b = np.asarray(counts_b)
    Bb = counts_b.shape[0]
    cur_eff = eff_lens.astype(np.float64)
    if bias_update is not None and (Bb != 1 or cur_eff.ndim != 1):
        raise ValueError("bias_update needs one replicate and shared lengths")
    singleton_b, multi_b = em_inputs(problem, counts_b)
    post_singletons = None
    if singletons_after:
        post_singletons = singleton_b
        singleton_b = np.zeros_like(singleton_b)
    prob = device_em_problem(problem, singleton_b, multi_b, 1.0 / cur_eff, dev)
    step = em_stepper(prob)
    alpha = torch.from_numpy(np.tile(_alpha0(problem, priors), (Bb, 1))).to(dev)
    before = alpha
    mode = np.full(Bb, UPDATE, np.int32)
    mode_t = torch.from_numpy(mode).to(dev)
    done_at = np.full(Bb, -1, np.int64)  # i after a replicate's final round
    running, zeroing = Bb, False  # replicates not FROZEN; any UPDATE_ZEROED
    post_bias = None
    i = 0
    bounds = (n_iter,) if bias_update is None else (
        min_rounds, min_rounds + 500, n_iter)
    for seg, bound in enumerate(bounds):
        if seg:
            if not running:  # converged in the previous segment
                break
            a = alpha[0].cpu().numpy()
            cur_eff, post_bias = bias_update(_zeroed(a) if zeroing else a,
                                             cur_eff)
            prob = prob._replace(
                inv_eff=torch.from_numpy(1.0 / cur_eff).to(dev))
            step = em_stepper(prob)
        while i < bound and running:
            nxt, changed = step(alpha, mode_t)
            if i > min_rounds:
                ch = changed.cpu().numpy()
                # a FROZEN replicate counts no change: unless one is in its
                # final round, nothing happens while `running` counts are
                # nonzero
                if zeroing or np.count_nonzero(ch) < running:
                    # the UPDATE_ZEROED replicates have run their final
                    # round; it starts for those that changed nothing
                    start = (mode == UPDATE) & (ch == 0)
                    ended = mode == UPDATE_ZEROED
                    done_at[ended] = i + 1
                    running -= int(ended.sum())
                    zeroing = bool(start.any())
                    if zeroing:
                        before = torch.where(
                            torch.from_numpy(start).to(dev)[:, None], nxt,
                            before)
                    mode = np.where(ended, FROZEN, np.where(
                        start, UPDATE_ZEROED, mode)).astype(np.int32)
                    mode_t = torch.from_numpy(mode).to(dev)
            alpha = nxt
            i += 1

    alpha_h = alpha.cpu().numpy()
    # a replicate that ran out of iterations right after starting its
    # final round holds the zeroed alpha as its state
    pending = mode == UPDATE_ZEROED
    alpha_h[pending] = _zeroed(alpha_h[pending])
    # one that ran out without converging reports its final alpha as
    # alpha_before_zeroes (reference: EMAlgorithm.h:359-365), and the
    # reference reports the 0-based index at break (EMAlgorithm.h:369)
    done = done_at >= 0
    before_h = np.where(done[:, None], before.cpu().numpy(), alpha_h)
    if post_singletons is not None:
        alpha_h = alpha_h + post_singletons
    return EmBatchResult(alpha=alpha_h, alpha_before_zeroes=before_h,
                         n_rounds=np.where(done, done_at - 1, i),
                         eff_lens=cur_eff, post_bias=post_bias)


def counts_to_tpm(est_counts: np.ndarray, eff_lens: np.ndarray) -> np.ndarray:
    """reference: counts_to_tpm (src/PlaintextWriter.cpp:5-27)."""
    tpm = est_counts / eff_lens
    return tpm / tpm.sum() * 1e6
