"""The EM abundance quantifier, float64, its round loop on the card.

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
_run_em_batch_jax).  Each round is one update of every running replicate
and the stop rule, per replicate: kernel G (csrc/em.cu) on the card, the
plain versions below (em_step_batch_plain, em_stop_plain: em_round_plain)
on the CPU; both sum in the same fixed ascending order, so they agree
bitwise.  The loop's state lives on the device (EmLoop): alpha in two
buffers, the round counter, the bound of the current segment and each
replicate's mode and done_at, as JAX's vmapped while-loop keeps them on
its device, so replicate b's result equals a lone run_em on its counts.
The host runs EM_CHUNK rounds at a time -- on the card one CUDA graph
replay -- and reads the state once per chunk; a round past the segment's
bound or after every replicate froze does nothing.  It runs in float64 on
the card: the JAX package drops the batched EM to float32 on its
accelerator only because the TPU has no float64 (em.py:46-71), while the
H100 has it natively, so the card's replicates stay equal to the float64
CPU leg.
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


def em_stop_plain(st: torch.Tensor, changed: torch.Tensor,
                  min_rounds: int) -> None:
    """Plain version of kernel G's stop step, in place on the loop state
    st [4 + 3 Bb] int64 (i, bound, running, 0, mode[Bb], done_at[Bb],
    last[Bb]) from the round's change counts, which it keeps in last:
    after round min_rounds a replicate in its final round ends (FROZEN,
    done_at = i + 1) and an updating one that changed nothing starts its
    final round (UPDATE_ZEROED); then i += 1.  Does nothing when the round
    did not run (i >= bound or no replicate running)."""
    i, bound, running = (int(x) for x in st[:3])
    if not (i < bound and running > 0):
        return
    Bb = int(changed.shape[0])
    mode, done_at = st[4:4 + Bb], st[4 + Bb:4 + 2 * Bb]
    st[4 + 2 * Bb:] = changed.to(st.device)
    if i > min_rounds:
        ended = mode == UPDATE_ZEROED
        start = (mode == UPDATE) & (changed.to(mode.device) == 0)
        done_at[ended] = i + 1
        mode[ended] = FROZEN
        mode[start] = UPDATE_ZEROED
        st[2] = running - int(ended.sum())
    st[0] = i + 1


def em_round_plain(prob: DeviceEmProblem, bufs: torch.Tensor,
                   st: torch.Tensor, min_rounds: int) -> None:
    """Plain version of one round of kernel G's loop, in place on its
    state (bufs [2, T, Bb] alpha, replicate-minor; st as em_stop_plain):
    when the round runs, em_step_batch_plain on bufs[i & 1] writes the
    running replicates' columns of the other buffer (a frozen column is
    left as it is), then em_stop_plain."""
    i, bound, running = (int(x) for x in st[:3])
    if not (i < bound and running > 0):
        return
    Bb = int(bufs.shape[2])
    mode = st[4:4 + Bb].to(torch.int32)
    src = i & 1
    nxt, changed = em_step_batch_plain(bufs[src].t().contiguous(), prob, mode)
    upd = mode != FROZEN
    bufs[src ^ 1][:, upd] = nxt[upd].t()
    em_stop_plain(st, changed, min_rounds)


# rounds per chunk of the loop: one CUDA graph replay and one host read of
# the state on the card
EM_CHUNK = 32


class EmLoop:
    """The EM's round loop on the problem's device.  State: bufs [2, T, Bb]
    f64 (alpha, both buffers start at alpha0: [T] shared or [Bb, T]), st
    [4 + 3 Bb] int64 (i, bound, running, 0, mode[Bb], done_at[Bb],
    last[Bb]; mode defaults to UPDATE) and the change counts.  run_chunk()
    runs `rounds` rounds: on the card one replay of kernel G's graph of
    that many rounds (built here, once), on the CPU em_round_plain that
    many times.  read() is the host's only read of the state."""

    def __init__(self, prob: DeviceEmProblem, alpha0: np.ndarray,
                 min_rounds: int, mode: Optional[np.ndarray] = None,
                 rounds: Optional[int] = None):
        dev = prob.flat_tx.device
        Bb, T = (int(x) for x in prob.singleton_alpha.shape)
        self.prob, self.min_rounds = prob, int(min_rounds)
        self.rounds = int(rounds or EM_CHUNK)
        self.Bb, self.T = Bb, T
        a0 = torch.from_numpy(np.ascontiguousarray(alpha0, np.float64)).to(dev)
        a0 = a0[:, None] if a0.dim() == 1 else a0.t()
        self.bufs = a0[None].expand(2, T, Bb).contiguous()
        mode = np.full(Bb, UPDATE, np.int64) if mode is None else mode
        st = np.concatenate([[0, 0, int((mode != FROZEN).sum()), 0],
                             mode, np.full(Bb, -1),
                             np.zeros(Bb)]).astype(np.int64)
        self.st = torch.from_numpy(st).to(dev)
        self.changed = torch.zeros(Bb, dtype=torch.int32, device=dev)
        self.reads = 0
        self._graph = None
        if dev.type == "cuda":
            self._graph = kernels.EmGraph(prob, self.bufs, self.st,
                                          self.changed, min_rounds,
                                          self.rounds)

    def set_bound(self, bound: int) -> None:
        """Rounds run while i < bound."""
        self.st[1] = int(bound)

    def set_inv_eff(self, inv_eff: np.ndarray) -> None:
        """New shared lengths (bias segments), in place: the card's graph
        reads the problem's own inv_eff tensor."""
        self.prob.inv_eff.copy_(torch.from_numpy(inv_eff))

    def run_chunk(self) -> None:
        if self._graph is not None:
            self._graph.launch()
            return
        for _ in range(self.rounds):
            em_round_plain(self.prob, self.bufs, self.st, self.min_rounds)

    def read(self, with_alpha: bool = False):
        """One host read: (st, and with_alpha both alpha buffers [2, T, Bb]
        else None) as numpy copies."""
        self.reads += 1
        n = self.st.shape[0]
        if with_alpha:
            both = torch.cat([self.st, self.bufs.view(torch.int64).view(-1)])
            h = both.to("cpu", copy=True).numpy()
            st, bufs = h[:n], h[n:].view(np.float64).reshape(2, self.T,
                                                               self.Bb)
        else:
            st, bufs = self.st.to("cpu", copy=True).numpy(), None
        return st, bufs

    def close(self) -> None:
        if self._graph is not None:
            self._graph.close()
            self._graph = None


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
    host_reads: int = 0                     # reads of the loop's state
    rounds: int = 0                         # rounds that ran (the state's i)


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
        host_reads=r.host_reads,
        rounds=r.rounds,
    )


class EmBatchResult(NamedTuple):
    alpha: np.ndarray                # [Bb, T]
    alpha_before_zeroes: np.ndarray  # [Bb, T]
    n_rounds: np.ndarray             # [Bb] int64
    eff_lens: np.ndarray             # as given, or bias-corrected
    post_bias: Optional[np.ndarray] = None
    host_reads: int = 0              # reads of the loop's state (EmLoop)
    rounds: int = 0                  # rounds that ran (the state's i)


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
    Every replicate still running has run the same number of rounds, i;
    EmLoop keeps per replicate its mode (UPDATE, UPDATE_ZEROED while it
    runs its final round, FROZEN once done) and done_at, and the stop rule
    runs on the device after each round.  The host runs EM_CHUNK rounds at
    a time and reads the state once per chunk (host_reads; the chunk that
    may reach a bias segment's bound brings alpha back with it), and
    alpha once at the end; the chunks of a segment end at its bound
    (min_rounds, min_rounds + 500 under bias_update, n_iter)."""
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
    loop = EmLoop(prob, _alpha0(problem, priors), min_rounds)
    post_bias = None
    i, running = 0, Bb
    bufs_h, i_a = None, -1  # the last alpha read, at round i_a
    bounds = (n_iter,) if bias_update is None else (
        min_rounds, min_rounds + 500, n_iter)
    try:
        for seg, bound in enumerate(bounds):
            if seg:
                if not running:  # converged in the previous segment
                    break
                if i_a != i:
                    st_h, bufs_h = loop.read(with_alpha=True)
                    i_a = i
                a = bufs_h[i % 2, :, 0].copy()
                zeroing = st_h[4] == UPDATE_ZEROED
                cur_eff, post_bias = bias_update(_zeroed(a) if zeroing else a,
                                                 cur_eff)
                loop.set_inv_eff(1.0 / cur_eff)
            if i >= bound:
                continue
            loop.set_bound(bound)
            # the chunk that may end this segment also brings alpha back
            # when a bias update follows
            ahead = bias_update is not None and seg + 1 < len(bounds)
            while i < bound and running:
                loop.run_chunk()
                want = ahead and i + loop.rounds >= bound
                st_h, b = loop.read(with_alpha=want)
                i, running = int(st_h[0]), int(st_h[2])
                if want:
                    bufs_h, i_a = b, i
        st_h, bufs_h = loop.read(with_alpha=True)
    finally:
        loop.close()

    mode, done_at = st_h[4:4 + Bb], st_h[4 + Bb:4 + 2 * Bb]
    both = bufs_h.transpose(0, 2, 1)  # [2, Bb, T]
    rows = np.arange(Bb)
    # a replicate that ended after round done_at - 1 holds alpha in buffer
    # done_at % 2 and the raw input of its final round in the other; the
    # others hold it in buffer i % 2
    done = done_at >= 0
    alpha_h = both[np.where(done, done_at % 2, i % 2), rows]
    # a replicate that ran out of iterations right after starting its
    # final round holds the zeroed alpha as its state
    pending = mode == UPDATE_ZEROED
    alpha_h[pending] = _zeroed(alpha_h[pending])
    # one that ran out without converging reports its final alpha as
    # alpha_before_zeroes (reference: EMAlgorithm.h:359-365), and the
    # reference reports the 0-based index at break (EMAlgorithm.h:369)
    before_h = np.where(done[:, None], both[(done_at - 1) % 2, rows],
                        alpha_h)
    if post_singletons is not None:
        alpha_h = alpha_h + post_singletons
    return EmBatchResult(alpha=alpha_h, alpha_before_zeroes=before_h,
                         n_rounds=np.where(done, done_at - 1, i),
                         eff_lens=cur_eff, post_bias=post_bias,
                         host_reads=loop.reads, rounds=i)


def counts_to_tpm(est_counts: np.ndarray, eff_lens: np.ndarray) -> np.ndarray:
    """reference: counts_to_tpm (src/PlaintextWriter.cpp:5-27)."""
    tpm = est_counts / eff_lens
    return tpm / tpm.sum() * 1e6
