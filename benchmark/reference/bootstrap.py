"""kallisto 0.51.1's bootstrap replicates (main.cpp, Bootstrap.cpp), in
NumPy and plain PyTorch: the seeds, the resampled class counts and each
replicate's EM.

Replicate b's seed is the b-th output of MT19937-64 seeded with the run's
`--seed`, as kallisto's main.cpp draws them. The draw itself departs from
kallisto: its std::discrete_distribution gives a stream that each C++
library defines for itself, so no two builds agree draw for draw. Here, as
in the program judged, a replicate is NumPy's
`Generator(PCG64(seed)).multinomial(n, counts / n)` over the classes.

A multinomial's draw depends on the order of its categories, and the order
of the classes is a label the program gives them (its EC ids), which no
independent reference can derive. So the replicates are drawn over the
classes in the order a judged output lists them, with the reference's own
count of each class, and kept per order: `Replicates.for_order`.

Each replicate's est_counts come from the EM of `em.run_em`, run for all
replicates at once as an [R, T] alpha; a replicate that has run its final
round is frozen while the others go on.
"""

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .em import ALPHA_CHANGE, ALPHA_CHANGE_LIMIT, ALPHA_LIMIT, TOLERANCE

_MASK = (1 << 64) - 1
_NN, _MM = 312, 156
_MATRIX_A = 0xB5026F5AA96619E9
_UPPER, _LOWER = 0xFFFFFFFF80000000, 0x7FFFFFFF
# how many rounds run between two looks at whether every replicate is done
# (a round on frozen replicates changes nothing)
_LOOK_EVERY = 16


class MT19937_64:
    """The 64-bit Mersenne Twister of the C++ standard (std::mt19937_64)."""

    def __init__(self, seed: int):
        mt = [int(seed) & _MASK]
        for i in range(1, _NN):
            x = mt[-1]
            mt.append((6364136223846793005 * (x ^ (x >> 62)) + i) & _MASK)
        self.mt, self.i = mt, _NN

    def _twist(self) -> None:
        mt = self.mt
        for i in range(_NN):
            x = (mt[i] & _UPPER) | (mt[(i + 1) % _NN] & _LOWER)
            mt[i] = mt[(i + _MM) % _NN] ^ (x >> 1) ^ (_MATRIX_A if x & 1
                                                       else 0)
        self.i = 0

    def __call__(self) -> int:
        if self.i >= _NN:
            self._twist()
        x = self.mt[self.i]
        self.i += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        return x ^ (x >> 43)


def seeds(seed: int, n: int) -> list:
    g = MT19937_64(seed)
    return [g() for _ in range(n)]


def draw(counts: np.ndarray, seed: int) -> np.ndarray:
    """One multinomial resample of the class counts, in their order."""
    n = int(counts.sum())
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.multinomial(n, counts.astype(np.float64) / n).astype(
        np.float64)


def run_em_replicates(order: Sequence[tuple], counts: np.ndarray, T: int,
                      eff: np.ndarray, dtype=torch.float64, device="cpu",
                      n_iter: int = 10000, min_rounds: int = 50) -> np.ndarray:
    """est_counts [R, T] of R count vectors over the classes `order`
    (counts [R, len(order)]), each by `em.run_em`'s rules: alpha from 1/T,
    a single-transcript class's count to its transcript, every other
    class's count shared in proportion to alpha / eff; after round
    min_rounds, once no transcript above ALPHA_CHANGE_LIMIT changes by more
    than ALPHA_CHANGE, one final round from alpha with values under
    ALPHA_LIMIT / 10 set to 0, after which the replicate is frozen."""
    R = counts.shape[0]
    one = [(i, s[0]) for i, s in enumerate(order) if len(s) == 1]
    multi = [i for i, s in enumerate(order) if len(s) > 1]
    tx = [t for i in multi for t in order[i]]
    ec = [j for j, i in enumerate(multi) for _ in order[i]]
    c = torch.from_numpy(np.ascontiguousarray(counts, np.float64))
    single = torch.zeros(R, T, dtype=torch.float64)
    if one:
        cols, ts = zip(*one)
        single.index_add_(1, torch.tensor(ts), c[:, list(cols)])
    single = single.to(device, dtype)
    cnt = c[:, multi].to(device, dtype)
    tx = torch.tensor(tx, dtype=torch.int64, device=device)
    ec = torch.tensor(ec, dtype=torch.int64, device=device)
    E = len(multi)
    inv = torch.from_numpy(1.0 / eff).to(device, dtype)[tx]
    alpha = torch.full((R, T), 1.0 / T, dtype=dtype, device=device)
    final = torch.zeros(R, 1, dtype=torch.bool, device=device)
    done = torch.zeros(R, 1, dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)

    def zeroed(a):
        return torch.where(a < ALPHA_LIMIT / 10.0, zero, a)

    for i in range(n_iter):
        a = torch.where(final, zeroed(alpha), alpha)
        w = a[:, tx] * inv
        s = torch.zeros(R, E, dtype=dtype, device=device).index_add_(1, ec, w)
        ok = (cnt > 0) & (cnt * s >= TOLERANCE)
        scale = torch.where(ok, cnt / torch.where(s > 0, s, 1.0), zero)
        nxt = single + torch.zeros(R, T, dtype=dtype, device=device
                                   ).index_add_(1, tx, w * scale[:, ec])
        changed = ((nxt > ALPHA_CHANGE_LIMIT)
                   & ((nxt - a).abs() / torch.where(nxt > 0, nxt, 1.0)
                      > ALPHA_CHANGE)).sum(1, keepdim=True)
        alpha = torch.where(done, alpha, nxt)
        done = done | final
        if i > min_rounds:
            final = final | (~done & (changed == 0))
        if i % _LOOK_EVERY == _LOOK_EVERY - 1 and bool(done.all()):
            break
    else:  # out of rounds: a final round that was due is applied as run_em
        alpha = torch.where(final & ~done, zeroed(alpha), alpha)
    return alpha.to(torch.float64).cpu().numpy()


class Replicates:
    """A sample's B bootstrap replicates, drawn from its classes (the
    reference's {class: count}) in a given order, solved, and kept per
    order."""

    def __init__(self, classes: Dict[tuple, int], T: int, eff: np.ndarray,
                 n_bootstrap: int, seed: int, est_counts: np.ndarray,
                 dtype=torch.float64, device="cpu"):
        self.classes, self.T, self.eff = classes, T, eff
        self.B, self.seed, self.est = n_bootstrap, seed, est_counts
        self.dtype, self.device = dtype, device
        self._by_order: Dict[Tuple[tuple, ...], np.ndarray] = {}

    def for_order(self, order: Sequence[tuple]) -> np.ndarray:
        """[B, T] est_counts of the replicates drawn over the classes in
        `order`, each with its count in the sample (0 where it has none)."""
        key = tuple(tuple(c) for c in order)
        if key not in self._by_order:
            self._by_order[key] = self._solve(key)
        return self._by_order[key]

    def _solve(self, order: Tuple[tuple, ...]) -> np.ndarray:
        if not self.classes:
            # nothing aligned: kallisto writes the main EM's result for
            # every bootstrap (main.cpp)
            return np.tile(self.est, (self.B, 1))
        counts = np.array([self.classes.get(c, 0) for c in order],
                          np.float64)
        drawn = np.stack([draw(counts, s) for s in seeds(self.seed, self.B)])
        return run_em_replicates(order, drawn, self.T, self.eff, self.dtype,
                                 self.device)
