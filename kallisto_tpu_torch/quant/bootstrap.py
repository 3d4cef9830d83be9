"""Bootstrap uncertainty estimation: multinomial resampling + batched EM.

Port of kallisto_tpu/quant/bootstrap.py (reference: src/Bootstrap.{h,cpp}
+ src/Multinomial.hpp).  The reference resamples n = sum(counts) draws
from a discrete distribution weighted by the EC counts
(Multinomial::sample, Multinomial.hpp:33-51) -- i.e. a multinomial -- then
reruns the EM per replicate in a thread pool.  Here all replicates run as
one batched EM (quant/em.py run_em_batch: kernel G on the card), in
float64 wherever it runs.

Seeds come from std::mt19937_64(opt.seed) exactly as the reference draws
them (main.cpp:2746-2752); the multinomial sampler itself is numpy's
(std::discrete_distribution's stream is implementation-defined, so
draw-level parity is not possible even between libstdc++ versions).  Both
run on the host, as in the JAX package, so the resampled counts are equal
to its own.
"""

from typing import List

import numpy as np

from ..utils.mt19937 import MT19937_64
from .em import EmProblem, run_em_batch


def bootstrap_seeds(seed: int, n: int) -> List[int]:
    g = MT19937_64(seed)
    return [g() for _ in range(n)]


def resample_counts(counts: np.ndarray, seed: int) -> np.ndarray:
    """One multinomial resample of the EC count vector."""
    n = int(counts.sum())
    rng = np.random.Generator(np.random.PCG64(seed))
    p = counts.astype(np.float64)
    return rng.multinomial(n, p / p.sum()).astype(np.float64)


def run_bootstraps(
    problem: EmProblem,
    counts: np.ndarray,
    eff_lens: np.ndarray,
    n_bootstrap: int,
    seed: int,
    n_iter: int = 10000,
    min_rounds: int = 50,
    device=None,
) -> np.ndarray:
    """Bootstrap alphas [n_bootstrap, T], from one batched EM on `device`
    (default: the card; raises without one unless device='cpu')."""
    resampled = np.stack([resample_counts(counts, s)
                          for s in bootstrap_seeds(seed, n_bootstrap)])
    return run_em_batch(problem, resampled, eff_lens, n_iter=n_iter,
                        min_rounds=min_rounds, device=device).alpha
