"""Fragment-length distribution and effective-length machinery.

reference: src/MinCollector.cpp:583-651 (FLD moments), src/weights.cpp
(truncated-gaussian FLD, conditional means, effective lengths, weights).
All are tiny dense vector computations; they run host-side in float64 for
exact parity.
"""

import numpy as np

from ..common import MAX_FRAG_LEN


def compute_mean_frag_lens_trunc(flens: np.ndarray) -> np.ndarray:
    """mean_fl_trunc[i] = mean fragment length among fragments <= i.

    reference: MinCollector::compute_mean_frag_lens_trunc
    (src/MinCollector.cpp:629-651); entries with no observations stay 0.
    """
    flens = flens.astype(np.float64)
    i = np.arange(MAX_FRAG_LEN, dtype=np.float64)
    mass = np.cumsum(flens * i)
    counts = np.cumsum(flens)
    out = np.zeros(MAX_FRAG_LEN, np.float64)
    nz = counts > 0
    out[nz] = mass[nz] / counts[nz]
    out[0] = 0.0  # reference writes counts[0] but never mean_fl_trunc[0]
    return out


def trunc_gaussian_fld(start: int, stop: int, mean: float, sd: float) -> np.ndarray:
    """Conditional means of a truncated gaussian (reference:
    trunc_gaussian_fld, src/weights.cpp:248-271)."""
    n = stop - start
    x = (np.arange(start, stop, dtype=np.float64) - mean) / sd
    dens = np.exp(-0.5 * x * x) / sd
    i = np.arange(n, dtype=np.float64)
    total_mass = np.cumsum(dens * i)
    total_density = np.cumsum(dens)
    out = np.zeros(n, np.float64)
    pos = total_mass > 0
    out[pos] = total_mass[pos] / total_density[pos]
    return out


def trunc_gaussian_counts(
    start: int, stop: int, mean: float, sd: float, total_count: int
) -> np.ndarray:
    """Pseudo-observed FLD histogram from -l/-s (reference:
    trunc_gaussian_counts, src/weights.cpp:273-296)."""
    x = (np.arange(start, stop, dtype=np.float64) - mean) / sd
    dens = np.exp(-0.5 * x * x) / sd
    total_mass = dens.sum()
    # C++ (int)std::round -> round-half-away-from-zero
    vals = dens * total_count / total_mass
    return np.floor(vals + 0.5).astype(np.uint32)


def get_frag_len_means(lengths: np.ndarray, mean_fl_trunc: np.ndarray) -> np.ndarray:
    """Per-target conditional mean fragment length (reference:
    get_frag_len_means, src/weights.cpp:7-28)."""
    lengths = lengths.astype(np.int64)
    marginal = mean_fl_trunc[MAX_FRAG_LEN - 1]
    idx = np.minimum(lengths, MAX_FRAG_LEN - 1)
    out = mean_fl_trunc[idx]
    out = np.where(lengths >= MAX_FRAG_LEN, marginal, out)
    return out


def calc_eff_lens(lengths: np.ndarray, means: np.ndarray) -> np.ndarray:
    """eff_len = len - cond_mean + 1, floored to len when < 1
    (reference: calc_eff_lens, src/weights.cpp:58-79)."""
    lens_d = lengths.astype(np.float64)
    eff = lens_d - means + 1.0
    return np.where(eff < 1.0, lens_d, eff)


def mean_from_flens(flens: np.ndarray) -> float:
    """reference: MinCollector::get_mean_frag_len (src/MinCollector.cpp:583)."""
    total = flens.sum()
    if total == 0:
        raise ValueError(
            "could not determine mean fragment length from paired end reads; "
            "rerun with a pre-specified fragment length (-l)"
        )
    i = np.arange(flens.shape[0], dtype=np.float64)
    return float((flens * i).sum() / total)
