"""kallisto 0.51.1's effective lengths and EM (weights.cpp, MinCollector.cpp,
EMAlgorithm.h), plain PyTorch on the CPU in a chosen precision."""

import numpy as np
import torch

from .align import MAX_FRAG_LEN

ALPHA_LIMIT = 1e-7
ALPHA_CHANGE_LIMIT = 1e-2
ALPHA_CHANGE = 1e-2
TOLERANCE = 5e-324


def effective_lengths(lens: np.ndarray, flens: np.ndarray) -> np.ndarray:
    """eff = len - mean fragment length among fragments no longer than len
    (all fragments for len >= MAX_FRAG_LEN) + 1; len itself where that is
    under 1."""
    fl = flens.astype(np.float64)
    i = np.arange(MAX_FRAG_LEN, dtype=np.float64)
    mass, cnt = np.cumsum(fl * i), np.cumsum(fl)
    mean = np.divide(mass, cnt, out=np.zeros(MAX_FRAG_LEN), where=cnt > 0)
    mean[0] = 0.0
    L = lens.astype(np.int64)
    m = np.where(L >= MAX_FRAG_LEN, mean[-1],
                 mean[np.minimum(L, MAX_FRAG_LEN - 1)])
    eff = L - m + 1.0
    return np.where(eff < 1.0, L.astype(np.float64), eff)


def run_em(classes: dict, T: int, eff: np.ndarray, dtype=torch.float64,
           n_iter: int = 10000, min_rounds: int = 50) -> np.ndarray:
    """est_counts from {class (tuple of transcripts): count}.  Starts from
    1/T; a round gives each transcript its single-transcript class's count
    plus its share of every other class; after round min_rounds, once no
    transcript above ALPHA_CHANGE_LIMIT changes by more than ALPHA_CHANGE,
    one final round runs from alpha with values under ALPHA_LIMIT / 10
    set to 0."""
    single = torch.zeros(T, dtype=dtype)
    tx, ec, cnt = [], [], []
    for s, c in classes.items():
        if len(s) == 1:
            single[s[0]] = float(c)
        else:
            tx.extend(s)
            ec.extend([len(cnt)] * len(s))
            cnt.append(float(c))
    tx = torch.tensor(tx, dtype=torch.int64)
    ec = torch.tensor(ec, dtype=torch.int64)
    cnt = torch.tensor(cnt, dtype=dtype)
    E = cnt.shape[0]
    inv = torch.from_numpy(1.0 / eff).to(dtype)
    alpha = torch.full((T,), 1.0 / T, dtype=dtype)
    final = False
    for i in range(n_iter):
        if final:
            alpha = torch.where(alpha < ALPHA_LIMIT / 10.0,
                                torch.zeros_like(alpha), alpha)
        w = alpha[tx] * inv[tx]
        s = torch.zeros(E, dtype=dtype).index_add_(0, ec, w)
        ok = (cnt > 0) & (cnt * s >= TOLERANCE)
        scale = torch.where(ok, cnt / torch.where(s > 0, s, torch.ones_like(s)),
                            torch.zeros_like(s))
        nxt = single + torch.zeros(T, dtype=dtype).index_add_(0, tx,
                                                             w * scale[ec])
        changed = ((nxt > ALPHA_CHANGE_LIMIT)
                   & ((nxt - alpha).abs()
                      / torch.where(nxt > 0, nxt, torch.ones_like(nxt))
                      > ALPHA_CHANGE)).sum()
        alpha = nxt
        if final:
            break
        if i > min_rounds and int(changed) == 0:
            final = True
    else:
        if final:  # out of rounds as the final round was due
            alpha = torch.where(alpha < ALPHA_LIMIT / 10.0,
                                torch.zeros_like(alpha), alpha)
    return alpha.to(torch.float64).numpy()
