"""End-to-end quantification: FASTQ -> device pseudoalignment -> EC counts
-> EM -> abundance outputs.

Port of kallisto_tpu/quant/pipeline.py, cut down to its per-read ("full")
path for every batch (JAX pipeline.py:925-938 dispatch, :1277-1343 host
side; single-end: the "full" branches of dispatch_single/process_single).
Per batch, kernel A reduces each mate to its EC rows and first hit,
kernel B hashes each pair into a 128-bit key and computes its mapPair
fragment length, and the host resolves first-seen keys, applies the
filters and counts ECs in read order.  FLD learning, overflow recovery,
--min-range, the FLD position filter, strand filters and priors are here;
the EM runs on the device through kernel C.

Not ported yet (each raises NotImplementedError): bias, bootstraps,
pseudobam/genomebam, long reads, several devices, and the TPU package's
compact / anchor / host-wave-1 routes, which are speed paths with the same
outputs as this one.
"""

import os
import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import KALLISTO_COMPAT_VERSION, resolve_device
from ..common import MAX_FRAG_LEN, Options, REFERENCE_INDEX_VERSION
from ..index import load_index
from ..index.build import TpuIndex
from ..io import writers
from ..io.fastx import PackedBatch, packed_paired_batches, packed_single_batches
from ..ops.host_fallback import host_side_rows
from ..ops.pseudoalign import (
    SideResult,
    device_index_from_host,
    pseudoalign_batch_packed,
    read_keys,
    upload_batch,
)
from .ecmap import EcResolver
from .em import EmResult, build_em_problem, counts_to_tpm, read_priors, run_em
from .filters import FldPositionFilter, StrandFilter
from .fld import (
    calc_eff_lens,
    compute_mean_frag_lens_trunc,
    get_frag_len_means,
    trunc_gaussian_counts,
    trunc_gaussian_fld,
)

_FLEN_GOAL = 10000  # reference: ProcessReads.cpp:985


def _log(msg: str, end: str = "\n"):
    print(msg, file=sys.stderr, end=end, flush=True)


@dataclass
class QuantResult:
    target_names: List[str]
    target_lens: np.ndarray
    eff_lens: np.ndarray
    est_counts: np.ndarray
    tpm: np.ndarray
    em: EmResult
    counts: np.ndarray
    ec_sets: List[np.ndarray]
    flens: np.ndarray
    num_processed: int
    num_pseudoaligned: int
    num_unique: int
    fld: np.ndarray
    timings: dict


def _check_supported(opt: Options) -> None:
    unported = [
        (opt.bias, "--bias"),
        (opt.bootstrap > 0, "bootstraps (-b)"),
        (opt.pseudobam, "--pseudobam"),
        (opt.genomebam, "--genomebam"),
        (opt.long_read, "--long"),
        (opt.n_devices > 1 or opt.threads > 1, "several devices (-t > 1)"),
    ]
    for flag, what in unported:
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet to kallisto_tpu_torch"
            )


def _pair_exemplars(s1: SideResult, s2: SideResult):
    """Exemplar fetcher for first-seen pair keys: the key layout of the
    JAX full path ([rows1 (R), rows2 (R), flags], int32), by host indexing
    of the once-fetched side arrays."""
    flags = (
        s1.has_hits.astype(np.int32) + 2 * s2.has_hits.astype(np.int32)
        + 4 * s1.overflow.astype(np.int32) + 8 * s2.overflow.astype(np.int32)
    )

    def fetch(idx: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [s1.rows[idx], s2.rows[idx], flags[idx][:, None]], axis=1
        )

    return fetch


def _single_exemplars(s1: SideResult):
    flags = s1.has_hits.astype(np.int32) + 4 * s1.overflow.astype(np.int32)

    def fetch(idx: np.ndarray) -> np.ndarray:
        return np.concatenate([s1.rows[idx], flags[idx][:, None]], axis=1)

    return fetch


def _apply_overflow_fallback(
    resolver, index, read_uidx, uniq_sets, do_union, side1, side2
):
    """Re-resolve reads whose device row list overflowed (host oracle).

    Mutates read_uidx in place to point at freshly appended uniq_sets
    entries for the affected reads.
    """
    s1, b1 = side1
    ovf = s1.overflow.copy()
    if side2 is not None:
        s2, b2 = side2
        ovf |= s2.overflow
    for r in np.flatnonzero(ovf):
        rows1, hits1 = host_side_rows(index, b1.row_codes(r), int(b1.lens[r]))
        if side2 is not None:
            rows2, hits2 = host_side_rows(index, b2.row_codes(r), int(b2.lens[r]))
            u = resolver.resolve_rows(rows1, hits1, rows2, hits2, True, do_union)
        else:
            u = resolver.resolve_rows(
                rows1, hits1, np.empty(0, np.int32), False, False, do_union
            )
        read_uidx[r] = len(uniq_sets)
        uniq_sets.append(u)


def run_quant(opt: Options, index: Optional[TpuIndex] = None,
              device=None) -> QuantResult:
    """Quantify `opt.files` against `index` on `device` (default: the card;
    raises without one unless device='cpu')."""
    _check_supported(opt)
    dev = resolve_device(device)
    start_time = time.strftime("%a %b %d %H:%M:%S %Y")
    # host wall seconds by phase: index upload, FASTQ read + pack, upload +
    # kernel enqueue, device->host fetch (includes waiting for the
    # kernels), host resolution/filters/counting, the whole read loop, EM
    timings = dict.fromkeys(
        ("index_upload_s", "read_s", "dispatch_s", "fetch_s", "resolve_s",
         "pseudoalign_s", "em_s"), 0.0)
    t0 = time.perf_counter()
    if index is None:
        index = load_index(opt.index_path)
    didx = device_index_from_host(index, dev)
    timings["index_upload_s"] = time.perf_counter() - t0
    resolver = EcResolver(index)
    k = index.k

    paired = opt.paired
    estimate_fld = paired and opt.fld_mean == 0.0
    flens = np.zeros(MAX_FRAG_LEN, np.int64)
    fl_samples: List[np.ndarray] = []  # eligible lengths in READ order
    tlencount = 0
    num_processed = 0

    pos_filter: Optional[FldPositionFilter] = None
    if opt.fld_mean > 0 and not opt.single_overhang:
        pos_filter = FldPositionFilter(index, fl=int(opt.fld_mean))
    strand_filter: Optional[StrandFilter] = None
    if opt.strand in ("fr", "rf"):
        strand_filter = StrandFilter(index, opt.strand)

    def dispatch(b1: PackedBatch, b2: Optional[PackedBatch]):
        """Enqueue one batch on the device (asynchronous on the card)."""
        r1 = pseudoalign_batch_packed(didx, *upload_batch(b1, dev), k=k, L=b1.Lp)
        r2 = None
        if b2 is not None:
            r2 = pseudoalign_batch_packed(
                didx, *upload_batch(b2, dev), k=k, L=b2.Lp
            )
        h, tl = read_keys(r1, r2, k)
        return b1, b2, r1, r2, h, tl

    def process(ctx):
        nonlocal num_processed, tlencount
        b1, b2, r1, r2, h, tl = ctx
        t1 = time.perf_counter()
        # one device->host copy of each per-read array per batch (waits for
        # the batch's kernels)
        s1 = r1.to_numpy()
        s2 = r2.to_numpy() if r2 is not None else None
        hh = h.cpu().numpy()
        tl_h = tl.cpu().numpy() if tl is not None else None
        t2 = time.perf_counter()
        timings["fetch_s"] += t2 - t1
        R = int(s1.rows.shape[1])
        fetch = _pair_exemplars(s1, s2) if paired else _single_exemplars(s1)
        read_uidx, uniq_sets = resolver.resolve_batch_hashed(
            hh, fetch, R, paired=paired, do_union=opt.do_union,
        )
        _apply_overflow_fallback(
            resolver, index, read_uidx, uniq_sets, opt.do_union, (s1, b1),
            (s2, b2) if paired else None,
        )
        final_idx, final_sets = read_uidx, uniq_sets
        if opt.min_range > 1:
            # a mate whose hit span is under min_range empties its EC set
            # inside intersectECs, vetoing the fragment
            # (reference: MinCollector.cpp:497-507 + non-strict pairing)
            veto = s1.has_hits & (s1.rng + k < opt.min_range)
            if paired:
                veto = veto | (s2.has_hits & (s2.rng + k < opt.min_range))
            if veto.any():
                final_idx = final_idx.copy()
                final_sets = list(final_sets) + [None]
                final_idx[veto] = len(final_sets) - 1
        if pos_filter is not None:
            if paired:
                # reference: filter only when at least one mate had no hits
                # (ProcessReads.cpp:1095); both-empty reads are unmapped
                applies = ~(s1.has_hits & s2.has_hits)
                final_idx, final_sets = pos_filter.apply(
                    read_uidx, uniq_sets, applies,
                    np.where(s2.has_hits, s2.f_block, s1.f_block),
                    np.where(s2.has_hits, s2.f_upos, s1.f_upos),
                    np.where(s2.has_hits, s2.f_rpos, s1.f_rpos),
                    np.where(s2.has_hits, s2.f_strand, s1.f_strand),
                )
            else:
                final_idx, final_sets = pos_filter.apply(
                    read_uidx, uniq_sets, np.ones(b1.n, bool),
                    s1.f_block, s1.f_upos, s1.f_rpos, s1.f_strand,
                )
        if strand_filter is not None:
            if paired:
                final_idx, final_sets = strand_filter.apply_pair(
                    final_idx, final_sets,
                    s1.has_hits, s1.f_block, s1.f_strand,
                    s2.has_hits, s2.f_block, s2.f_strand,
                )
            else:
                final_idx, final_sets = strand_filter.apply_pair(
                    final_idx, final_sets, s1.has_hits, s1.f_block, s1.f_strand,
                )
        read_ec, read_card = resolver.count_batch(final_idx, final_sets)
        num_processed += b1.n
        if tl_h is not None and estimate_fld and tlencount < _FLEN_GOAL:
            ok = (
                (tl_h > 0)
                & (tl_h < MAX_FRAG_LEN)
                & (read_card == 1)
                & s1.has_hits
                & s2.has_hits
            )
            take = np.flatnonzero(ok)[: _FLEN_GOAL - tlencount]
            fl_samples.append(tl_h[take].astype(np.int64))
            tlencount += take.shape[0]
        timings["resolve_s"] += time.perf_counter() - t2

    # stderr chatter matching the reference's ProcessReads prologue
    # (src/ProcessReads.cpp:196-231)
    if paired:
        _log("[quant] running in paired-end mode")
        if len(opt.files) % 2 != 0:
            raise ValueError("paired-end mode requires an even number of files")
        for i in range(0, len(opt.files), 2):
            _log(f"[quant] will process pair {i // 2 + 1}: {opt.files[i]}")
            _log(f"                             {opt.files[i + 1]}")
        batch_iter = (
            b
            for i in range(0, len(opt.files), 2)
            for b in packed_paired_batches(
                opt.files[i], opt.files[i + 1], opt.batch_size, k)
        )
    else:
        _log("[quant] running in single-end mode")
        if opt.fld_mean <= 0 or opt.fld_sd <= 0:
            raise ValueError("single-end mode requires -l and -s")
        for i, f in enumerate(opt.files):
            _log(f"[quant] will process file {i + 1}: {f}")
        batch_iter = (
            (b, None) for f in opt.files
            for b in packed_single_batches(f, opt.batch_size, k)
        )
    _log("[quant] finding pseudoalignments for the reads ...", end="")
    t0 = time.perf_counter()
    # pipelined loop, depth 2: the next batch's kernels run on the card
    # while the oldest batch resolves on the host
    pend = deque()
    t_read = time.perf_counter()
    for b1, b2 in batch_iter:
        t1 = time.perf_counter()
        timings["read_s"] += t1 - t_read
        pend.append(dispatch(b1, b2))
        timings["dispatch_s"] += time.perf_counter() - t1
        if len(pend) > 1:
            process(pend.popleft())
        t_read = time.perf_counter()
    while pend:
        process(pend.popleft())
    timings["pseudoalign_s"] = time.perf_counter() - t0
    _log(" done")
    _log(
        f"[quant] processed {num_processed:,} reads, "
        f"{resolver.num_mapped:,} reads pseudoaligned"
    )
    if resolver.num_mapped == 0:
        _log("[~warn] no reads pseudoaligned.")

    fl_vec = np.concatenate(fl_samples) if fl_samples else np.empty(0, np.int64)
    np.add.at(flens, fl_vec, 1)

    # -- FLD post-processing (reference: main.cpp:2663-2681) --------------
    if opt.fld_mean == 0.0:
        fld = flens.astype(np.uint32)
        mean_fl_trunc = compute_mean_frag_lens_trunc(flens)
    else:
        mean_fl_trunc = trunc_gaussian_fld(0, MAX_FRAG_LEN, opt.fld_mean, opt.fld_sd)
        fld = trunc_gaussian_counts(0, MAX_FRAG_LEN, opt.fld_mean, opt.fld_sd, 10000)

    fl_means = get_frag_len_means(index.target_lens, mean_fl_trunc)
    eff_lens = calc_eff_lens(index.target_lens, fl_means)

    counts = resolver.counts_array()
    problem = build_em_problem(resolver.ec_sets, index.num_trans)
    priors = read_priors(opt.priors, index.num_trans) if opt.priors else None
    _log("[   em] quantifying the abundances ...", end="")
    t0 = time.perf_counter()
    em = run_em(problem, counts, eff_lens, n_iter=10000, min_rounds=50,
                priors=priors, device=dev)
    timings["em_s"] = time.perf_counter() - t0
    _log(" done")
    _log(
        "[   em] the Expectation-Maximization algorithm ran for "
        f"{em.n_rounds:,} rounds"
    )
    tpm = counts_to_tpm(em.alpha, eff_lens)
    num_pseudoaligned = int(counts.sum())
    num_unique = resolver.num_unique_reads()

    result = QuantResult(
        target_names=index.target_names,
        target_lens=index.target_lens,
        eff_lens=eff_lens,
        est_counts=em.alpha,
        tpm=tpm,
        em=em,
        counts=counts,
        ec_sets=resolver.ec_sets,
        flens=flens,
        num_processed=num_processed,
        num_pseudoaligned=num_pseudoaligned,
        num_unique=num_unique,
        fld=fld,
        timings=timings,
    )

    if opt.output_dir:
        # off-list (D-list) pseudo-targets are excluded from abundance
        # outputs (reference: only onlist targets are reported)
        nl = index.num_onlist
        os.makedirs(opt.output_dir, exist_ok=True)
        writers.write_abundance_tsv(
            os.path.join(opt.output_dir, "abundance.tsv"),
            result.target_names[:nl], result.target_lens[:nl],
            eff_lens[:nl], em.alpha[:nl], tpm[:nl],
        )
        if not opt.plaintext:
            _log("[quant] HDF5 output is not ported yet; wrote abundance.tsv")
        writers.write_run_info(
            os.path.join(opt.output_dir, "run_info.json"),
            n_targets=index.num_onlist,
            n_bootstraps=opt.bootstrap,
            n_processed=num_processed,
            n_pseudoaligned=num_pseudoaligned,
            n_unique=num_unique,
            kallisto_version=KALLISTO_COMPAT_VERSION,
            index_version=REFERENCE_INDEX_VERSION,
            k=k,
            start_time=start_time,
            call=opt.call,
        )
        if opt.write_index:
            writers.write_counts(
                os.path.join(opt.output_dir, "counts.txt"), counts
            )
    return result
