"""End-to-end quantification: FASTQ -> device pseudoalignment -> EC counts
-> EM -> abundance outputs.

Port of kallisto_tpu/quant/pipeline.py with two routes per batch:

- **full** (per read; JAX pipeline.py:925-938, :1277-1343): kernel A
  reduces each mate to its EC rows and first hit, kernel B hashes each
  read into a 128-bit key and computes its mapPair fragment length, and
  the host resolves first-seen keys, applies the filters and counts ECs
  in read order.  Paired batches take it while the fragment-length
  distribution (FLD) is learned, and every batch whose compact table
  overflows takes it again.
- **compact steady state** (JAX :858-924, :1183-1276 and the single-end
  twins :1345-1535): a padded "turbo" batch goes through kernel D (both
  mates in one launch) and kernel E, which computes each read's compact
  key (min_range veto bits, first-hit block/strand and the FLD position
  rank ride in the key) and reduces the batch to a key table on the card
  in one C call; the host fetches the occupied rows, resolves each
  first-seen DISTINCT KEY once from exemplar rows that kernel F gathers
  (pairs without filters first fetch F's slim rows, enough for keys of
  one row a mate; a batch's new keys resolve in one native call), and
  applies the filters per key.  Batches
  with more Ns than the aux vector holds go through kernels A and E on
  bitmask slices instead ("compact").

`timings` counts processed batches by route (`full`, `turbo` -- through
the anchor kernel or kernel D --, `compact`, `cmesh` -- sharded over
several devices --, `fallback` -- a compact table that overflowed and was
redone per read), the anchor kernel's wave-2
reads (`wave2_reads`), and records `n_uniq_max` / `n_uniq_sum` over the
turbo batches.  The EM runs on the device through kernel G, with one
replicate.

--bias (JAX :840, :937, :1327-1331, :1348, :1402, :1570-1574,
:1830-1860): until _BIAS_GOAL counted reads, batches go per read and
kernel H gives each read's 5' hexamer from mate 1's first hit; the host
counts them in read order, and the EM calls quant/bias.py's
update_eff_lens at iterations 50 and 550.  -b N (JAX :1881-1892): N
multinomial resamples of the EC counts through one batched EM on the card
(kernel G), on the post-bias effective lengths; outputs are
bs_abundance_{b}.tsv under --plaintext, else abundance.h5 where h5py is
installed (without h5py a warning says that abundance.h5 was not
written).

A uniform-length turbo batch goes through the two-wave anchor kernel I
(ops/anchor.py; JAX :884-898, :1368) in place of kernel D: a few lookups
verify whole unitig stretches and only the other reads pay per-window
work.  Kernel I evaluates every failing read itself, so the port has no
wave-2 capacity: JAX's capacity hints (_W2_HINTS, JAX :223-292) and its
redo of an overflowing batch through kernel D (:1186-1204, :1466-1470)
exist for the TPU's fixed-size wave-2 sub-batch and are not copied.
Mixed lengths, and the lengths whose wave-2 row width has no anchor
route (ops/anchor.py row_width_ok), take kernel D.

--long (JAX :1603-1656): batches of up to 16,384 single reads go through
kernel J (ops/pseudoalign.py pseudoalign_long_packed, every window of every
read); the host resolves each read by strict intersection of its distinct
rows with the modeECs fallback (quant/longread.py), calls a read novel when
more than threshold * len of its k-mers are unmapped, and writes the novel
reads and the reads without a set to novel.fastq.  The EM adds singleton
counts after the loop unless the platform is ONT.  `timings` counts the
`long` batches and the `novel` reads; their kernel + fetch seconds are
`fetch_s`.

Host wave 1 (JAX :803-1182, :1345-1462; ops/hostprobe.py), on with
KALLISTO_TPU_HOST_WAVE1=1 (off by default: _HOST_WAVE1_DEFAULT): a
uniform-length batch is first probed on the host, which verifies the reads
that match one unitig stretch with a few lookups and reduces them to a
host key histogram; only the failing reads go to the card, pairs with one
failed mate through kernel K (the failed mate's codes plus the other's
8-byte summary), pairs with both failed through kernel D, each slice then
through kernel E with per-read slots.  The resolver merges
host and card keys by first read (EcResolver.process_compact_parts, with
kernel F's slim rows for single-row keys), so EC numbering and the outputs
are those of the other routes.  Routes: `hw1pb` (pairs that need per-read
results: while the FLD is learned, and every --pseudobam batch; each read
gets its EC through its host key word or its row in kernel E's table, and
the FLD subsample takes the probe's fragment lengths for verified pairs
and kernel B's for the others), `hw1` (the paired steady state), `hw1s`
(single-end); a slice whose Ns do not fit the aux vector sends the batch
down the card's routes, and a wave-2 read past its row budget redoes the
batch per read.  With host wave 1, FLD learning pipelines like the steady
state (JAX :1688).  `timings` adds the probe's seconds (`probe_s`) and
counts those routes; `wave2_reads` counts the mates evaluated on the card.

--pseudobam / --genomebam (JAX :637-682, :1957-1974; io/pseudobam.py): a
batch never takes the compact route; per read (kernels A and B) or on
hw1pb, each read's EC and first hits spill to pseudoaln.bin, and after the
EM the writers re-read the FASTQs and write pseudoalignments.bam (genome
coordinates, sorted, with its .bai, under --genomebam).

Several devices (`-t N` with N cards, or Options.n_devices; JAX
:740-745, :808, :858-865, :925-931, :1231-1260, :1350-1355, :1396-1399,
:1500-1520): a mesh of n shards (parallel/mesh.py) replicates the index
once per distinct card and splits each batch contiguously.  Host wave 1
is off and the first paired batch is not split; a steady-state batch
takes `cmesh` -- kernels A and E per shard on the shard's device (K18),
resolved through one process_compact_parts part per shard table, the
shard's first reads offset by s * shard_B and its exemplar and slim rows
gathered on its device --, and a batch whose shard rows overflowed goes
per read; the per-read route runs kernel A per shard and concatenates
the shards in mesh order.  The outputs are those of one device.  --long
runs on the mesh's first device.

Several processes (JAX :705-725, :1750-1810; parallel/multihost.py): when
torch.distributed is initialized with more than one rank, each rank takes
a contiguous share of the input files, the EC maps and FLD prefixes merge
in rank order and the processed count and hexamers are summed, so the
outputs equal one process's; only rank 0 writes.
"""

import contextlib
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from .. import KALLISTO_COMPAT_VERSION, resolve_device
from ..common import MAX_FRAG_LEN, Options, REFERENCE_INDEX_VERSION
from ..index import load_index
from ..index.build import TpuIndex
from ..io import writers
from ..io.pseudobam import (
    PseudoAlnRecorder,
    write_pseudobam_genome,
    write_pseudobam_trans,
)
from ..io.fastx import PackedBatch, packed_paired_batches, packed_single_batches
from ..ops import anchor, turbo
from ..ops.hostprobe import HostProbe
from ..ops.host_fallback import host_side_rows
from ..ops.pseudoalign import (
    KeySpec,
    SideResult,
    bias_tables_from_host,
    ck_n_fail,
    gather_exemplars,
    gather_slim,
    pf_probe_depth,
    pseudoalign_long_packed,
    pseudoalign_pair_compact_packed,
    pseudoalign_single_compact_packed,
    read_keys,
    to_device,
    unflatten_ck_host,
    upload_batch,
)
from ..parallel import multihost
from ..parallel.mesh import MeshRunner, make_mesh, n_shards
from ..utils import spans
from ..utils.spans import span
from .bias import NUM_6MERS, TranscriptHexamers, update_eff_lens
from .bootstrap import run_bootstraps
from .ecmap import EcResolver
from .em import EmResult, build_em_problem, counts_to_tpm, read_priors, run_em
from .longread import resolve_long_reads
from .filters import FldPositionFilter, StrandFilter
from .genemodel import Transcriptome
from .fld import (
    calc_eff_lens,
    compute_mean_frag_lens_trunc,
    get_frag_len_means,
    trunc_gaussian_counts,
    trunc_gaussian_fld,
)

_FLEN_GOAL = 10000  # reference: ProcessReads.cpp:985
_BIAS_GOAL = 1000000  # reference: ProcessReads.h:178 maxBiasCount
_FALLBACK_CAP = 1 << 17  # max reads per per-read or bitmask slice
_CK_PREFIX = 2049  # meta row + 2048 key rows: the first fetch of a table
_LONG_BATCH = 16384  # reads per --long batch (JAX pipeline.py:1618)
# host wave 1's wave-2 slices (JAX pipeline.py:352-365): failing reads in
# slices of up to _W2MAX, each padded to a power of two >= _W2MIN, with a
# row budget of _W2ROWS per read and a key table of Bp + 1 rows
_W2MIN = 1 << 14
_W2MAX = 1 << 18
_W2ROWS = 32
# KALLISTO_TPU_HOST_WAVE1's default: off.  The JAX package turns host wave
# 1 on (it halves the bytes its TPU link carries); on one H100 its wall was
# longer than the anchor route's on 1M pairs (PERF.md section 5).
_HOST_WAVE1_DEFAULT = "0"
# run_quant's phase spans: timings["unspanned_s"] is the part of the run
# that none of them covers (the read loop's span holds several of them)
_PHASES = ("index_upload", "read", "dispatch", "fetch", "resolve",
           "em_problem", "bias_tables", "em", "bootstrap", "write", "probe")
_pad_pats: dict = {}


def _flen_goal() -> int:
    """FLD subsample size; KALLISTO_TPU_FLEN_GOAL overrides it (the tests
    and the smoke run use a small goal to reach the compact route on small
    inputs)."""
    return int(os.environ.get("KALLISTO_TPU_FLEN_GOAL", _FLEN_GOAL))


def _log(msg: str, end: str = "\n"):
    print(msg, file=sys.stderr, end=end, flush=True)


def _timing_log():
    """KALLISTO_TPU_TIMING=1: `[time] <tag> <s>s` lines on stderr at the
    counterparts of JAX's tags (pipeline.py:822-830): host wave 1's paired
    steady state (`hw1`) writes `probe` and `w2dispatch nf=<failing
    pairs>` at dispatch and `w2fetch` and `resolve` when processed; the
    paired per-read route writes `full:hashes`, `full:resolve` and
    `full:overflow`.  Single-end and --long batches, hw1pb, and the card's
    compact routes write none, as in JAX.  JAX also sends a batch whose
    wave-2 sub-batch overflowed its capacity back through the per-read
    route (more `full:` lines); the port has no wave-2 capacity (Queue 3,
    "Deliberate differences"), so its lines are those of a JAX run whose
    capacity never overflows.  Returns tlog(tag, t) -> now: it writes the
    line for the seconds since t when the variable is set."""
    on = os.environ.get("KALLISTO_TPU_TIMING", "") == "1"

    def tlog(tag: str, t: float) -> float:
        now = time.perf_counter()
        if on:
            _log(f"[time] {tag} {now - t:.3f}s")
        return now

    return tlog


@contextlib.contextmanager
def _profiled(dev: torch.device):
    """KALLISTO_TPU_PROFILE=<dir>: a torch.profiler trace of the whole of
    run_quant (JAX brackets only its read loop with jax.profiler,
    pipeline.py:1596-1600, :1725), CPU activities and, on a card, CUDA
    ones, without shapes or stacks, written to <dir>/quant_<pid>.json as a
    Chrome trace; run_quant's spans (utils/spans.py) are its
    user_annotation ranges."""
    out = os.environ.get("KALLISTO_TPU_PROFILE", "")
    if not out:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        yield
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"quant_{os.getpid()}.json"))


# reads between two progress lines (reference: MasterProcessor::update,
# src/ProcessReads.cpp:634-643)
_PROGRESS_EVERY = 1000000


class _Progress:
    """The progress line with %mapped, once per _PROGRESS_EVERY reads
    (JAX pipeline.py _Progress)."""

    def __init__(self, resolver):
        self._resolver = resolver
        self._counter = 0
        self.printed = False

    def update(self, n: int, num_processed: int):
        self._counter += n
        if self._counter >= _PROGRESS_EVERY:
            self._counter = 0
            pct = 100.0 * self._resolver.num_mapped / max(num_processed, 1)
            _log(
                f"\r[progress] {num_processed // 1000000}M reads processed"
                f" ({pct:5.1f}% mapped)             ",
                end="",
            )
            self.printed = True


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
    bias5: Optional[np.ndarray] = None       # [4096] observed hexamers
    bootstraps: Optional[np.ndarray] = None  # [n_bootstrap, T]


def host_wave1_enabled() -> bool:
    """Whether run_quant sends uniform-length batches through host wave 1
    (KALLISTO_TPU_HOST_WAVE1, "0" turns it off); the outputs are the same
    either way."""
    return os.environ.get("KALLISTO_TPU_HOST_WAVE1",
                          _HOST_WAVE1_DEFAULT) != "0"


class _EcCards:
    """The set size of every EC so far, extended as ECs appear (the FLD
    subsample of hw1pb needs each read's set size)."""

    def __init__(self, resolver):
        self._r = resolver
        self._a = np.empty(0, np.int32)

    def get(self) -> np.ndarray:
        n = len(self._r.ec_sets)
        if self._a.shape[0] < n:
            extra = np.fromiter(
                (self._r.ec_sets[i].shape[0]
                 for i in range(self._a.shape[0], n)),
                np.int32, count=n - self._a.shape[0])
            self._a = np.concatenate([self._a, extra])
        return self._a


def _padding_nmask_patterns(Lp: int) -> np.ndarray:
    """[Lp+1, Lp/8] nmask rows of N-free reads of each length (the reader
    marks padding positions as N; an N-free read of length l has exactly
    the bits >= l set)."""
    pats = _pad_pats.get(Lp)
    if pats is None:
        j = np.arange(Lp)
        bits = (j[None, :] >= np.arange(Lp + 1)[:, None]).astype(np.uint8)
        pats = np.packbits(bits, axis=1, bitorder="little")
        _pad_pats[Lp] = pats
    return pats


def _bucket_size(n: int, lo: int = 8192) -> int:
    """A batch size rounded up to a power of two (padding reads are masked
    through the aux vector)."""
    p = lo
    while p < n:
        p <<= 1
    return p


def _pad_rows(a: np.ndarray, Bp: int) -> np.ndarray:
    if a.shape[0] == Bp:
        return a
    pad = np.zeros((Bp - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _fetch_ck(ck: torch.Tensor) -> np.ndarray:
    """Fetch a key table: a small prefix first, then exactly the occupied
    rows when the batch had more distinct keys than the prefix holds
    (occupied rows are always the leading ones), so the bytes fetched
    follow n_uniq, not the table's capacity."""
    pre = ck[:_CK_PREFIX].cpu().numpy()
    n_uniq = int(pre[0, 0])
    if n_uniq <= _CK_PREFIX - 1:
        return pre
    K = int(ck.shape[0]) - 1
    if n_uniq >= K:  # overflowed table: the caller falls back anyway
        return ck.cpu().numpy()
    return ck[: n_uniq + 1].cpu().numpy()


def _turbo_exceptions(batches, Bp: int) -> Optional[np.ndarray]:
    """In-read N positions as flat indices into the PADDED concatenated
    [len(batches)*Bp, Lp] code matrix, ascending (None = more than
    turbo.EXC_CAP; the caller takes the bitmask route).  Padding rows need
    none: the aux n_real field zeroes their lengths."""
    return _rows_exceptions([(b.nmask, b.lens) for b in batches], Bp,
                            batches[0].Lp)


def _rows_exceptions(sides, Bp: int, Lp: int) -> Optional[np.ndarray]:
    """In-read N positions of (nmask rows, lens) sides -- whole batches or
    the rows of a wave-2 slice -- as flat indices into the padded
    concatenated [len(sides) * Bp, Lp] code matrix (None = more than
    turbo.EXC_CAP)."""
    pats = _padding_nmask_patterns(Lp)
    parts = []
    total = 0
    for s, (nm, lens) in enumerate(sides):
        nm = nm.reshape(lens.shape[0], -1)
        if not np.array_equal(nm, pats[lens]):
            bits = np.unpackbits(nm, axis=1, bitorder="little")[:, :Lp]
            bits[np.arange(Lp)[None, :] >= lens[:, None]] = 0
            r, c = np.nonzero(bits)
            parts.append((s * Bp + r.astype(np.int64)) * Lp + c)
            total += parts[-1].size
            if total > turbo.EXC_CAP:
                return None
    if not parts:
        return np.empty(0, np.int64)
    return np.concatenate(parts)


def _slice_packed(b: PackedBatch, lo: int, hi: int) -> PackedBatch:
    return PackedBatch(b.packed[lo:hi], b.nmask[lo:hi], b.lens[lo:hi], b.Lp)


def _record_pbam(pbam, read_ec, s1: SideResult, s2: Optional[SideResult]):
    """Spill one batch's per-read pseudoalignment info for the --pseudobam
    replay (JAX pipeline.py:637-652): only read_ec and each mate's first-hit
    fields go to pseudoaln.bin; the writers re-read the FASTQs."""
    def side(s):
        return {f: getattr(s, f) for f in
                ("has_hits", "f_block", "f_upos", "f_rpos", "f_strand")}

    pbam.add_compact(read_ec, side(s1), side(s2) if s2 is not None else None)


def _pbam_read_stream(opt: Options, k: int):
    """Second pass over the input reads for the pseudobam replay (JAX
    :655-682): per-read (name, codes1, qual1[, codes2, qual2])."""
    if opt.paired:
        for i in range(0, len(opt.files), 2):
            for b1, b2 in packed_paired_batches(
                opt.files[i], opt.files[i + 1], opt.batch_size, k,
                keep_names=True, keep_quals=True,
            ):
                for j in range(b1.n):
                    yield (
                        b1.names[j], b1.row_codes(j)[: int(b1.lens[j])],
                        b1.quals[j],
                        b2.row_codes(j)[: int(b2.lens[j])], b2.quals[j],
                    )
    else:
        for f in opt.files:
            for b1 in packed_single_batches(f, opt.batch_size, k,
                                            keep_names=True, keep_quals=True):
                for j in range(b1.n):
                    yield (b1.names[j], b1.row_codes(j)[: int(b1.lens[j])],
                           b1.quals[j])


def _split_first_pair_batch(it, head: int = 65536):
    """Re-emit a paired batch stream with a small first batch: FLD learning
    runs it per read, and capping it at `head` pairs lets the steady state
    start early while later batches stay large."""
    first = next(it, None)
    if first is None:
        return
    b1, b2 = first
    if b1.n > head:
        yield _slice_packed(b1, 0, head), _slice_packed(b2, 0, head)
        yield _slice_packed(b1, head, b1.n), _slice_packed(b2, head, b2.n)
    else:
        yield first
    yield from it


def _uniform_len(*batches) -> Optional[int]:
    if not batches or batches[0].lens.size == 0:
        return None
    l0 = int(batches[0].lens[0])
    for b in batches:
        if not (b.lens == l0).all():
            return None
    return l0


def _exemplar_fetcher(r1: SideResult, r2: Optional[SideResult],
                      spec: KeySpec):
    """Exemplar fetcher: one gather on the device (kernel F) returns the key
    rows of first-seen keys, in the layout of the batch's keys (per-read:
    rows and flags; compact: plus veto bits, block/strand and upos/rpos
    tails)."""
    B = int(r1.rows.shape[0])

    def fetch(idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= B):
            raise ValueError("exemplar index outside the batch")
        t = to_device(idx, r1.rows.device)
        return gather_exemplars(t, r1, r2, spec).cpu().numpy()

    return fetch


def _table_part(uniq_h, occ, first_local, r1: SideResult,
                r2: Optional[SideResult], spec: KeySpec, first):
    """One card key table as a part of EcResolver.process_compact_parts:
    its occupied rows, the exemplar fetch (kernel F) and, for pairs, the
    slim fetch (kernel F's slim layout: rows 0-1 of each mate and the
    flags, 20 B per key, so that single-row keys skip the full exemplar).
    `first` maps the rows' first reads to the batch's read indices (a
    shard's offset, or a wave-2 slice's read list).  Returns (part,
    occupied rows)."""
    valid = np.flatnonzero(occ > 0)
    fl = first_local[valid].astype(np.int64)
    fetch = _exemplar_fetcher(r1, r2, spec)
    slim = None
    if r2 is not None and min(r1.rows.shape[1], r2.rows.shape[1]) >= 2:
        def slim(sel):
            t = to_device(fl[sel], r1.rows.device)
            return gather_slim(t, r1, r2).cpu().numpy()
    part = (np.ascontiguousarray(uniq_h[valid]), occ[valid],
            first(fl),
            lambda sel: fetch(fl[sel]), int(r1.rows.shape[1]), slim)
    return part, valid


def _make_compact_postfilter(strand_filter, pos_filter=None):
    """Per-key filter of the compact path, applied after resolution.

    flags bits 16/32 = per-mate min_range veto (reference:
    MinCollector::intersectECs range check, MinCollector.cpp:497-507); the
    tail carries each mate's first-hit (block, strand) [+ (upos, rpos) when
    the FLD position filter is active].  Filter order matches the
    reference: position feasibility first, then strand specificity
    (ProcessReads.cpp:1094-1176).  Per-read keys have no tail and no veto
    bits, so this is a no-op for them."""

    def post(u, flags, tail, paired):
        if flags & 16 or flags & 32:
            return None
        if u is None or tail.shape[0] == 0:
            return u
        if paired:
            if pos_filter is not None and bool(flags & 1) != bool(flags & 2):
                m = 0 if flags & 1 else 1
                u = pos_filter.apply_one(
                    u, int(tail[2 * m]), bool(tail[2 * m + 1]),
                    int(tail[4 + 2 * m]), int(tail[5 + 2 * m]),
                )
                if u is None or u.shape[0] == 0:
                    return None
            if strand_filter is not None:
                u = strand_filter.apply_one(
                    u, bool(flags & 1), int(tail[0]), bool(tail[1]),
                    bool(flags & 2), int(tail[2]), bool(tail[3]),
                )
            return u
        if pos_filter is not None and flags & 1:
            u = pos_filter.apply_one(
                u, int(tail[0]), bool(tail[1]), int(tail[2]), int(tail[3])
            )
            if u is None or u.shape[0] == 0:
                return None
        if strand_filter is not None:
            u = strand_filter.apply_one(
                u, bool(flags & 1), int(tail[0]), bool(tail[1])
            )
        return u

    return post


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
    dev = resolve_device(device)
    # host wall seconds by span (utils/spans.py; `quant.<name>` on a
    # profiler's timeline): the whole run (run), index upload
    # (index_upload; index_prep_s its host gathers and casts), FASTQ read +
    # pack (read), upload + kernel enqueue (dispatch), device->host fetch,
    # --long's too, the wait for the kernels included (fetch), host
    # resolution/filters/counting (resolve; resolve_per_read_s its per-read
    # route, resolve_new_s the compact routes' first-seen keys), the whole
    # read loop (read_loop: pseudoalign_s), the EM problem build, the
    # transcript hexamer tables of --bias, EM (bias_update_s of it in
    # update_eff_lens), the bootstrap EM, the output files, host wave 1's
    # probe, and what of the run no phase covers (_PHASES: unspanned_s);
    # then batch counts by route (long reads: `long`), the anchor kernel's
    # wave-2 reads, the turbo batches' distinct keys, the novel long reads,
    # the compact routes' keys looked up in and found in the resolver's key
    # cache, and the first-seen keys of either route resolved by the native
    # call (quant/ecresolve.py)
    timings = dict.fromkeys(
        ("run_s", "index_upload_s", "index_prep_s", "read_s", "dispatch_s",
         "fetch_s", "resolve_s", "resolve_per_read_s", "resolve_new_s",
         "pseudoalign_s", "em_problem_s", "bias_tables_s", "em_s",
         "bias_update_s", "bootstrap_s", "write_s", "probe_s",
         "unspanned_s"), 0.0)
    timings.update(dict.fromkeys(
        ("full", "turbo", "compact", "cmesh", "fallback", "long", "hw1pb",
         "hw1", "hw1s", "wave2_reads", "n_uniq_max", "n_uniq_sum", "novel",
         "ec_cache_lookups", "ec_cache_hits", "ec_native_keys"), 0))
    with _profiled(dev), spans.recording("quant", timings, _PHASES):
        return _run_quant(opt, index, dev, timings)


def _run_quant(opt: Options, index: Optional[TpuIndex], dev: torch.device,
               timings: dict) -> QuantResult:
    start_time = time.strftime("%a %b %d %H:%M:%S %Y")
    hw1_stats = [0, 0]  # mates verified on the host, steady-state mates
    with span("index_upload", "index_upload_s"):
        if index is None:
            index = load_index(opt.index_path)
        # several processes: this rank's contiguous share of the files; only
        # rank 0 writes (JAX :705-725)
        rank, n_hosts = multihost.world()
        if n_hosts > 1:
            opt = replace(
                opt, files=multihost.shard_files(list(opt.files), opt.paired,
                                                 rank, n_hosts),
                output_dir=opt.output_dir if rank == 0 else "")
            if opt.pseudobam:
                raise ValueError(
                    "--pseudobam is not supported in multi-host runs")
        pos_filter: Optional[FldPositionFilter] = None
        if opt.fld_mean > 0 and not opt.single_overhang:
            pos_filter = FldPositionFilter(index, fl=int(opt.fld_mean))
        # the shards (one, or several devices; --long keeps one): one index
        # replica per distinct device, the rest of the run on the first
        mesh = MeshRunner(make_mesh(
            1 if opt.long_read else n_shards(opt, dev), dev))
        dev = mesh.devices[0]
        didx = mesh.replicate(index, pos_filter is not None)[0]
        sharded = mesh.ndev > 1
        bt = bias_tables_from_host(index, dev) if opt.bias else None
    resolver = EcResolver(index)
    k = index.k
    bias5 = np.zeros(NUM_6MERS, np.int64)
    bias_total = 0

    paired = opt.paired
    estimate_fld = paired and opt.fld_mean == 0.0
    flens = np.zeros(MAX_FRAG_LEN, np.int64)
    flen_goal = _flen_goal()
    fl_samples: List[np.ndarray] = []  # eligible lengths in READ order
    tlencount = 0
    num_processed = 0

    strand_filter: Optional[StrandFilter] = None
    if opt.strand in ("fr", "rf"):
        strand_filter = StrandFilter(index, opt.strand)
    pbam = None
    if opt.pseudobam:
        os.makedirs(opt.output_dir or ".", exist_ok=True)
        pbam = PseudoAlnRecorder(
            paired=paired,
            spill_path=os.path.join(opt.output_dir or ".", "pseudoaln.bin"),
        )
    model = None
    if opt.genomebam:
        # reference: parse the GTF (and the given chromosomes) up front
        # (main.cpp:2639-2648)
        model = Transcriptome(index.target_names, index.target_lens)
        if opt.chrom_file:
            model.load_chromosomes(opt.chrom_file)
        model.parse_gtf(opt.gtf_file, guess_chromosomes=not opt.chrom_file)

    # compact-path filter routing: min_range, strand and the position
    # filter become part of each read's KEY (veto bits, first-hit
    # block/strand, position rank) and the resolver applies them once per
    # key, so these filters do not force the per-read route
    spec = KeySpec(
        k=k,
        min_range=opt.min_range if opt.min_range > 1 else 0,
        strand_key=strand_filter is not None,
        pos_fl=int(opt.fld_mean) if pos_filter is not None else -1,
        pos_depth=pf_probe_depth(index) if pos_filter is not None else 0,
    )
    key_kw = dict(min_range=spec.min_range, strand_key=spec.strand_key,
                  pos_fl=spec.pos_fl, pos_depth=spec.pos_depth)
    if spec.strand_key or spec.min_range or spec.pos_key:
        resolver.compact_postfilter = _make_compact_postfilter(
            strand_filter, pos_filter
        )
    # host wave 1 (ops/hostprobe.py): anchors verified on the host, only
    # the failing reads go to the card; a probe that cannot be built raises
    hostprobe = None
    if host_wave1_enabled() and not opt.long_read and not sharded:
        hostprobe = HostProbe(index, min_range=spec.min_range,
                              strand_key=spec.strand_key,
                              pos_key=spec.pos_key, pos_fl=spec.pos_fl)
    ec_cards = _EcCards(resolver)
    tlog = _timing_log()

    def dispatch_full(b1: PackedBatch, b2: Optional[PackedBatch],
                      want_tl: bool, want_bias: bool = False):
        """Enqueue one batch on the per-read route (asynchronous on the
        card); with want_bias kernel B's launch adds kernel H, each read's
        5' hexamer, from mate 1 of a pair whose mate 2 has hits (JAX :937)
        or of any single-end read (:1403)."""
        r1 = mesh.pseudoalign_batch(b1, k)
        r2 = None if b2 is None else mesh.pseudoalign_batch(b2, k)
        h, tl, hx = read_keys(r1, r2, k, bias=bt if want_bias else None)
        return ("full", b1, b2, r1, r2, h, tl if want_tl else None, hx)

    def dispatch_compact(b1: PackedBatch, b2: Optional[PackedBatch]):
        """Enqueue one batch on the compact route: a turbo batch when its Ns
        fit the aux vector, else bitmask slices.  Each key table holds one
        more row than its batch has reads, so it cannot overflow (a read
        contributes at most one key); _fetch_ck moves only occupied rows."""
        sides = (b1,) if b2 is None else (b1, b2)
        Bp = _bucket_size(b1.n)
        exc = _turbo_exceptions(sides, Bp)
        rl = _uniform_len(*sides)
        aux = None if exc is None else turbo.make_aux(b1.n, rl or 0, exc)
        lens = None
        if aux is not None and (rl is None or rl < k):
            if max(int(b.lens.max()) for b in sides) >= 65536:
                aux = None
            else:
                lens = to_device(np.concatenate(
                    [_pad_rows(b.lens.astype(np.uint16), Bp) for b in sides]),
                    dev)
        if aux is not None:
            # A uniform-length batch takes the two-wave anchor kernel, as in
            # JAX without host wave 1 (pipeline.py:884-898, :1368).  The
            # lengths whose wave-2 row width has no anchor route, where JAX
            # raises, take kernel D with rl, and mixed lengths
            # turbo_varlen (:899-911).
            packed = [to_device(_pad_rows(b.packed, Bp), dev, np.uint8)
                      for b in sides]
            auxt = to_device(aux, dev)
            kw = dict(k=k, L=b1.Lp, max_keys=Bp + 1, **key_kw)
            if lens is not None:
                if b2 is None:
                    out = turbo.pseudoalign_single_turbo_varlen(
                        didx, packed[0], auxt, lens, **kw)
                else:
                    out = turbo.pseudoalign_pair_turbo_varlen(
                        didx, packed[0], packed[1], auxt, lens, **kw)
            elif anchor.row_width_ok(rl, k):
                akw = dict(kw, n_anchors=anchor.n_anchors_for(rl, k), rl=rl)
                if b2 is None:
                    out = anchor.pseudoalign_single_anchor(
                        didx, packed[0], auxt, **akw)
                else:
                    out = anchor.pseudoalign_pair_anchor(
                        didx, packed[0], packed[1], auxt, **akw)
            elif b2 is None:
                out = turbo.pseudoalign_single_turbo(
                    didx, packed[0], auxt, rl=rl, **kw)
            else:
                out = turbo.pseudoalign_pair_turbo(
                    didx, packed[0], packed[1], auxt, rl=rl, **kw)
            if b2 is None:
                return ("turbo", b1, None, out[0], None, out[1])
            return ("turbo", b1, b2, *out)
        # N-dense batch: the bitmask kernels in memory-bounded slices
        subs = []
        for lo in range(0, b1.n, _FALLBACK_CAP):
            hi = min(lo + _FALLBACK_CAP, b1.n)
            sb1 = _slice_packed(b1, lo, hi)
            kw = dict(k=k, L=b1.Lp, max_keys=hi - lo + 1, **key_kw)
            if b2 is None:
                r1, ck = pseudoalign_single_compact_packed(
                    didx, *upload_batch(sb1, dev), **kw)
                subs.append(("compact", sb1, None, r1, None, ck))
            else:
                sb2 = _slice_packed(b2, lo, hi)
                r1, r2, ck = pseudoalign_pair_compact_packed(
                    didx, *upload_batch(sb1, dev), *upload_batch(sb2, dev),
                    **kw)
                subs.append(("compact", sb1, sb2, r1, r2, ck))
        return ("multi", b1, subs)

    def dispatch_cmesh(b1: PackedBatch, b2: Optional[PackedBatch]):
        """Enqueue one batch on the mesh (K18, JAX :858-865, :1350-1355):
        kernels A and E on every shard, each on its device."""
        if b2 is None:
            r1s, cks, sb = mesh.single_compact(b1, k, **key_kw)
            return ("cmesh", b1, None, r1s, [None] * len(r1s), cks, sb)
        return ("cmesh", b1, b2, *mesh.pair_compact(b1, b2, k, **key_kw))

    def dispatch(b1: PackedBatch, b2: Optional[PackedBatch], want_fld: bool):
        """Route one batch (JAX dispatch_pair :831 / dispatch_single :1345).

        With host wave 1 (the probe built), a uniform-length pair batch
        that needs per-read results (--pseudobam, or the FLD being learned)
        takes hw1pb; otherwise the compact route -- paired once FLD
        learning is over, single-end unless --union is on, both once --bias
        has counted its goal and without --pseudobam -- goes through host
        wave 1 (hw1, hw1s) when the batch has a uniform length >= k, else
        the card's compact route (over several shards: cmesh); the per-read route
        takes the rest.
        want_bias reads the hexamers counted by the batches processed so
        far."""
        want_bias = opt.bias and bias_total < _BIAS_GOAL
        rl = _uniform_len(b1) if b2 is None else _uniform_len(b1, b2)
        hw1_ok = (hostprobe is not None and rl is not None and rl >= k
                  and (b2 is None or b1.Lp == b2.Lp))
        if (b2 is not None and hw1_ok and not want_bias
                and (pbam is not None or want_fld)):
            hk = probe(b1, b2, rl, True)
            devs = dispatch_wave2_pair(hk, b1, b2, rl)
            if devs is not None:
                return ("hw1pb", b1, b2, hk, devs, want_fld)
        # a --pseudobam batch needs per-read ECs and first hits, so it never
        # takes the compact route (JAX :858-859, :1349)
        if b2 is None:
            compact = not opt.do_union and not want_bias and pbam is None
        else:
            compact = (not want_fld and not want_bias and b1.Lp == b2.Lp
                       and pbam is None)
        if compact and hw1_ok:
            t1 = time.perf_counter()
            hk = probe(b1, b2, rl, False)
            if b2 is None:
                devs = dispatch_wave2_single(hk.fail_idx, b1, rl)
                if devs is not None:
                    return ("hw1s", b1, None, hk, devs)
            else:
                t1 = tlog("probe", t1)
                devs = dispatch_wave2_pair(hk, b1, b2, rl)
                tlog(f"w2dispatch nf={len(hk.fail_idx)}", t1)
                if devs is not None:
                    return ("hw1", b1, b2, hk, devs)
        if compact:
            if sharded:
                return dispatch_cmesh(b1, b2)
            return dispatch_compact(b1, b2)
        return dispatch_full(b1, b2, want_fld, want_bias)

    def probe(b1, b2, rl, perread):
        with span("probe", "probe_s"):
            if b2 is None:
                return hostprobe.probe_single(b1, rl, perread)
            return hostprobe.probe_pair(b1, b2, rl, perread)

    def dispatch_wave2_pair(hk, b1, b2, rl):
        """Send only what wave 2 needs (JAX :940-1002): pairs with one
        failed mate as that mate's codes plus the other's summary (kernel
        K), pairs with both failed as both mates (kernel D), in slices of
        up to _W2MAX padded to a power of two >= _W2MIN; every slice's key
        table also gives each read's row.  Returns [(r1, r2, ck, sub,
        slots)], or None when a slice's Ns do not fit the aux vector (the
        caller takes the card's own routes)."""
        devs = []
        half = np.flatnonzero(hk.fail_side != 3)
        both = np.flatnonzero(hk.fail_side == 3)
        kw = dict(k=k, L=b1.Lp, max_rows=_W2ROWS, rl=rl, with_slots=True,
                  **key_kw)
        for lo in range(0, half.shape[0], _W2MAX):
            pos = half[lo : lo + _W2MAX]
            sub = hk.fail_idx[pos].astype(np.int64)
            side = hk.fail_side[pos]
            Bp = _bucket_size(pos.shape[0], lo=_W2MIN)
            m1 = (side == 1)[:, None]
            pkf = np.where(m1, b1.packed[sub], b2.packed[sub])
            nmf = np.where(m1, b1.nmask[sub], b2.nmask[sub])
            exc = _rows_exceptions([(nmf, b1.lens[sub])], Bp, b1.Lp)
            aux = None if exc is None else turbo.make_aux(pos.shape[0], rl, exc)
            if aux is None:
                return None
            out = turbo.pseudoalign_pair_halffail(
                didx, to_device(_pad_rows(pkf, Bp), dev, np.uint8),
                to_device(_pad_rows(hk.fail_vsum[pos], Bp), dev, np.int32),
                to_device(_pad_rows(side.astype(np.int32), Bp), dev),
                to_device(aux, dev), max_keys=Bp + 1, **kw)
            devs.append(out[:3] + (sub,) + out[3:])
        for lo in range(0, both.shape[0], _W2MAX):
            sub = hk.fail_idx[both[lo : lo + _W2MAX]].astype(np.int64)
            Bp = _bucket_size(sub.shape[0], lo=_W2MIN)
            exc = _rows_exceptions(
                [(b.nmask[sub], b.lens[sub]) for b in (b1, b2)], Bp, b1.Lp)
            aux = None if exc is None else turbo.make_aux(sub.shape[0], rl, exc)
            if aux is None:
                return None
            out = turbo.pseudoalign_pair_turbo(
                didx, to_device(_pad_rows(b1.packed[sub], Bp), dev, np.uint8),
                to_device(_pad_rows(b2.packed[sub], Bp), dev, np.uint8),
                to_device(aux, dev), max_keys=Bp + 1, **kw)
            devs.append(out[:3] + (sub,) + out[3:])
        return devs

    def dispatch_wave2_single(fail_idx, b1, rl):
        """Single-end wave 2 (JAX :1408-1430): the failing reads through
        kernel D and E in slices.  Returns [(r1, None, ck, sub)] or
        None."""
        devs = []
        for lo in range(0, fail_idx.shape[0], _W2MAX):
            sub = fail_idx[lo : lo + _W2MAX].astype(np.int64)
            Bp = _bucket_size(sub.shape[0], lo=_W2MIN)
            exc = _rows_exceptions([(b1.nmask[sub], b1.lens[sub])], Bp, b1.Lp)
            aux = None if exc is None else turbo.make_aux(sub.shape[0], rl, exc)
            if aux is None:
                return None
            r1, ck = turbo.pseudoalign_single_turbo(
                didx, to_device(_pad_rows(b1.packed[sub], Bp), dev, np.uint8),
                to_device(aux, dev), k=k, L=b1.Lp, max_rows=_W2ROWS,
                max_keys=Bp + 1, rl=rl, **key_kw)
            devs.append((r1, None, ck, sub))
        return devs

    def hw1_device_parts(devs):
        """Fetch and check each wave-2 slice's key table (JAX :1004-1044).
        Returns (parts, valids) for EcResolver.process_compact_parts, with
        first_idx mapped to the batch's read indices through the slice's
        read list (a key first seen on a padding row -- only the no-hit
        key -- sorts last), or None when a wave-2 read overflowed its row
        budget."""
        parts, valids = [], []
        for r1, r2, ck, sub, *_ in devs:
            arr = _fetch_ck(ck)
            uniq_h, occ, first_local, flags, n_uniq = unflatten_ck_host(arr)
            valid = np.flatnonzero(occ > 0)
            if n_uniq > occ.shape[0] or (flags[valid] & 12).any():
                return None
            part, valid = _table_part(
                uniq_h, occ, first_local, r1, r2, spec,
                lambda fl, sub=sub: np.where(
                    fl < sub.shape[0], sub[np.minimum(fl, sub.shape[0] - 1)],
                    np.int64(1) << 60))
            parts.append(part)
            valids.append((valid, occ.shape[0]))
        return parts, valids

    def host_part(hk, paired_part):
        """The host keys as a part of process_compact_parts (with the slim
        columns of a pair key: rows1[:2], rows2[:2], flags)."""
        ex, Rh = hk.exemplars, hostprobe.R
        slim = None
        if paired_part:
            def slim(sel):
                return ex[sel][:, [0, 1, Rh, Rh + 1, 2 * Rh]]
        return (hk.h128, hk.occ, hk.first_idx, lambda sel: ex[sel], Rh, slim)

    def process_hw1(ctx):
        """Resolve a host-wave-1 batch (JAX :1052-1182, :1438-1462): host
        and card keys merged by first read; hw1pb also maps every read to
        its EC (host keys through the read's h1, card keys through the
        read's row from kernel E) for --pseudobam and the FLD subsample.
        A batch whose wave-2 read overflowed its row budget is redone per
        read."""
        nonlocal num_processed, tlencount
        route, b1, b2, hk, devs = ctx[:5]
        t1 = time.perf_counter()
        with span("fetch", "fetch_s"):
            got = hw1_device_parts(devs)
        t2 = time.perf_counter()
        if route == "hw1":
            tlog("w2fetch", t1)
        if got is None:
            # rare: redo per read; unlike JAX (:1136-1145, which drops the
            # batch's fragment lengths here) with want_fld kept, so that
            # the FLD sample does not depend on the route
            timings["fallback"] += 1
            want_tl = route == "hw1pb" and ctx[5]
            for lo in range(0, b1.n, _FALLBACK_CAP):
                hi = min(lo + _FALLBACK_CAP, b1.n)
                process_full(dispatch_full(
                    _slice_packed(b1, lo, hi),
                    None if b2 is None else _slice_packed(b2, lo, hi),
                    want_tl))
            return
        with span("resolve", "resolve_s"):
            parts, valids = got
            paired_b = b2 is not None
            has_host = hk.h128.shape[0] > 0
            if has_host:
                parts.insert(0, host_part(hk, paired_b))
            key_ecs = resolver.process_compact_parts(
                parts, paired=paired_b, do_union=opt.do_union,
                return_key_ecs=route == "hw1pb")
            if route == "hw1":
                tlog("resolve", t2)
            nf = hk.fail_idx.shape[0]
            if paired_b:
                timings["wave2_reads"] += int(
                    nf + (hk.fail_side == 3).sum())
                hw1_stats[0] += 2 * b1.n - 2 * nf
                hw1_stats[1] += 2 * b1.n
            else:
                timings["wave2_reads"] += nf
                hw1_stats[0] += b1.n - nf
                hw1_stats[1] += b1.n
            if route == "hw1pb":
                B = b1.n
                read_ec = np.full(B, -1, np.int64)
                f1 = {f: np.zeros(B, np.int32) for f in ("f_block", "f_upos",
                                                          "f_rpos")}
                f2 = {f: np.zeros(B, np.int32) for f in ("f_block", "f_upos",
                                                          "f_rpos")}
                for f in (f1, f2):
                    f["f_strand"] = np.zeros(B, bool)
                    f["has_hits"] = np.zeros(B, bool)
                if has_host:
                    # host-verified reads: EC through the read's key word h1,
                    # first hits from the probe's per-read info
                    kh = hk.h128[:, 0]
                    ko = np.argsort(kh)
                    vmask = hk.read_h1 != 0
                    rh = hk.read_h1[vmask].view(np.int64)
                    read_ec[vmask] = key_ecs[0][
                        ko[np.searchsorted(kh[ko], rh)]]
                    vi = hk.vinfo[vmask]
                    idxs = np.flatnonzero(vmask)
                    for f, c0, c1 in ((f1, 0, 1), (f2, 2, 3)):
                        f["f_block"][idxs] = vi[:, c0]
                        f["f_upos"][idxs] = vi[:, c1] >> 1
                        f["f_strand"][idxs] = (vi[:, c1] & 1) == 1
                        f["has_hits"][idxs] = True
                tl = hk.read_tl.copy()
                want_fld_f = ctx[5] and tlencount < flen_goal
                for (r1, r2, _, sub, slots), (valid, K), kec in zip(
                        devs, valids, key_ecs[int(has_host):]):
                    # card reads: EC through the row kernel E gave the
                    # read's key
                    n_s = sub.shape[0]
                    inv = np.full(K, -1, np.int64)
                    inv[valid] = np.arange(valid.shape[0])
                    read_ec[sub] = kec[inv[slots[:n_s].cpu().numpy()]]
                    for f, r in ((f1, r1), (f2, r2)):
                        for name in ("f_block", "f_upos", "f_rpos", "f_strand",
                                     "has_hits"):
                            f[name][sub] = getattr(r, name)[:n_s].cpu().numpy()
                    if want_fld_f:
                        tl[sub] = read_keys(r1, r2, k)[1][:n_s].cpu().numpy()
                if pbam is not None:
                    pbam.add_compact(read_ec, f1, f2)
                if want_fld_f:
                    # the per-read route's subsample: host tl for verified
                    # pairs, kernel B's mapPair length for wave-2 pairs
                    cards = ec_cards.get()
                    read_card = np.where(read_ec >= 0,
                                         cards[np.maximum(read_ec, 0)], 0)
                    ok = ((tl > 0) & (tl < MAX_FRAG_LEN) & (read_card == 1)
                          & f1["has_hits"] & f2["has_hits"])
                    take = np.flatnonzero(ok)[: flen_goal - tlencount]
                    fl_samples.append(tl[take].astype(np.int64))
                    tlencount += take.shape[0]
            num_processed += b1.n
            timings[route] += 1

    def process(ctx):
        nonlocal num_processed
        if ctx[0] == "multi":
            for sub in ctx[2]:
                process(sub)
            return
        if ctx[0] in ("hw1pb", "hw1", "hw1s"):
            process_hw1(ctx)
            return
        if ctx[0] == "full":
            process_full(ctx)
            timings["full"] += 1
            return
        if ctx[0] == "long":
            process_long(ctx)
            return
        # one key table (turbo, compact), or one per shard in mesh order
        # (cmesh, whose shard s holds reads [s * sb, (s + 1) * sb))
        route, b1, b2 = ctx[:3]
        if route == "cmesh":
            r1s, r2s, cks, sb = ctx[3:]
        else:
            r1s, r2s, cks, sb = [ctx[3]], [ctx[4]], [ctx[5]], 0
        with span("fetch", "fetch_s"):
            arrs = [_fetch_ck(ck) for ck in cks]
        with span("resolve", "resolve_s"):
            tables = [unflatten_ck_host(arr) for arr in arrs]
            if route == "turbo":
                n_uniq = tables[0][4]
                timings["n_uniq_max"] = max(timings["n_uniq_max"], n_uniq)
                timings["n_uniq_sum"] += n_uniq
                timings["wave2_reads"] += ck_n_fail(arrs[0])
            fits = all(n_uniq <= occ.shape[0]
                       and not (flags[occ > 0] & 12).any()
                       for _, occ, _, flags, n_uniq in tables)
            if fits:
                parts = [
                    _table_part(uniq_h, occ, first_idx, r1, r2, spec,
                                lambda fl, off=s * sb: fl + off)[0]
                    for s, ((uniq_h, occ, first_idx, _, _), r1, r2)
                    in enumerate(zip(tables, r1s, r2s))]
                resolver.process_compact_parts(parts, paired=paired,
                                               do_union=opt.do_union)
                num_processed += b1.n
                timings[route] += 1
        if fits:
            return
        # rare: a read exceeded R distinct rows or the batch exceeded its
        # key table -- redo this batch per read, in memory-bounded slices
        timings["fallback"] += 1
        for lo in range(0, b1.n, _FALLBACK_CAP):
            hi = min(lo + _FALLBACK_CAP, b1.n)
            process_full(dispatch_full(
                _slice_packed(b1, lo, hi),
                None if b2 is None else _slice_packed(b2, lo, hi), False))

    def process_full(ctx):
        nonlocal num_processed, tlencount, bias_total
        _, b1, b2, r1, r2, h, tl, hx = ctx
        t1 = time.perf_counter()
        # one device->host copy of each per-read array per batch (waits for
        # the batch's kernels)
        with span("fetch", "fetch_s"):
            s1 = r1.to_numpy()
            s2 = r2.to_numpy() if r2 is not None else None
            hh = h.cpu().numpy()
            tl_h = tl.cpu().numpy() if tl is not None else None
            hx_h = hx.cpu().numpy() if hx is not None else None
        with span("resolve", "resolve_s"), \
                span("resolve.per_read", "resolve_per_read_s"):
            # JAX writes these lines for pairs only (process_pair)
            ftlog = tlog if paired else (lambda tag, t: time.perf_counter())
            t3 = ftlog("full:hashes", t1)
            read_uidx, uniq_sets = resolver.resolve_batch_hashed(
                hh, _exemplar_fetcher(r1, r2, KeySpec()),
                int(s1.rows.shape[1]), paired=paired, do_union=opt.do_union,
            )
            t3 = ftlog("full:resolve", t3)
            _apply_overflow_fallback(
                resolver, index, read_uidx, uniq_sets, opt.do_union, (s1, b1),
                (s2, b2) if paired else None,
            )
            ftlog("full:overflow", t3)
            final_idx, final_sets = read_uidx, uniq_sets
            if opt.min_range > 1:
                # a mate whose hit span is under min_range empties its EC
                # set inside intersectECs, vetoing the fragment
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
                    # reference: filter only when at least one mate had no
                    # hits (ProcessReads.cpp:1095); both-empty reads are
                    # unmapped
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
                        final_idx, final_sets, s1.has_hits, s1.f_block,
                        s1.f_strand,
                    )
            read_ec, read_card = resolver.count_batch(final_idx, final_sets)
            num_processed += b1.n
            if pbam is not None:
                _record_pbam(pbam, read_ec, s1, s2)
            if hx_h is not None and bias_total < _BIAS_GOAL:
                # a batch that crosses the goal is counted whole, as in JAX
                m = (read_ec >= 0) & (hx_h >= 0)
                np.add.at(bias5, hx_h[m], 1)
                bias_total += int(m.sum())
            if tl_h is not None and tlencount < flen_goal:
                ok = (
                    (tl_h > 0)
                    & (tl_h < MAX_FRAG_LEN)
                    & (read_card == 1)
                    & s1.has_hits
                    & s2.has_hits
                )
                take = np.flatnonzero(ok)[: flen_goal - tlencount]
                fl_samples.append(tl_h[take].astype(np.int64))
                tlencount += take.shape[0]

    novel_recs = []  # novel.fastq records, written after the loop
    lr_resolver = lr_cache = None
    if opt.long_read:
        # strict intersection without the off-list mask; the mask comes
        # after the mode fallback (JAX :1612)
        lr_resolver = EcResolver(index, mask_offlist=False)
        lr_cache = {}

    def dispatch_long(b1: PackedBatch):
        """Enqueue kernel J on one batch of long reads."""
        return ("long", b1, pseudoalign_long_packed(
            didx, *upload_batch(b1, dev), k=k, L=b1.Lp))

    def process_long(ctx):
        """Resolve one batch of long reads (JAX :1621-1654): novel reads
        (more than threshold * len unmapped k-mers) are not counted; they
        and the reads without a set go to novel.fastq."""
        nonlocal num_processed
        _, b1, lr = ctx
        with span("fetch", "fetch_s"):
            h = lr.to_numpy()
        with span("resolve", "resolve_s"):
            sets, novel, recs = resolve_long_reads(
                h, b1.lens, opt.threshold, lr_resolver, index.num_onlist,
                b1.row_codes, cache=lr_cache, write_unset=True)
            resolver.count_batch(np.arange(b1.n, dtype=np.int64), sets)
            num_processed += b1.n
            timings["long"] += 1
            timings["novel"] += int(novel.sum())
            novel_recs.extend(recs)

    # stderr chatter matching the reference's ProcessReads prologue
    # (src/ProcessReads.cpp:196-231)
    if opt.long_read:
        _log("[quant] running in long read mode")
        for i, f in enumerate(opt.files):
            _log(f"[quant] will process file {i + 1}: {f}")
        batch_iter = (
            (b, None) for f in opt.files
            for b in packed_single_batches(
                f, min(opt.batch_size, _LONG_BATCH), k)
        )
    elif paired:
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
        if estimate_fld and not sharded:
            batch_iter = _split_first_pair_batch(batch_iter)
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
    if opt.verbose:
        _log("")
    progress = _Progress(resolver)

    def drain():
        ctx = pend.popleft()
        process(ctx)
        progress.update(ctx[1].n, num_processed)

    # pipelined loop: up to two batches stay pending (dispatched, their
    # kernels running on the card) while the oldest resolves on the host,
    # as in JAX (pipeline.py:1695-1697, :1717-1719).  The depth is part of
    # the routing: a batch's want_fld / want_bias are read at dispatch from
    # the batches processed by then, so it decides how many batches go per
    # read after the bias goal is reached.  Without host wave 1, while the
    # FLD is being learned every pending batch is processed before the next
    # dispatch, so the batch that reaches the goal is the last one sent per
    # read (JAX :1688-1694); with it, FLD learning pipelines too (a batch
    # sent on hw1pb after the goal only carries unused lengths, and the
    # subsample still takes the first reads in read order).
    pend = deque()
    with span("read_loop", "pseudoalign_s"):
        while True:
            with span("read", "read_s"):
                batch = next(batch_iter, None)
            if batch is None:
                break
            b1, b2 = batch
            if estimate_fld and tlencount < flen_goal and hostprobe is None:
                while pend:
                    drain()
            with span("dispatch", "dispatch_s"):
                want_fld = estimate_fld and tlencount < flen_goal
                pend.append(dispatch_long(b1) if opt.long_read
                            else dispatch(b1, b2, want_fld))
            if len(pend) > 2:
                drain()
        while pend:
            drain()
        if opt.long_read and opt.output_dir:
            os.makedirs(opt.output_dir, exist_ok=True)
            with open(os.path.join(opt.output_dir, "novel.fastq"), "w") as f:
                f.write("".join(novel_recs))
    # completion summary (JAX :1724-1740)
    if opt.verbose or progress.printed:
        _log("\n[quant] done ")
    else:
        _log(" done")
    if opt.verbose and timings["pseudoalign_s"] > 0:
        _log(
            f"[quant] pseudoalignment throughput: "
            f"{num_processed / timings['pseudoalign_s']:,.0f} reads/s"
        )
    if opt.verbose and hw1_stats[1]:
        _log(
            "[quant] host wave-1 verified "
            f"{100.0 * hw1_stats[0] / hw1_stats[1]:.1f}% of "
            f"{hw1_stats[1]:,} steady-state mates on the host"
        )
    fl_vec = np.concatenate(fl_samples) if fl_samples else np.empty(0, np.int64)
    if n_hosts > 1:
        # every rank merges in rank order, the global read order (JAX
        # :1750-1810): the FLD subsample's prefixes, the EC maps, and the
        # sums of the processed reads and the hexamers
        if estimate_fld:
            fl_vec = multihost.merge_fld_prefixes(fl_vec, flen_goal)
        resolver.set_ecs(*multihost.merge_host_ec_maps(
            resolver.ec_sets, resolver.counts_array()))
        sums = multihost.allgather_int64(
            np.concatenate([[num_processed], bias5])).sum(axis=0)
        num_processed, bias5 = int(sums[0]), sums[1:]
        _log(f"[quant] multi-host merge: {n_hosts} processes")
    if opt.bias:
        _log("[quant] learning parameters for sequence specific bias")
    _log(
        f"[quant] processed {num_processed:,} reads, "
        f"{resolver.num_mapped:,} reads pseudoaligned"
    )
    if resolver.num_mapped == 0:
        _log("[~warn] no reads pseudoaligned.")

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

    with span("em_problem", "em_problem_s"):
        counts = resolver.counts_array()
        problem = build_em_problem(resolver.ec_sets, index.num_trans)
    bias_update = None
    if opt.bias:
        with span("bias_tables", "bias_tables_s"):
            hxcache = TranscriptHexamers(index)

        def bias_update(alpha, cur_eff):
            with span("bias_update", "bias_update_s"):
                return update_eff_lens(fl_means, bias5, hxcache,
                                       index.target_lens, alpha, cur_eff,
                                       opt.strand)

    priors = read_priors(opt.priors, index.num_trans) if opt.priors else None
    _log("[   em] quantifying the abundances ...", end="")
    # the long-read EM adds singleton counts after the loop unless the
    # platform is ONT (JAX :1851; reference: EMAlgorithm.h:111, 224-357)
    with span("em", "em_s"):
        em = run_em(problem, counts, eff_lens, n_iter=10000, min_rounds=50,
                    priors=priors, bias_update=bias_update, device=dev,
                    singletons_after=opt.long_read
                    and opt.platform.upper() != "ONT")
    _log(" done")
    _log(
        "[   em] the Expectation-Maximization algorithm ran for "
        f"{em.n_rounds:,} rounds"
    )
    if opt.bias:
        eff_lens = em.eff_lens
    tpm = counts_to_tpm(em.alpha, eff_lens)
    num_pseudoaligned = int(counts.sum())
    num_unique = resolver.num_unique_reads()

    bootstraps: Optional[np.ndarray] = None
    if opt.bootstrap > 0 and num_pseudoaligned > 0:
        with span("bootstrap", "bootstrap_s"):
            bootstraps = run_bootstraps(problem, counts, eff_lens,
                                        opt.bootstrap, opt.seed, device=dev)
    elif opt.bootstrap > 0:
        # nothing aligned: the reference writes the (empty) main EM result
        # for every bootstrap (main.cpp:2732-2743)
        bootstraps = np.tile(em.alpha, (opt.bootstrap, 1))

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
        bias5=bias5 if opt.bias else None,
        bootstraps=bootstraps,
    )

    if opt.output_dir:
        with span("write", "write_s"):
            # off-list (D-list) pseudo-targets are excluded from abundance
            # outputs (reference: only onlist targets are reported)
            nl = index.num_onlist
            os.makedirs(opt.output_dir, exist_ok=True)
            writers.write_abundance_tsv(
                os.path.join(opt.output_dir, "abundance.tsv"),
                result.target_names[:nl], result.target_lens[:nl],
                eff_lens[:nl], em.alpha[:nl], tpm[:nl],
            )
            if bootstraps is not None and opt.plaintext:
                for b in range(bootstraps.shape[0]):
                    writers.write_bootstrap_tsv(
                        opt.output_dir, b, result.target_names[:nl],
                        result.target_lens[:nl], eff_lens[:nl],
                        bootstraps[b][:nl],
                        counts_to_tpm(bootstraps[b], eff_lens)[:nl],
                    )
            if not opt.plaintext:
                from ..io.h5 import HAVE_H5PY, write_abundance_h5

                if HAVE_H5PY:
                    write_abundance_h5(
                        os.path.join(opt.output_dir, "abundance.h5"),
                        est_counts=em.alpha[:nl],
                        target_names=result.target_names[:nl],
                        lengths=result.target_lens[:nl],
                        eff_lens=eff_lens[:nl],
                        fld=fld,
                        bias_observed=(
                            bias5.astype(np.int32) if opt.bias
                            else np.ones(NUM_6MERS, np.int32)
                        ),
                        bias_normalized=(
                            em.post_bias
                            if opt.bias and em.post_bias is not None
                            else np.ones(NUM_6MERS, np.float64)
                        ),
                        num_bootstrap=opt.bootstrap,
                        num_processed=num_processed,
                        kallisto_version=KALLISTO_COMPAT_VERSION,
                        index_version=REFERENCE_INDEX_VERSION,
                        start_time=start_time,
                        call=opt.call,
                        bootstraps=(
                            bootstraps[:, :nl] if bootstraps is not None
                            else None
                        ),
                    )
                else:
                    _log("[~warn] h5py is not installed: abundance.h5"
                         + (f" and its {opt.bootstrap} bootstraps"
                            if opt.bootstrap > 0 else "")
                         + " not written (--plaintext writes them as text)")
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
            if pbam is not None:
                bam_path = os.path.join(opt.output_dir, "pseudoalignments.bam")
                _log("[  bam] writing pseudoalignments to BAM format .. ",
                     end="")
                if opt.genomebam:
                    write_pseudobam_genome(
                        bam_path, index, pbam, resolver.ec_sets, em.alpha,
                        eff_lens, counts, model, KALLISTO_COMPAT_VERSION,
                        read_stream=_pbam_read_stream(opt, k),
                    )
                else:
                    write_pseudobam_trans(
                        bam_path, index, pbam, resolver.ec_sets, em.alpha,
                        eff_lens, counts, KALLISTO_COMPAT_VERSION,
                        read_stream=_pbam_read_stream(opt, k),
                    )
                _log("done")
    return result
