#!/usr/bin/env python3
"""Smoke run of kallisto_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path -- `quant` on paired-end reads: the per-read
path while the fragment-length distribution is learned, then the compact
steady state (uniform-length turbo batches through the two-wave anchor
kernel, reduced to a key table) --, `quant --bias -b 100` (hexamers per
read, the bias EM, 100 bootstraps through the batched EM), `bus -x
10xv2`, `quant --long` and `bus --long` (the long-read kernel) and
`quant-tcc` (the batched EM per cell) on the card, then `quant` with host
wave 1 and `--pseudobam` / `--genomebam`, then `quant`, `bus` and
`quant-tcc` over four shards, and holds every CUDA kernel of those paths
against its plain PyTorch version, then the padded index layout (K2's
probe inside kernels A, D, I, J and K, and alone as kernel L) at the
largest size that keeps it.  Phases 1-5e run with host
wave 1 off (KALLISTO_TPU_HOST_WAVE1=0: the card's own routes), phases 4e
and 5f with it on as well.  Phase 2's index and everything built on it
take the bucketed layout (2^27 buckets would need 2 GiB of padded rows);
tests/data's indexes (phases 4-4e) and phase 3g's take the padded one:

1. device: requires CUDA, prints the card's name and power limit, builds
   the kernels (one nvcc per source, in parallel);
2. set-up at realistic size: a 10,000-gene isoform-structured transcriptome
   (~29k targets, ~24M distinct 31-mers), its index built by the port's
   index build with its native helpers (csrc/ktio.cpp: k-mer scans, hashed
   lookups, reverse complements on min(8, CPUs) threads; every helper
   called, the seconds printed), and 1,000,000 simulated 2x100 bp pairs;
2b. those pairs read through the native reader (quant's reader,
   csrc/ktio.cpp) and through the Python reader (its plain version) at
   quant's batch size: every batch equal, both read times printed;
3. kernels A (pseudoalign_side: wave 1, then wave 2, from one call) and B
   (read_keys, the per-read form) on the card against their plain
   versions on the CPU, at
   the main path's batch shape (2x100 bp and 76 bp reads with random Ns,
   ragged lengths and reads shorter than k): every field must be equal,
   and A's wave-2 count equal to the plain two-wave composition's
   (anchor.side_waves_plain, on the card); A timed with its waves alone
   (wave 2 beside its plain version, the listed share printed); its
   bound counts the anchors of verified reads and the windows of wave-2
   reads (_side_bytes); then pseudoalign_batch, kernel A on unpacked
   codes (pseudoalign_codes), on the batch's mate-1 codes (width 100, Ns
   and codes above 4, ragged lengths, reads shorter than k) with the launch
   counts set to 0 just before and read just after (its own path, the
   JAX package's single-chip program; both waves launched), held against
   _pseudoalign_core and the plain two-wave model on the card
   (anchor.codes_waves_plain: every field, the wave-2 reads and the
   windows its covered-interval core probed, the kernel's `probes`
   count), and timed: both waves, each alone, and the device time from
   graph replays; its wave-2 share, the share of wave 2's windows skipped,
   and two bounds, the dense work's (every window, the earlier rows'
   formula) and the design's (_skip_bytes: the windows it probes); then
   kernel L (lookup_kmers, the probe alone) on this bucketed index (its
   packed (key, EC row) entries) and the batch's mate-1 windows: held
   against the plain lookup_kmers, timed from the host and as device
   time (_l_phase2);
3b. kernels D (pseudoalign_turbo), E (compact_keys: the compact key fused
   into the key table) and F (gather_exemplars) against their plain
   versions on the card: a paired turbo batch at the main path's Bp =
   262,144 with sparse Ns, a ragged-length batch, a single-end batch, a
   bitmask (N-dense) batch, and keys with min_range 50, the strand tail
   and the position rank; every field, every read's key and every table
   entry must be equal; E's device time (graph replays, graph_ms) beside
   its time from the host, and E on the batch's own keys given as keys
   and with 60 % of the reads moved onto one key (held, device times);
3c. kernel H, the epilogue of kernel B's launch (read_keys with bias=),
   on the phase-3 pairs (valid = mate 2's has_hits) and the 76 bp
   single-end reads (all valid): keys and fragment lengths equal to B
   alone and to the plain version, hexamer ids equal to
   bias_hexamers_plain; B alone and B + H timed in turns, from the host
   and as device time;
3d. kernel I (pseudoalign_anchor) against its plain version on the card,
   at the main path's shapes (262,144 pairs of 100 bp padded to 104, 4
   anchors, sparse Ns), paired and single-end: every field and n_fail
   equal, and with kernel E the key table (n_fail in its meta row)
   equal; against kernel D on the same batch: rows, row counts, hits,
   overflow flags and the key table equal; both forms timed (I's two
   launches, wave 1 and wave 2 on the reads it listed, together, and the
   paired form's waves alone, wave 2 beside its plain version), and kernel
   B's single-end form on I's reads (bus's chunk);
3e. kernel J (pseudoalign_long) against its plain version on the card, on
   16,384 long reads generated from phase 2's transcriptome (whole and
   5'-truncated transcripts, 1 % substitutions, half reverse-complemented,
   random Ns, reads shorter than k, random reads, chimeras of 3-8
   transcripts and mosaics of 140-180 pieces, so that reads pass both the
   64-row and the 128-group budgets): all eight fields equal; timed (a
   stress test: J's row is timed at phase 5d's shape); J's byte bound,
   like A's, D's, I's, K's and L's, counts each 32-byte table sector its
   probes and payload reads touch once (_sector_ids);
3f. kernels K (pseudoalign_halffail), E with per-read slots and F's slim
   layout (gather_slim) against their plain versions on the card: the
   first 524,288 of phase 2's pairs with sparse Ns through the port's host
   probe, the half-fail wave-2 slice at Bp = 262,144 and at the smallest
   bucket, 16,384, keys with the strand tail and the position rank; every
   field, table entry and slot equal, every slot naming its read's own
   key, K's probed failed-mate windows equal to anchor.skip_core_plain's
   mask (K's device time, skipped share and both bounds beside its time,
   as phase 3 gives A on codes'); the both-failed slice through D and E
   with slots; timed, with
   torch.unique(h0, return_inverse=True) beside E's slots (stress slices:
   the kernels' rows are timed on phase 5f's own slices);
3g. the padded layout: an 800-gene transcriptome (seed 42; ~1.9M k-mers,
   p = 23, S = 8: 1 GiB of bucket rows, the JAX package's budget), its
   index built with the native helpers and with numpy (the threshold out
   of reach), equal array for array, both times printed; the index must
   take the padded layout (M, S, row bytes and nbytes()
   printed), the same index bucketed (budget 0) beside it, and 524,288
   simulated 2x100 bp pairs from it; kernels A, D, I, J and K against
   their plain versions on the padded index, each on one batch of at most
   65,536 reads (16,384 long reads) built and held by the same helpers
   as phases 3, 3b, 3d, 3e and 3f (K after the host probe, with E's slots
   and F slim): every field equal; kernel L (lookup_kmers) against the
   plain lookup_kmers in both layouts (bucketed through its packed
   entries) on A's windows, invalid ones included, and on windows
   0 (q = mix64(0)): slot, hit and EC row equal; A on codes held in
   both layouts; A (262,144 reads, phase 3's
   shape) held in both layouts with its wave-2 count (_hold_a); then A
   and A on codes (262,144 reads), D and I (524,288 reads, phases 3b/3d's
   shape; A and I with their wave-2 shares), L (A's windows: padded
   and bucketed in turns, device times, each layout's three-take gather,
   torch.searchsorted beside the bucketed form) timed in both layouts,
   and
   D, J and K at their held shapes; A, D and I again at those shapes on
   an L2_GENES-gene index whose tables fit in the 50 MB L2 (A in both
   layouts and I held there first); L's bounds count each table sector
   its probes read once (_sector_ids);
4. golden bytes (phases 4-4e: every device index that their runs place is
   asserted padded (_padded_runs), so these are the padded path of A, D,
   I, J and K on the card against the goldens):
   `quant` paired, `--single -l 180 -s 20` and the half-mapped
   `-l 180 -s 20` pairs on tests/data, abundance.tsv byte-equal to
   tests/golden, run stats 10000/9413/7174, and the routes: per-read batches
   only for the paired run, turbo batches (no fallback) for the others;
4b. `-b 20` on tests/data: the reference replicates' distribution checks
   (tests/golden/quant_bs) and bs_abundance_*.tsv byte-equal between the
   card and the CPU; `--bias` paired and single-end: abundance.tsv and the
   observed hexamers equal between the card and the CPU; `--bias -l 180
   -s 20` paired with the bias goal cut to 3,000 reads and 1,024-read
   batches, so that batches go turbo after the goal: the same, with turbo
   batches on both;
4c. `bus` goldens on the card, indexes built by index/build.py:
   output.bus, matrix.ec and the other files the JAX tests compare, and
   the run stats, byte-equal to tests/golden for bus10xv2, bus_batch_bulk,
   bus_batch_10x, bus_inleaved, bus_rx, bus_smartseq3, bus_dfk, bus_aa_f0
   and bus_distinguish;
4d. long-read and TCC goldens on the card: `quant --long -P PacBio`
   (pseudoaligned within 1 of the reference's 399, est_counts within 2 in
   total, 40-42 novel.fastq headers; abundance.tsv and novel.fastq
   byte-equal to the CPU run), `bus --long` (matrix.ec and flens.txt
   byte-equal to tests/golden, output.bus a sub-multiset of the
   reference's and byte-equal to the CPU run), and the seven tcc*
   goldens byte-equal with the options of tests/test_tcc.py;
4e. `--pseudobam` and `--genomebam` on the card: pseudobam_clean's golden
   checks (header, references, records in name order, forward records'
   self fields) with host wave 1 on and off, the BAMs of the clean and the
   bundled pairs byte-equal card (on and off) and CPU; `--genomebam -g
   -c`: tests/test_genomebam.py's checks and BAM + BAI byte-equal card and
   CPU; `quant_paired` with host wave 1 on (hw1pb) byte-equal to the golden;
5. the main path at realistic size: `quant` of the 1M pairs on the card
   with every launch count set to 0 just before and read just after, the
   kernels A, B, I (both waves), E, F (and its slim layout) and G all
   launched, and every A call's wave 1 listed reads for its wave 2 (its
   list lengths read after the run, _side_lists); its FASTQs read by the
   native reader (read_s printed); checks of its output; the same pairs again with every batch per read (equal EC counts and sets); kernel D's path:
   the first 65,536 pairs, mate 1 cut to mixed lengths (96-100 bp), with
   batch 8192 and an FLD goal of 1000, so that the turbo batches take
   kernel D, on the card (counts set to 0 just before, D launched, I not)
   and on the CPU (equal EC counts and sets);
5i. (right after phase 5) the observability hooks: `quant` of the first
   262,144 pairs with KALLISTO_TPU_PROFILE (a torch.profiler trace of the
   whole run, CPU and CUDA activities, run_quant's spans its ranges) and
   KALLISTO_TPU_TIMING: the trace file written, the card's busy time
   inside the read loop's span (the union of its CUDA kernel, copy and
   set events) beside the loop's wall, one `[time] full:` line of each
   tag per per-read batch;
5b. the slice at realistic size: `quant --bias -b 100 --plaintext` of the
   same pairs with the launch counts set to 0 just before and read just
   after, kernels G and H launched; hexamers counted, effective lengths
   changed, 100 replicates that each conserve the aligned mass, EC counts
   and sets equal to phase 5's;
5c. `bus -x 10xv2` at realistic size: 1M reads, read 1 a 16 bp barcode
   from a 4,096-barcode pool plus a 10 bp UMI, read 2 the cDNA (phase 5's
   mate-1 reads: sense-strand 100 bp, as a 10xv2 read 2 is; the 10xv2
   strand filter would drop the antisense mate 2), 262,144-read chunks,
   launch counts set to 0 just before and read just after, kernel I
   launched; then the same input with the anchor route bypassed (the
   smoke replaces _BusRun._anchor_single and _anchor_pair): output.bus and
   matrix.ec byte-equal and the run stats equal;
5d. long reads at realistic size: 100,000 reads (95 % whole or
   5'-truncated transcripts, 5 % random); kernel J against its plain
   version on the card on quant's first 16,384-read batch (all eight
   fields equal) and timed there; `quant --long -P PacBio
   --plaintext` with the launch counts set to 0 just before and read just
   after (J once per 16,384-read batch, G launched), >= 90 % of the random
   reads in novel.fastq and >= 90 % of the others pseudoaligned; `bus -x
   bulk --long` (J launched; no bus run of this phase writes index.saved,
   ~1 min of host compression, for the time limit); the first 4,096 reads on the card and on the
   CPU: abundance.tsv and output.bus byte-equal;
5e. `quant-tcc` at realistic size: phase 5c's output.bus collapsed to a
   cells x ECs MatrixMarket file (distinct UMIs per barcode and EC, as
   `bustools count --tcc`), with 5c's matrix.ec and the index, no -l/-s:
   ~4,096 cells in chunks of 256 through kernel G with per-cell lengths
   (launch counts set to 0 just before; G counts the EM_CHUNK rounds of
   each graph replay, and the replays must cover the rounds read back
   from the card with less than a chunk to spare per EM);
   the first 256 cells on the card and on the CPU: est_counts bitwise
   equal and matrix.abundance.mtx byte-equal; one update of kernel G at
   that shape (modes mixed) bitwise equal to the plain version on the
   CPU; kernel G timed at that shape per round, by CUDA events over one
   chunk of the EM loop's rounds (one graph replay), and the EM's host
   reads printed;
5f. host wave 1 at realistic size: the 1M pairs with the switch on and the
   launch counts set to 0 just before (hw1pb while the FLD is learned,
   then hw1; K, E with slots, F slim, D, B, F and G launched), FLD, EC
   counts and sets equal to phase 5's, the wall and probe_s printed; K, E
   with slots and F slim held against their plain versions and timed on
   the first hw1 batch's half-fail slice, D + E with slots on its
   both-failed slice, K and D timed on every slice of the run (the card's
   busy time); then `--pseudobam` of the first 32,768 pairs with the
   switch on and off: BAM byte-equal;
5g. several devices: N_SHARDS = 4 shards on the visible cards (with one
   card all four share cuda:0, and the phase says so): `quant` of the
   first 262,144 of phase 2's pairs in batches of 65,536 (per read,
   sharded, while the FLD is learned, then `cmesh`: A and E per shard,
   E computing the keys), launch counts set to 0 just before and read
   just after (A, B, E, F and G launched, I, D and K not), EC counts and sets, est_counts
   and the FLD equal to one device; `bus -x 10xv2` of the first 262,144
   of phase 5c's reads (output.bus and matrix.ec byte-equal to one
   device); `quant-tcc` of the first 1,024 of phase 5e's cells (est_counts
   bitwise equal); `dryrun_multichip(4)` on the card; K18's step (A's two
   waves on both mates and E on one shard of 16,384 pairs: five
   launches) held against its plain versions on every shard and timed
   (device time from graph replays beside it), the whole 4-shard step
   beside it;
5h. the padded layout end to end: `quant` of phase 3g's 524,288 pairs on
   its padded index with the launch counts set to 0 just before and read
   just after (A, B, I, E, F and G launched, the turbo batches through
   I), then the same run with the padded budget set to 0 (bucketed): EC
   counts and sets, FLD and est_counts equal; the wall, index_upload_s
   and read_s of both printed;
6. kernel G (em_step_batch) with one replicate, the main EM, on the main
   path's EM problem: the whole EM (its rounds and stop rule on the card,
   CUDA graph chunks) against the plain loop on the CPU, bitwise equal
   alpha and equal rounds, G's launches the chunks that cover its rounds;
   the whole EM's wall and host reads; the round timed over one chunk
   (em_chunk_ms);
6b. kernel G on the same problem with replicates: 8 resampled from phase
   5's counts, the whole batched EM on the card bitwise equal to the plain
   version on the CPU with equal rounds per replicate; then one update of
   100 replicates (a graph of one round) with frozen, updating and
   zeroing replicates mixed, bitwise equal to the plain version on the
   CPU; then 100 replicates' EM on the card, its wall, host reads and
   launches against its rounds, and the round timed over one chunk;
7. one `kernels` JSON line, then the result line.

Any failed check raises, which ends the run with a non-zero exit and no
result line.  Without CUDA, or outside a checkout of the repo, it exits
non-zero before doing anything.
"""

import contextlib
import gzip
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

N_GENES = 10000
N_PAIRS = 1_000_000
PROFILE_PAIRS = 262_144  # phase 5i: quant of the first pairs, profiled
READ_LEN = 100
CPU_RERUN_PAIRS = 65536
N_LONG = 100_000
# pairs of phase 5f's --pseudobam runs: the BAM writer is host Python at
# 3-4 s per 10,000 pairs on the H100 machine, and the whole smoke must stay
# well inside its 1,200 s limit (a slow host took it to 1,005 s with 65,536)
PSEUDOBAM_PAIRS = 32_768
# batch counts by route in run_quant's timings
ROUTES = ("full", "turbo", "compact", "fallback")
# chunk counts by route, and kernel I's wave-2 reads, in run_bus's timings
BUS_ROUTES = ("anchor", "full", "fallback", "wave2_reads")
# phase 5g: shards over the visible cards, pairs and reads of its quant
# and bus (the first of phase 2's and 5c's), its batches, and cells of its
# quant-tcc (the first of phase 5e's)
N_SHARDS = 4
MESH_PAIRS = 262_144
MESH_BATCH = 65_536
MESH_CELLS = 1_024
# phases 3g and 5h: the padded index layout at the largest size the JAX
# package keeps it (2^p * S * 16 bytes of bucket rows within its 1 GiB
# budget: 800 simulated genes give p = 23, S = 8, exactly 1 GiB), pairs
# of 5h's quant (two default batches: the first per read learns the FLD,
# about 11 % of its pairs qualify, the second takes the turbo route), and
# the reads of each of 3g's holds
PADDED_GENES = 800
PADDED_PAIRS = 524_288
PADDED_HOLD = 65_536
# phase 3g's long reads for kernel J (phase 3e's stress batch)
PADDED_LONG = 16_384
# the main path's kernels (phase 5); H runs under --bias, G also under -b N
MAIN_PATH_KERNELS = ("pseudoalign_side", "pseudoalign_side_wave2",
                     "read_keys", "em_step_batch",
                     "pseudoalign_anchor", "pseudoalign_anchor_wave2",
                     "key_histogram", "gather_exemplars", "gather_slim")
# phase 5h's quant on the padded index: A and I (both waves), B, E, F and G
PADDED_PATH_KERNELS = ("pseudoalign_side", "pseudoalign_side_wave2",
                       "read_keys", "pseudoalign_anchor",
                       "pseudoalign_anchor_wave2", "key_histogram",
                       "gather_exemplars", "em_step_batch")
# phase 3g: genes of an index whose tables fit in the card's 50 MB L2,
# beside which D and I are timed at the same batch shape as on the 800-gene
# and 10,000-gene indexes
L2_GENES = 100

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the scalar
# (non-tensor) float32 rate, used here for integer operations, and float64.
PEAK_BYTES = 3.35e12
PEAK_INT_OPS = 67e12
PEAK_F64 = 34e12


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"check failed: {what}")
    log(f"  ok: {what}")


def est_counts_of(path):
    """The est_counts column of an abundance.tsv."""
    import numpy as np

    with open(path) as f:
        next(f)
        return np.array([float(line.split("\t")[3]) for line in f])


def read_file(path):
    with open(path) as f:
        return f.read()


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def cuda_ms(fn, reps, torch):
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps, torch):
    """Device milliseconds of one fn() call: CUDA events around reps replays
    of a CUDA graph that captured one call, so no host time lies between
    the events (median of 5 such runs).  cuda_ms's figure, taken from the
    host, includes the wrapper's host time.  Every replay reads the same
    inputs, so what fits in the 50 MB L2 stays there: an L2-warm time, not
    one of inputs read from HBM."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del g
    return statistics.median(times)


def bound(nbytes, nops, op_rate):
    tb = nbytes / PEAK_BYTES * 1e3
    to = nops / op_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def em_bound(Bb, T, E, M, own_eff=False):
    """Kernel G's bound for one update of Bb running replicates: alpha,
    singletons, next and counts per replicate, the shared inv_eff (one per
    replicate with own_eff) and CSR (flat_tx, tx_ec, both pointer arrays),
    mode and the change counts; about 4 float64 operations per flat entry
    and pass, 3 per EC and 10 per transcript."""
    nbytes = (8 * Bb * (3 * T + E) + 8 * T * (Bb if own_eff else 1) + 8 * M
              + 8 * (T + E + 2) + 8 * Bb)
    return bound(nbytes, Bb * (4 * M + 3 * E + 10 * T), PEAK_F64)


def em_update(np, emq, prob, alpha, mode):
    """One round of kernel G's loop (a graph of one round on the card)
    from alpha [Bb, T] with per-replicate modes (0 frozen, 1 update, 2
    update from the zeroed alpha) and the stop rule out of reach: (next
    [Bb, T], change counts [Bb]) as numpy, read back from the state."""
    Bb = alpha.shape[0]
    loop = emq.EmLoop(prob, alpha, min_rounds=2**31 - 1,
                      mode=mode.astype(np.int64), rounds=1)
    loop.set_bound(1)
    try:
        loop.run_chunk()
        st, bufs = loop.read(with_alpha=True)
    finally:
        loop.close()
    return bufs[1].T.copy(), st[4 + 2 * Bb:].astype(np.int32)


def g_launches_cover(emq, launches, rounds, loops):
    """Kernel G's launches, counted at each graph replay (EM_CHUNK rounds
    each), against the rounds that ran, read back from the card, over
    `loops` EM loops of one segment: each loop replays the fewest chunks
    that cover its rounds, so launches are whole chunks in
    [rounds, rounds + loops * (EM_CHUNK - 1)]."""
    c = emq.EM_CHUNK
    return (launches % c == 0
            and rounds <= launches <= rounds + loops * (c - 1))


def em_chunk_ms(torch, np, emq, prob):
    """Kernel G's ms per round on `prob` with every replicate running: CUDA
    events over one chunk of the EM loop (EM_CHUNK rounds, one graph
    replay; no replicate may stop: min_rounds is past the chunks timed),
    divided by its rounds."""
    T = prob.num_trans
    loop = emq.EmLoop(prob, np.full(T, 1.0 / T), min_rounds=2**31 - 1)
    loop.set_bound(2**62)
    try:
        return cuda_ms(loop.run_chunk, 10, torch) / loop.rounds
    finally:
        loop.close()


def truncate_fastq(src, dst, n_records, ragged=False):
    """The first n_records of a FASTQ; with ragged, record i loses its last
    i % 5 bases (mixed read lengths)."""
    with gzip.open(src, "rb") as f, gzip.open(dst, "wb", compresslevel=1) as g:
        for i in range(n_records):
            lines = [f.readline() for _ in range(4)]
            cut = i % 5 if ragged else 0
            if cut:
                for j in (1, 3):
                    lines[j] = lines[j].rstrip(b"\n")[:-cut] + b"\n"
            g.write(b"".join(lines))


@contextlib.contextmanager
def _native_calls():
    """Counts the calls of the index build's native helpers (io/native.py
    kmer_scan, u64_lookup, revcomp64) while the block runs: yields
    {name: calls}."""
    from kallisto_tpu_torch.io import native

    real = {n: getattr(native, n)
            for n in ("kmer_scan", "u64_lookup", "revcomp64")}
    calls = dict.fromkeys(real, 0)

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for name, fn in real.items():
        setattr(native, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(native, name, fn)


def build_timed(build_index, fasta, k, native_helpers):
    """(index, seconds, helper calls): the port's index build with its
    native helpers (threads = min(8, CPUs)), every helper called, or with
    the native threshold out of reach (numpy only, the build's plain
    version), none called."""
    from kallisto_tpu_torch.index import kmers

    old = kmers.NATIVE_MIN
    if not native_helpers:
        kmers.NATIVE_MIN = 1 << 62
    try:
        with _native_calls() as calls:
            t0 = time.perf_counter()
            index = build_index([fasta], k=k, threads=0)
            secs = time.perf_counter() - t0
    finally:
        kmers.NATIVE_MIN = old
    if native_helpers:
        check(all(calls.values()), f"index build called every native "
              f"helper {calls}")
    else:
        check(not any(calls.values()), "numpy index build: no native "
              "helper called")
    return index, secs, calls


def same_index(np, a, b):
    """Every array and field of two TpuIndexes equal."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def phase_2b(np, fastx, r1p, r2p, batch, k):
    """Phase 2's pairs through both readers: the native reader
    (packed_paired_batches, quant's reader: csrc/ktio.cpp, BGZF blocks
    inflated on 3 workers) and the Python reader (single_batches +
    _read_batch_to_packed, its plain version) at quant's batch size;
    every batch equal (n, Lp, packed, nmask, lens), both read times
    printed.  Returns the summary."""
    t0 = time.perf_counter()
    nat = list(fastx.packed_paired_batches(r1p, r2p, batch, k))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = [(fastx._read_batch_to_packed(a, k), fastx._read_batch_to_packed(b, k))
          for a, b in zip(fastx.single_batches(r1p, batch),
                          fastx.single_batches(r2p, batch))]
    python_s = time.perf_counter() - t0

    def same(x, y):
        return (x.n == y.n and x.Lp == y.Lp
                and np.array_equal(x.packed, y.packed)
                and np.array_equal(x.nmask, y.nmask)
                and np.array_equal(x.lens, y.lens))

    n = sum(b1.n for b1, _ in nat)
    check(len(nat) == len(py) and all(
        same(x, y) for bn, bp in zip(nat, py) for x, y in zip(bn, bp)),
        f"phase 2b: {len(nat)} batches of {n} pairs equal, native reader "
        "and Python reader")
    log(f"reader: native {native_s:.3f} s, Python {python_s:.3f} s for "
        f"{n} pairs in batches of {batch} ({n / native_s:,.0f} and "
        f"{n / python_s:,.0f} pairs/s)")
    return {"reader_native_s": native_s, "reader_python_s": python_s,
            "reader_pairs": n}


def _trace_busy(np, path, window="quant.read_loop"):
    """(kernel events, busy s of the card's kernels, busy s of kernels,
    copies and sets, top kernels by time) from a torch.profiler Chrome
    trace: the union of its events' [ts, ts + dur) intervals inside the
    range named `window`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == window
           and e.get("cat") == "user_annotation"]
    check(len(win) == 1, f"the trace holds one {window} range")
    lo = win[0]["ts"]
    hi = lo + win[0]["dur"]

    def union_s(cats):
        iv = sorted((max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi))
                    for e in events
                    if e.get("cat") in cats and e.get("ph") == "X"
                    and e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo)
        busy, end = 0.0, -np.inf
        for a, b in iv:
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6, len(iv)

    kern_s, n_kern = union_s(("kernel",))
    all_s, _ = union_s(("kernel", "gpu_memcpy", "gpu_memset"))
    by_name = Counter()
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"][:60]] += e.get("dur", 0) / 1e3
    return n_kern, kern_s, all_s, by_name.most_common(6)


def phase_5i(torch, np, Options, run_quant, index, r1p, r2p, work, dev,
             n_pairs):
    """`quant` of the first n_pairs of phase 2's pairs with
    KALLISTO_TPU_PROFILE (a torch.profiler trace of the whole run) and
    KALLISTO_TPU_TIMING (the [time] lines) set: the trace written, the
    card's busy time inside the read loop's span read from its CUDA
    kernel events beside the loop's wall, the [time] lines counted against the routes.  Returns the
    summary."""
    import io

    q1 = os.path.join(work, "prof_1.fastq.gz")
    q2 = os.path.join(work, "prof_2.fastq.gz")
    truncate_fastq(r1p, q1, n_pairs)
    truncate_fastq(r2p, q2, n_pairs)
    prof = os.path.join(work, "profile")
    os.environ["KALLISTO_TPU_PROFILE"] = prof
    os.environ["KALLISTO_TPU_TIMING"] = "1"
    err = io.StringIO()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            r = run_quant(Options(files=[q1, q2], plaintext=True),
                          index=index, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["KALLISTO_TPU_PROFILE"]
        del os.environ["KALLISTO_TPU_TIMING"]
    files = os.listdir(prof)
    check(files == [f"quant_{os.getpid()}.json"],
          f"5i: the profile directory holds the trace ({files})")
    n_kern, kern_s, busy_s, top = _trace_busy(
        np, os.path.join(prof, files[0]))
    loop_s = r.timings["pseudoalign_s"]
    check(n_kern > 0, f"5i: the trace holds {n_kern} CUDA kernel events")
    tags = Counter(re.findall(r"\[time\] (\S+) ", err.getvalue()))
    t = r.timings
    check(r.num_processed == n_pairs and t["full"] > 0
          and tags["full:hashes"] == tags["full:resolve"]
          == tags["full:overflow"] == t["full"],
          f"5i: {n_pairs} pairs, a [time] full: line of each tag per "
          f"per-read batch ({dict(tags)}, routes full {t['full']} turbo "
          f"{t['turbo']})")
    log(f"5i: quant wall {wall:.3f} s, read loop {loop_s:.3f} s; card busy "
        f"in the trace: kernels {kern_s:.4f} s ({n_kern} events), kernels "
        f"+ copies + sets {busy_s:.4f} s = {100 * busy_s / loop_s:.2f} % of "
        f"the loop (idle {100 * (1 - busy_s / loop_s):.2f} %); read_s "
        f"{t['read_s']:.3f}; top kernels (ms): {top}")
    return {"profile_quant_s": wall, "profile_loop_s": loop_s,
            "profile_kernel_busy_s": kern_s, "profile_busy_s": busy_s,
            "profile_kernel_events": n_kern,
            "profile_idle_share": 1 - busy_s / loop_s,
            "profile_phases_s": t, "profile_top_kernels_ms": top}


def ragged_batch(codes, lens_full, k, rng, fastx):
    """PackedBatch of `codes` with random Ns, 5% ragged lengths (some
    shorter than k), padding marked N as the reader does."""
    import numpy as np

    codes = codes.copy()
    B, L = codes.shape
    ns = rng.random((B, L)) < 0.002
    codes[ns] = 4
    lens = lens_full.astype(np.int32).copy()
    short = rng.random(B) < 0.05
    lens[short] = rng.integers(1, L + 1, int(short.sum()))
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    rb = fastx.ReadBatch(codes=codes, lens=lens)
    return fastx._read_batch_to_packed(rb, k)



def _sparse_n_batch(codes, lens, k, rng, fastx, n_frac):
    """PackedBatch of `codes` (rows shorter than lens padded with N) with
    a fraction n_frac of in-read bases set to N."""
    import numpy as np

    codes = codes.copy()
    L = codes.shape[1]
    codes[rng.random(codes.shape) < n_frac] = 4
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    return fastx._read_batch_to_packed(
        fastx.ReadBatch(codes=codes, lens=lens.astype(np.int32)), k)


def _equal_sides(torch, pa, a, b, what):
    for f in pa.SideResult._fields:
        x, y = getattr(a, f), getattr(b, f)
        check(x.dtype == y.dtype and torch.equal(x, y), f"{what}: {f} equal")


def _equal_tables(torch, a, b, what):
    """Key tables equal: meta rows, then occupied rows in first_idx order
    (both versions write them in that order, so the whole tables match)."""
    check(torch.equal(a, b), f"{what}: key table equal "
          f"(n_uniq {int(a[0, 0])})")


def _hold_e(torch, pa, kernels, s1, s2, spec, K, didx, tag,
            with_slots=False):
    """Kernel E (compact_keys: the compact key fused into the key table)
    against key_hash_plain + key_histogram_plain on the same card tensors:
    every read's h and flags, the table and, with slots, the slots equal.
    Returns (ck, slots, h, flags)."""
    ck, slots, h, fl = kernels.compact_keys(s1, s2, spec, K, with_slots,
                                            didx, want_keys=True)
    hp, flp = pa.key_hash_plain(s1, s2, spec, didx)
    want = pa.key_histogram_plain(hp, flp, K, with_slots)
    torch.cuda.synchronize()
    check(torch.equal(h, hp) and torch.equal(fl, flp),
          f"kernel E {tag}: every read's key and flags equal")
    _equal_tables(torch, ck, want[0] if with_slots else want,
                  f"kernel E {tag}")
    if with_slots:
        check(torch.equal(slots, want[1]),
              f"kernel E {tag}: {slots.numel()} per-read slots equal")
    return ck, slots, h, fl


def _key_in_bytes(s1, s2, spec):
    """The bytes of a read's compact key columns under spec, for all reads:
    per mate its rows, has and overflow bytes, rng with min_range, the
    first-hit block and strand with the tail, upos and rpos with the
    position rank."""
    per = 2 + (4 if spec.min_range > 1 else 0) + (
        5 if spec.strand_key or spec.pos_key else 0) + (
        8 if spec.pos_key else 0)
    return sum(s.rows.numel() * 4 + s.rows.shape[0] * per
               for s in (s1, s2) if s is not None)


def _put(torch, np, a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _sparse_pairs(np, fastx, rbs, n, k, rng, lens=None, n_frac=5e-4):
    """The first n reads of each mate batch in rbs, cut to lens (default
    READ_LEN each) with sparse Ns: the turbo route's input."""
    if lens is None:
        lens = np.full(n, READ_LEN, np.int32)
    return [_sparse_n_batch(rb.codes[:n], lens, k, rng, fastx, n_frac)
            for rb in rbs]


def _turbo_inputs(torch, np, bs, Bp, dev):
    """The turbo route's device inputs of the packed mates bs, padded to Bp
    rows as quant/pipeline.py builds them: (packed codes per mate, aux
    vector, per-read lengths or None when uniform, Lp, uniform length or
    0)."""
    from kallisto_tpu_torch.ops import turbo
    from kallisto_tpu_torch.quant.pipeline import (
        _pad_rows, _turbo_exceptions, _uniform_len)

    exc = _turbo_exceptions(bs, Bp)
    check(exc is not None, "the batch's N positions fit the aux vector")
    rl = _uniform_len(*bs)
    aux = turbo.make_aux(bs[0].n, rl or 0, exc)
    packed = [_put(torch, np, _pad_rows(b.packed, Bp), dev) for b in bs]
    lens = None
    if rl is None:
        lens = _put(torch, np, np.concatenate(
            [_pad_rows(b.lens.astype(np.uint16), Bp) for b in bs]), dev)
    return packed, _put(torch, np, aux, dev), lens, bs[0].Lp, rl or 0


def _launch_d(kernels, didx, inputs, k):
    """Kernel D on _turbo_inputs' tuple, R = min(16, W) as the route."""
    packed, aux, lens, L, rl = inputs
    R = min(16, (rl if 0 < rl < L else L) - k + 1)
    return kernels.pseudoalign_turbo(didx, packed, aux, lens, k, L, rl, R)


def _plain_d(pa, didx, inputs, k):
    """Kernel D's plain version: (SideResult, codes, lengths)."""
    from kallisto_tpu_torch.ops import turbo

    packed, aux, lens, L, rl = inputs
    codes, lens_v = turbo.codes_and_lens_plain(packed, aux, lens, L, rl)
    return pa._pseudoalign_core(didx, codes, lens_v, k, 16), codes, lens_v


def _hold_d(torch, pa, kernels, didx, inputs, k, tag):
    """Kernel D against its plain version, both on the card: every field
    equal.  Returns (kernel's SideResult, plain SideResult, codes,
    lengths)."""
    g = pa.SideResult(*_launch_d(kernels, didx, inputs, k))
    c, codes, lens_v = _plain_d(pa, didx, inputs, k)
    torch.cuda.synchronize()
    _equal_sides(torch, pa, g, c, f"kernel D {tag}")
    return g, c, codes, lens_v


def _launch_i(kernels, didx, sides, aux, k, L, rl):
    """Kernel I on one or two mates of uniform length rl, R = 16."""
    from kallisto_tpu_torch.ops import anchor

    return kernels.pseudoalign_anchor(didx, sides, aux, k, L, rl, 16,
                                      anchor.n_anchors_for(rl, k))


def _plain_i(didx, sides, aux, k, L, rl):
    """Kernel I's plain version: (SideResult, n_fail)."""
    from kallisto_tpu_torch.ops import anchor, turbo

    codes, _ = turbo.codes_and_lens_plain(sides, aux, None, L, rl)
    real = anchor._real_rows(aux, int(sides[0].shape[0]), len(sides))
    return anchor.anchor_side_plain(didx, codes, rl, real, k, 16,
                                    anchor.n_anchors_for(rl, k))


def _hold_i(torch, pa, kernels, didx, sides, aux, k, L, rl, tag):
    """Kernel I against its plain version, both on the card: every field
    and n_fail equal.  Returns (kernel's SideResult, plain SideResult,
    plain n_fail)."""
    gi, gf = _launch_i(kernels, didx, sides, aux, k, L, rl)
    g = pa.SideResult(*gi)
    c, cf = _plain_i(didx, sides, aux, k, L, rl)
    torch.cuda.synchronize()
    _equal_sides(torch, pa, g, c, f"kernel I {tag}")
    n = len(sides) * int(sides[0].shape[0])
    check(torch.equal(gf, cf), f"kernel I {tag}: n_fail equal "
          f"({int(cf)} of {n} reads in wave 2)")
    return g, c, cf


def _code_batch(np, codes, lens_full, k, rng):
    """Unpacked codes for kernel A on codes (pseudoalign_batch): random Ns
    (code 4) and codes above 4, 5% ragged lengths (some shorter than k),
    the columns past a read's length N as the reader marks them."""
    codes = codes.copy()
    B, L = codes.shape
    codes[rng.random((B, L)) < 0.002] = 4
    codes[rng.random((B, L)) < 0.0005] = 7
    lens = lens_full.astype(np.int32).copy()
    short = rng.random(B) < 0.05
    lens[short] = rng.integers(1, L + 1, int(short.sum()))
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    return np.ascontiguousarray(codes), lens


def _hold_codes(torch, pa, anchor, kernels, didx, codes, lens, k, tag):
    """Kernel A on codes against _pseudoalign_core and the plain two-wave
    model (anchor.codes_waves_plain), all on the card: every field equal,
    its wave-2 count the model's failing reads and the windows its wave 2
    probed (kernels.pseudoalign_codes' probes) the model's mask.  Returns
    the model's (fail, probed)."""
    g = pa.pseudoalign_batch(didx, codes, lens, k)
    c = pa._pseudoalign_core(didx, codes, lens, k, 16)
    w, fail, probed = anchor.codes_waves_plain(didx, codes, lens, k)
    n_pr = torch.zeros(1, dtype=torch.int64, device=codes.device)
    _, _, nf = kernels.pseudoalign_codes(didx, codes, lens, k,
                                         int(c.rows.shape[1]), probes=n_pr)
    torch.cuda.synchronize()
    _equal_sides(torch, pa, g, c, f"kernel A on codes {tag}")
    _equal_sides(torch, pa, w, c, f"plain two-wave model on codes {tag}")
    B = int(lens.shape[0])
    check(int(nf) == int(fail.sum()) and int(n_pr) == int(probed.sum()),
          f"kernel A on codes {tag}: {int(nf)} of {B} reads in wave 2, "
          f"{int(n_pr)} windows probed there, as the plain model has them")
    return fail, probed


def _anchor_mask(torch, lens, W, k):
    """[B, W]: each read's anchor windows as the covered-interval core
    places them (n_anchors_for(le, k) at w_j = (wlast * j) // (na - 1),
    le = min(len, W + k - 1), wlast = le - k; window 0 alone for a read
    shorter than k)."""
    le = lens.long().clamp(max=W + k - 1)
    wl = le - k
    na = torch.where(wl >= 0, ((wl + k - 1) // k + 1).clamp(min=2),
                     torch.ones_like(wl))
    j = torch.arange(int(na.max()) if na.numel() else 1,
                     device=lens.device)[None, :]
    w = (wl.clamp(min=0)[:, None] * j) // (na[:, None] - 1).clamp(min=1)
    m = torch.zeros((lens.shape[0], W), dtype=torch.bool, device=lens.device)
    return m.scatter_(1, torch.where(j < na[:, None], w, 0), True)


def _between_blocks(torch, didx, idx, hit, probed):
    """The blocks whose block_ec8 entries the covered intervals of reads
    read (idx, hit: every window's slot and hit; probed: the windows
    looked up): the blocks of the windows that hit without a probe (a
    covered interval's inner windows) other than the blocks of the probed
    windows nearest them on either side (the interval's anchors)."""
    B, W = hit.shape
    pos = torch.arange(W, device=hit.device)[None, :].expand(B, W)
    left = torch.where(probed, pos, -1).cummax(dim=1).values.clamp(min=0)
    right = torch.where(probed, pos, W).flip(1).cummin(dim=1).values.flip(1)
    blk = didx.kmer_block[idx]
    inner = hit & ~probed
    b = blk[inner]
    bl = blk.gather(1, left)[inner]
    br = blk.gather(1, right.clamp(max=W - 1))[inner]
    return b[(b != bl) & (b != br)]


def _skip_bytes(torch, pa, didx, codes, lens, k, probed, ver=None):
    """The design's table bytes on reads (codes [B, L], lens [B]) through
    the covered-interval core, which looked up the windows `probed` [B,
    W] (anchor.skip_core_plain's mask) -- or, for the reads `ver` that A's
    wave 1 verified, their anchors alone --, each sector once: those
    windows' probes, the payload of every anchor that hits and of each
    read's first hit, the block_ec8 entries of the blocks strictly between
    a covered interval's anchors' blocks, and a verified read's blocks'
    entries.  Returns (bytes, probes)."""
    canon, _, valid = pa.rolling_canonical_kmers(codes, lens, k)
    idx, hit, _ = pa.lookup_kmers(didx, canon, valid)
    anc = _anchor_mask(torch, lens, canon.shape[1], k)
    fail = torch.ones(lens.shape[0], dtype=torch.bool, device=lens.device)
    if ver is not None:
        probed = torch.where(ver[:, None], anc & valid, probed)
        fail = ~ver
    ids = _sector_ids(
        torch, pa, didx, canon[probed], valid[probed], idx[probed],
        hit[probed],
        payload=torch.cat([idx[anc & hit], _first_hits(torch, idx, hit)]))
    blocks = [_between_blocks(torch, didx, idx[fail], hit[fail],
                              probed[fail])]
    if ver is not None:
        blocks.append(didx.kmer_block[idx[ver][hit[ver]]])
    ids["block_ec8"] = torch.unique(torch.cat(blocks) >> 3)
    return 32 * _n_sectors(didx, ids), int(probed.sum())


def _dense_probes(torch, pa, codes, lens, k):
    """The windows the dense core probes on reads: the valid ones, and
    window 0 of each read."""
    _, _, valid = pa.rolling_canonical_kmers(codes, lens, k)
    return int(valid.sum() + (~valid[:, 0]).sum())


def phase_3_codes(torch, np, pa, anchor, kernels, didx, rb1, k, dev, rng):
    """pseudoalign_batch -- kernel A on unpacked codes, the entry point the
    JAX package's single-chip program calls -- on the main path's batch of
    mate-1 reads (width 100, not a multiple of 8): the path run with the
    launch counts set to 0 just before and read just after (both waves
    launched), then held against _pseudoalign_core and the plain two-wave
    model on the card (_hold_codes) and timed: both waves, each alone (wave
    2 on the reads wave 1 listed), and the device time of both from graph
    replays (L2-warm); its wave-2 share and the share of wave 2's windows
    that the covered-interval core skipped (the kernel's count against the
    dense core's probes); two bounds, the dense work (every window's probe,
    the formula of the earlier rows) and the design's (_skip_bytes).
    Returns its row fields."""
    cn, ln = _code_batch(np, rb1.codes, rb1.lens, k, rng)
    codes, lens = _put(torch, np, cn, dev), _put(torch, np, ln, dev)
    B, L = codes.shape
    check(L % 8 != 0, f"code width {L} is not a multiple of 8")
    torch.cuda.synchronize()
    kernels.reset_launches()
    pa.pseudoalign_batch(didx, codes, lens, k)
    torch.cuda.synchronize()
    n = kernels.LAUNCHES["pseudoalign_codes"]
    n2 = kernels.LAUNCHES["pseudoalign_codes_wave2"]
    check(n > 0 and n2 == n, f"pseudoalign_batch launched pseudoalign_codes "
          f"({n} times) and its wave 2 ({n2})")
    fail, probed = _hold_codes(torch, pa, anchor, kernels, didx, codes, lens,
                               k, f"B={B} L={L}")
    R = min(16, L - k + 1)
    ms = cuda_ms(lambda: kernels.pseudoalign_codes(didx, codes, lens, k, R),
                 10, torch)
    dev_ms = graph_ms(lambda: kernels.pseudoalign_codes(didx, codes, lens, k,
                                                        R), 10, torch)
    lists = kernels.pseudoalign_codes(didx, codes, lens, k, R, waves=1)
    ms1 = cuda_ms(lambda: kernels.pseudoalign_codes(didx, codes, lens, k, R,
                                                    waves=1), 10, torch)
    ms2 = cuda_ms(lambda: kernels.pseudoalign_codes(
        didx, codes, lens, k, R, waves=2, lists=lists), 10, torch)
    plain = cuda_ms(lambda: pa._pseudoalign_core(didx, codes, lens, k, 16), 3,
                    torch)
    # codes and lengths in, SideResults out, the table sectors its probes
    # and first-hit payloads read, each once: every window (the dense
    # work), or the design's probes
    table, n_win, n_valid, n_hit = _window_bytes(torch, pa, didx, codes, lens,
                                                 k)
    io = B * L + 4 * B + B * (4 * R + 27)
    dense = bound(io + table, 250 * n_win, PEAK_INT_OPS)
    tab_s, n_probe = _skip_bytes(torch, pa, didx, codes, lens, k, probed,
                                 ver=~fail)
    bnd = bound(io + tab_s + 4 * int(fail.sum()) + 8, 250 * n_probe,
                PEAK_INT_OPS)
    n_w2 = int(probed.sum())
    nf = int(fail.sum())
    share = nf / B
    # wave 2 alone: its reads' probes, list entries, codes and outputs
    sub = (codes[fail].contiguous(), lens[fail].contiguous())
    d_w2 = _dense_probes(torch, pa, *sub, k)
    plain2 = cuda_ms(lambda: pa._pseudoalign_core(didx, *sub, k, 16), 3,
                     torch)
    io2 = nf * (L + 4 + 4 + 4 * R + 27) + 8
    tab2, _ = _skip_bytes(torch, pa, didx, *sub, k, probed[fail])
    bnd2 = bound(io2 + tab2, 250 * n_w2, PEAK_INT_OPS)
    dense2 = bound(io2 + _window_bytes(torch, pa, didx, *sub, k)[0],
                   250 * int(sub[0].shape[0]) * (L - k + 1), PEAK_INT_OPS)
    del sub
    log(f"kernel A on codes: {ms:.3f} ms, device (L2-warm) {dev_ms:.3f} ms "
        f"(wave 1 alone {ms1:.3f} ms, wave 2 alone {ms2:.3f} ms on "
        f"{nf} reads, {share:.4f}, plain {plain2:.3f} ms, bound "
        f"{bnd2[0]:.4f} ms, dense-work bound {dense2[0]:.4f} ms; plain on card {plain:.3f} "
        f"ms, bound {bnd[0]:.4f} ms over {n_probe} probes, dense-work bound "
        f"{dense[0]:.4f} ms), B={B} L={L} windows={n_win} valid={n_valid} "
        f"hits={n_hit}; wave 2 probed {n_w2} of the dense core's {d_w2} "
        f"windows ({1 - n_w2 / max(d_w2, 1):.4f} skipped); its path "
        f"launched it {n} times")
    skipped = 1 - n_w2 / max(d_w2, 1)
    return (dict(launches=n, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                 bound_by=bnd[1], dense_bound_ms=dense[0], device_ms=dev_ms,
                 wave1_ms=ms1, wave2_ms=ms2, wave2_share=share,
                 wave2_probes=n_w2, wave2_dense_probes=d_w2,
                 skipped_share=skipped, reads=B, width=L),
            dict(launches=n2, ms=ms2, plain_ms=plain2, bound_ms=bnd2[0],
                 bound_by=bnd2[1], dense_bound_ms=dense2[0], reads=nf,
                 wave2_share=share, probes=n_w2, dense_probes=d_w2,
                 skipped_share=skipped))


def phase_3b(torch, np, pa, kernels, fastx, index, didx, rb1, rb2, k, dev):
    """Kernels D, E, F and B with the compact key layout against their
    plain PyTorch versions, both on the card, on main-path shapes.  Returns
    {name: (ms, plain_ms, (bound_ms, bound_by), library_ms)} and B's
    compact-layout time."""
    rng = np.random.default_rng(99)
    Bp = rb1.n  # the default batch: 262,144 pairs
    out = {}

    # -- D on the main path's paired batch: 2x100 bp, Bp = 262,144, Ns
    bs = _sparse_pairs(np, fastx, (rb1, rb2), Bp, k, rng)
    inputs = _turbo_inputs(torch, np, bs, Bp, dev)
    packed, aux, lens, L, rl = inputs
    check(0 < rl < L, f"uniform length {rl} trims the padded {L}")
    Lc = rl
    R = min(16, Lc - k + 1)
    g, c, codes, lens_v = _hold_d(torch, pa, kernels, didx, inputs, k,
                                  f"paired Bp={Bp}")
    # the table sectors its probes and first-hit payloads read, each once
    table_bytes, n_win, n_valid, n_hit = _window_bytes(torch, pa, didx, codes,
                                                       lens_v, k)
    n_has = int(c.has_hits.sum())
    del codes, lens_v
    ms_d = cuda_ms(lambda: _launch_d(kernels, didx, inputs, k), 10, torch)
    plain_ms_d = cuda_ms(lambda: _plain_d(pa, didx, inputs, k), 3, torch)
    in_bytes = sum(p.numel() for p in packed) + 8 * aux.numel()
    out_bytes = 2 * Bp * (4 * R + 4 * 6 + 3)
    out["pseudoalign_turbo"] = (ms_d, plain_ms_d, bound(
        in_bytes + out_bytes + table_bytes, 250 * n_win, PEAK_INT_OPS), None)
    log(f"kernel D: {ms_d:.3f} ms (plain on card {plain_ms_d:.3f} ms), "
        f"reads={2 * Bp} Lc={Lc} windows={n_win} valid={n_valid} "
        f"hits={n_hit} with hits={n_has} N exceptions={int((aux[4:] < 2**62).sum())}")

    # -- E (the compact key fused into the key table, options off as on
    # the main path) and F on it
    r1, r2 = pa.SideResult(*(a[:Bp] for a in g)), pa.SideResult(*(a[Bp:] for a in g))
    spec0 = pa.KeySpec(k=k)
    K = Bp + 1
    ck, _, h, fl = _hold_e(torch, pa, kernels, r1, r2, spec0, K, didx,
                           f"paired Bp={Bp}, options off")
    n_uniq = int(ck[0, 0])
    ms_e = cuda_ms(lambda: kernels.compact_keys(r1, r2, spec0, K), 20, torch)
    dev_e = graph_ms(lambda: kernels.compact_keys(r1, r2, spec0, K), 20,
                     torch)
    plain_ms_e = cuda_ms(lambda: pa.key_histogram_plain(
        *pa.key_hash_plain(r1, r2, spec0), K), 5, torch)
    h0 = h[:, 0].contiguous()
    lib_e = cuda_ms(lambda: torch.unique(h0, return_counts=True), 20, torch)
    # its bound: the compact key's inputs (both mates' rows, has and
    # overflow bytes) read once, the table written once
    bytes_e = _key_in_bytes(r1, r2, spec0) + 40 * (K + 1)
    out["key_histogram"] = (ms_e, plain_ms_e, bound(bytes_e, 0, PEAK_INT_OPS),
                            lib_e)
    # hot keys: the batch's own keys given as keys, then the same keys with
    # 60 % of the reads moved onto read 0's key (held, device times)
    sel = torch.from_numpy(rng.random(Bp) < 0.6).to(dev)
    hh, fh = h.clone(), fl.clone()
    hh[sel] = h[0].clone()
    fh[sel] = fl[0].clone()
    hot = kernels.compact_keys(None, None, None, K, keys=(hh, fh))[0]
    torch.cuda.synchronize()
    _equal_tables(torch, hot, pa.key_histogram_plain(hh, fh, K),
                  f"kernel E, 60 % of {Bp} reads on one key")
    dev_keys = graph_ms(lambda: kernels.compact_keys(
        None, None, None, K, keys=(h, fl)), 20, torch)
    dev_hot = graph_ms(lambda: kernels.compact_keys(
        None, None, None, K, keys=(hh, fh)), 20, torch)
    del hh, fh, hot
    log(f"kernel E: {ms_e:.4f} ms, device (L2-warm) {dev_e:.4f} ms (plain on card "
        f"{plain_ms_e:.3f} ms, torch.unique {lib_e:.4f} ms), B={Bp} "
        f"n_uniq={n_uniq} K={K}; keys given: device (L2-warm) {dev_keys:.4f} ms, with "
        f"60 % of the reads on one key {dev_hot:.4f} ms")
    idx = ck[1 : n_uniq + 1, 3].contiguous()
    ex = pa.gather_exemplars(idx, r1, r2, spec0)
    exp = pa.gather_exemplars_plain(idx, r1, r2, spec0)
    torch.cuda.synchronize()
    check(torch.equal(ex, exp), f"kernel F: {n_uniq} exemplar rows equal")
    ms_f = cuda_ms(lambda: kernels.gather_exemplars(idx, r1, r2, spec0), 20,
                   torch)
    plain_ms_f = cuda_ms(lambda: pa.gather_exemplars_plain(idx, r1, r2, spec0),
                         5, torch)
    bytes_f = 8 * n_uniq + 2 * 4 * ex.numel()
    out["gather_exemplars"] = (ms_f, plain_ms_f,
                               bound(bytes_f, 0, PEAK_INT_OPS), None)
    log(f"kernel F: {ms_f:.4f} ms (plain on card {plain_ms_f:.4f} ms), "
        f"{n_uniq} rows x {ex.shape[1]}")

    # -- every key option on: min_range 50, strand tail, position rank
    depth = pa.pf_probe_depth(index)
    spec = pa.KeySpec(k=k, min_range=50, strand_key=True, pos_fl=180,
                      pos_depth=depth)
    for tag, a, b in (("paired", r1, r2), ("single", r1, None)):
        _hold_e(torch, pa, kernels, a, b, spec, K, didx,
                f"{tag}, min_range 50 + strand + position")
        exo = pa.gather_exemplars(idx, a, b, spec)
        check(torch.equal(exo, pa.gather_exemplars_plain(idx, a, b, spec)),
              f"kernel F {tag}, every option: exemplar rows equal")
    ms_ex = cuda_ms(lambda: kernels.compact_keys(r1, r2, spec, K, didx=didx),
                    20, torch)
    dev_ex = graph_ms(lambda: kernels.compact_keys(r1, r2, spec, K,
                                                   didx=didx), 20, torch)
    log(f"kernel E: {ms_e:.4f} ms options off, {ms_ex:.4f} ms (device, L2-warm, "
        f"{dev_ex:.4f} ms) with min_range + strand + position rank (paired, "
        f"B={Bp})")
    out["compact_keys"] = {"options_off_ms": ms_e, "all_options_ms": ms_ex,
                           "all_options_device_ms": dev_ex}
    out["device"] = {"key_histogram": {
        "device_ms": dev_e, "keys_given_device_ms": dev_keys,
        "hot_key_device_ms": dev_hot, "hot_key_share": 0.6}}
    del g, c, r1, r2, h, fl, ck, packed, aux, inputs

    # -- ragged lengths (varlen), single-end, and the bitmask (N-dense)
    # route, each on 65,536 reads (the bitmask route's slices hold up to
    # 131,072)
    n = min(65536, Bp)
    lens_r = rb1.lens[:n].copy()
    short = rng.random(n) < 0.2
    lens_r[short] = rng.integers(k, 101, int(short.sum()))
    vb = _sparse_pairs(np, fastx, (rb1, rb2), n, k, rng, lens_r)
    for tag, bsx in (("varlen paired", vb), ("single", vb[:1])):
        gx = _hold_d(torch, pa, kernels, didx,
                     _turbo_inputs(torch, np, bsx, n, dev), k, tag)[0]
        ra, rb_ = (pa.SideResult(*(a[:n] for a in gx)),
                   pa.SideResult(*(a[n:] for a in gx)) if len(bsx) == 2 else None)
        _hold_e(torch, pa, kernels, ra, rb_, spec, n + 1, didx, tag)
    nb = _sparse_pairs(np, fastx, (rb1, rb2), n, k, rng, lens_r, 2e-3)
    args = [t for b in nb for t in pa.upload_batch(b, dev)]
    kw = dict(k=k, L=nb[0].Lp, max_keys=n + 1, min_range=50, strand_key=True,
              pos_fl=180, pos_depth=depth)
    gr1, gr2, gck = pa.pseudoalign_pair_compact_packed(didx, *args, **kw)
    pr1 = pa.pseudoalign_batch_packed_plain(didx, *args[:3], k, nb[0].Lp)
    pr2 = pa.pseudoalign_batch_packed_plain(didx, *args[3:], k, nb[0].Lp)
    hp, flp = pa.key_hash_plain(pr1, pr2, spec, didx)
    pck = pa.key_histogram_plain(hp, flp, n + 1)
    torch.cuda.synchronize()
    _equal_sides(torch, pa, gr1, pr1, "bitmask route mate 1")
    _equal_sides(torch, pa, gr2, pr2, "bitmask route mate 2")
    _equal_tables(torch, gck, pck, "bitmask route")
    return out


def _time_waves(torch, pa, kernels, didx, sides, aux, codes, k, L, rl, na):
    """Kernel I's two launches timed alone on one batch (codes: its decoded
    reads): wave 1, and wave 2 on the reads wave 1 listed, with wave 2's
    plain version (_pseudoalign_core on those reads) and bound (their
    window probes and first-hit payloads, each table sector once, their
    packed rows, the list and the outputs).  Returns wave 2's row fields
    and wave 1's ms."""
    R = 16
    o, fl, nf = kernels.anchor_wave1(didx, sides, aux, k, L, rl, R, na)
    ms1 = cuda_ms(lambda: kernels.anchor_wave1(didx, sides, aux, k, L, rl, R,
                                               na), 10, torch)
    ms2 = cuda_ms(lambda: kernels.anchor_wave2(didx, sides, aux, k, L, rl, R,
                                               o, fl, nf), 10, torch)
    n = int(nf)
    sel = torch.sort(fl[:n].long()).values
    lens = torch.full((n,), rl, dtype=torch.int32, device=codes.device)
    sub = codes[sel].contiguous()
    plain = cuda_ms(lambda: pa._pseudoalign_core(didx, sub, lens, k, R), 3,
                    torch)
    table, n_win, _, _ = _window_bytes(torch, pa, didx, sub, lens, k)
    io = n * (int(sides[0].shape[1]) + 4 + 4 * R + 27) + 8 * aux.numel()
    bnd = bound(table + io, 250 * n_win, PEAK_INT_OPS)
    log(f"kernel I's waves alone: wave 1 {ms1:.3f} ms, wave 2 {ms2:.3f} ms "
        f"on {n} listed reads (plain on card {plain:.3f} ms, bound "
        f"{bnd[0]:.4f} ms)")
    return dict(ms=ms2, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                reads=n, wave1_ms=ms1)


def phase_3d(torch, np, pa, kernels, fastx, didx, rb1, rb2, k, dev):
    """Kernel I against its plain version and kernel D, both on the card,
    at the main path's shapes.  Returns, for the paired and the single-end
    form, the kernel row's fields (ms, plain_ms, (bound_ms, bound_by)) and
    the wave-2 share, and kernel B's single-end ms on I's reads."""
    from kallisto_tpu_torch.ops import anchor, turbo

    rng = np.random.default_rng(77)
    Bp = rb1.n  # the default batch: 262,144 pairs
    bs = _sparse_pairs(np, fastx, (rb1, rb2), Bp, k, rng)
    packed, aux, _, L, rl = _turbo_inputs(torch, np, bs, Bp, dev)
    na, R, K = anchor.n_anchors_for(rl, k), 16, Bp + 1
    spec0 = pa.KeySpec(k=k)

    out = {}
    for tag, sides in (("paired", packed), ("single", packed[:1])):
        B2 = len(sides) * Bp
        g, c, cf = _hold_i(torch, pa, kernels, didx, sides, aux, k, L, rl,
                           f"{tag} Bp={Bp}")
        # I + E against the plain versions, n_fail in the meta row
        split = (lambda r: (pa.SideResult(*(a[:Bp] for a in r)),
                            pa.SideResult(*(a[Bp:] for a in r)))) \
            if len(sides) == 2 else (lambda r: (r, None))
        c1, c2 = split(c)
        hp, flp = pa.key_hash_plain(c1, c2, spec0, didx)
        pck = pa.key_histogram_plain(hp, flp, K)
        pck[0, 1] = cf[0]
        kw = dict(k=k, L=L, rl=rl, n_anchors=na, max_keys=K)
        if len(sides) == 2:
            ack = anchor.pseudoalign_pair_anchor(didx, *sides, aux, **kw)[2]
        else:
            ack = anchor.pseudoalign_single_anchor(didx, sides[0], aux, **kw)[1]
        torch.cuda.synchronize()
        _equal_tables(torch, ack, pck, f"kernels I + E {tag}")
        # against kernel D on the same batch
        d = turbo.turbo_sides(didx, sides, aux, None, k, L, R, rl)
        torch.cuda.synchronize()
        for f in ("rows", "n_rows", "has_hits", "overflow"):
            check(torch.equal(getattr(g, f), getattr(d, f)),
                  f"kernel I {tag}: {f} equal to kernel D's")
        d1, d2 = split(d)
        dck = _hold_e(torch, pa, kernels, d1, d2, spec0, K, didx,
                      f"on kernel D's {tag} sides")[0]
        a1, a2 = split(g)
        check(torch.equal(kernels.compact_keys(a1, a2, spec0, K)[0], dck),
              f"kernel I {tag}: key table equal to kernel D's "
              f"(n_uniq {int(dck[0, 0])})")

        # time and bound
        ms = cuda_ms(lambda: _launch_i(kernels, didx, sides, aux, k, L, rl),
                     10, torch)
        plain_ms = cuda_ms(lambda: _plain_i(didx, sides, aux, k, L, rl), 3,
                           torch)
        codes, _ = turbo.codes_and_lens_plain(sides, aux, None, L, rl)
        real = anchor._real_rows(aux, Bp, len(sides))
        table, n_win2, n_ok, n_fail = _anchor_bytes(
            torch, pa, anchor, didx, codes, real, rl, k, na)
        io = (sum(p.numel() for p in sides) + 8 * aux.numel()
              + B2 * (4 * R + 4 * 6 + 3) + 8)
        bnd = bound(table + io, 250 * (B2 * na + n_win2), PEAK_INT_OPS)
        log(f"kernel I {tag}: {ms:.3f} ms (plain on card {plain_ms:.3f} ms), "
            f"reads={B2} Lc={rl} anchors={na} verified={n_ok} wave 2="
            f"{n_fail} ({n_fail / B2:.4f}); bound {bnd[0]:.4f} ms ({bnd[1]})")
        out[tag] = ((ms, plain_ms, bnd), n_fail / B2)
        if tag == "paired":
            out["wave2"] = _time_waves(torch, pa, kernels, didx, sides, aux,
                                       codes, k, L, rl, na)
        del codes
        if tag == "single":
            # kernel B single-end on I's reads: bus's per-chunk key launch
            ms_b1 = cuda_ms(lambda: kernels.read_keys(g, None, k), 20, torch)
            log(f"kernel B single-end on {Bp} reads: {ms_b1:.4f} ms")
    return out, ms_b1


# golden dir, index, options (a file name for batch files), compared files
BUS_GOLDENS = (
    ("bus10xv2", "tx", dict(files=["sc_reads_1.fastq.gz",
                                   "sc_reads_2.fastq.gz"],
                            technology="10xv2", batch_size=20000),
     ("output.bus", "matrix.ec", "transcripts.txt")),
    ("bus_batch_bulk", "tx", dict(batch=(
        ("sampleA", "bulkb0_1.fastq.gz", "bulkb0_2.fastq.gz"),
        ("sampleB", "bulkb1_1.fastq.gz", "bulkb1_2.fastq.gz")),
        batch_size=700),
     ("output.bus", "matrix.ec", "matrix.cells", "matrix.sample.barcodes",
      "flens.txt")),
    ("bus_batch_10x", "tx", dict(batch=(
        ("cellA", "sc_b0_1.fastq.gz", "sc_b0_2.fastq.gz"),
        ("cellB", "sc_b1_1.fastq.gz", "sc_b1_2.fastq.gz")),
        technology="10xv2"), ("output.bus", "matrix.ec", "matrix.cells")),
    ("bus_inleaved", "tx", dict(files=["interleaved_10x.fastq.gz"],
                                technology="10xv2", inleaved=True,
                                batch_size=500), ("output.bus", "matrix.ec")),
    ("bus_rx", "tx", dict(files=["rx_R1.fastq.gz", "rx_R2.fastq.gz"],
                          technology="0,0,16:RX:1,0,0"),
     ("output.bus", "matrix.ec")),
    ("bus_smartseq3", "tx", dict(
        files=["ss3_I1.fastq.gz", "ss3_I2.fastq.gz", "ss3_R1.fastq.gz",
               "ss3_R2.fastq.gz"], technology="SMARTSEQ3", batch_size=1024),
     ("output.bus", "matrix.ec", "transcripts.txt", "flens.txt")),
    ("bus_dfk", "tx_dlist", dict(files=["dfk_reads.fastq.gz"],
                                 technology="bulk", single_end=True,
                                 dfk_onlist=True),
     ("output.bus", "matrix.ec")),
    ("bus_aa_f0", "aa", dict(files=["virus_nn_frame0.fastq.gz"],
                             technology="bulk", aa=True),
     ("output.bus", "matrix.ec", "matrix.cells", "matrix.sample.barcodes")),
    ("bus_distinguish", "colors", dict(
        files=["distinguish_reads.fastq.gz"], technology="bulk",
        bus_num=True, single_end=True, k=7),
     ("output.bus", "matrix.ec", "transcripts.txt")),
)


@contextlib.contextmanager
def _padded_runs(pa, what):
    """The runs inside place their indexes on the padded layout: every
    replica that MeshRunner.replicate returns (the one place where quant
    and bus put an index on a device) is recorded, and after the block
    each must be a PaddedDeviceIndex."""
    from kallisto_tpu_torch.parallel.mesh import MeshRunner

    placed = []
    replicate = MeshRunner.replicate

    def spy(self, *a, **kw):
        didxs = replicate(self, *a, **kw)
        placed.extend(didxs)
        return didxs

    MeshRunner.replicate = spy
    try:
        yield
    finally:
        MeshRunner.replicate = replicate
    check(placed and all(isinstance(d, pa.PaddedDeviceIndex)
                         for d in placed),
          f"{what}: the {len(placed)} device indexes its runs placed are "
          f"padded (p, S: {sorted({(d.p, getattr(d, 'S', 0)) for d in placed})})")


def phase_4c(Options, build_index, run_bus, tidx, data, golden, work, dev):
    """The bus goldens on the card (every index in the padded layout, which
    the caller asserts with _padded_runs).  Returns the chunks by route."""
    def d(*names):
        return [os.path.join(data, n) for n in names]

    indexes = {
        "tx": lambda: tidx,
        "tx_dlist": lambda: build_index(d("transcripts.fasta.gz"), k=31,
                                        dlist_paths=d("dlist.fasta")),
        "aa": lambda: build_index(d("aa_ref.fasta"), k=7, aa=True),
        "colors": lambda: build_index(
            d("distinguish_colors.fasta"), k=7,
            dlist_paths=d("distinguish_polyA.fasta"), distinguish=True),
    }
    routes = dict.fromkeys(BUS_ROUTES, 0)
    for name, iname, kw, files in BUS_GOLDENS:
        kw = dict(kw)
        out = os.path.join(work, name)
        if "files" in kw:
            kw["files"] = d(*kw["files"])
        if "batch" in kw:
            bf = os.path.join(work, f"{name}.batch.txt")
            with open(bf, "w") as f:
                for row in kw.pop("batch"):
                    f.write(" ".join([row[0]] + d(*row[1:])) + "\n")
            kw["batch_file"] = bf
        res = run_bus(Options(output_dir=out, **kw), index=indexes[iname](),
                      device=dev)
        same = [fn for fn in files
                if read_bytes(os.path.join(out, fn))
                == read_bytes(os.path.join(golden, name, fn))]
        check(len(same) == len(files),
              f"bus {name}: {', '.join(files)} byte-equal to tests/golden")
        gi = os.path.join(golden, name, "run_info.json")
        if os.path.exists(gi):
            mine = json.loads(read_file(os.path.join(out, "run_info.json")))
            want = json.loads(read_file(gi))
            keys = ("n_targets", "n_processed", "n_pseudoaligned", "n_unique")
            check(all(mine[x] == want[x] for x in keys),
                  f"bus {name}: run stats equal to tests/golden "
                  f"({', '.join(str(want[x]) for x in keys)})")
        for r in routes:
            routes[r] += res.timings[r]
    log(f"bus goldens: chunks by route {routes}")
    return routes


def phase_5c(torch, np, kernels, Options, run_bus, index, cdna, n_reads,
             work, dev):
    """`bus -x 10xv2` of n_reads at realistic size, then the same input
    with the anchor route bypassed.  Returns (launches, summary)."""
    from kallisto_tpu_torch.sc import bus as busmod
    from kallisto_tpu_torch.utils.benchdata import generate_10x_r1

    r1 = os.path.join(work, "bus_r1.fastq.gz")
    t0 = time.perf_counter()
    generate_10x_r1(r1, n_reads)
    log(f"read 1: {n_reads} barcodes + UMIs, "
        f"{time.perf_counter() - t0:.1f} s")

    def run(tag):
        out = os.path.join(work, f"bus_{tag}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = run_bus(Options(files=[r1, cdna], technology="10xv2",
                              output_dir=out), index=index, device=dev)
        torch.cuda.synchronize()
        return res, out, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    res, out, wall, launches = run("anchor")
    log(f"launches on the bus path: {launches}")
    check(launches["pseudoalign_anchor"] > 0,
          f"bus launched pseudoalign_anchor "
          f"({launches['pseudoalign_anchor']} times)")
    t = res.timings
    routes = {r: t[r] for r in BUS_ROUTES}
    check(res.num_processed == n_reads and t["anchor"] > 0,
          f"bus: {res.num_processed} reads, chunks by route {routes}")
    share = res.num_pseudoaligned / res.num_processed
    check(share > 0.5, f"bus: aligned share {share:.4f} > 0.5")
    log(f"bus wall {wall:.2f} s = {n_reads / wall:,.0f} reads/s, "
        f"{len(res.ec_sets)} ECs; host seconds by phase: " + json.dumps(t))
    saved = (busmod._BusRun._anchor_pair, busmod._BusRun._anchor_single)
    busmod._BusRun._anchor_pair = lambda self, *a: None
    busmod._BusRun._anchor_single = lambda self, *a: None
    try:
        rres, rout, rwall, rlaunches = run("per_read")
    finally:
        busmod._BusRun._anchor_pair, busmod._BusRun._anchor_single = saved
    check(rlaunches["pseudoalign_anchor"] == 0
          and rlaunches["pseudoalign_anchor_wave2"] == 0
          and rres.timings["full"] > 0,
          "bus with the anchor route bypassed: kernel A only "
          f"({rlaunches['pseudoalign_side']} launches)")
    for fn in ("output.bus", "matrix.ec"):
        check(read_bytes(os.path.join(out, fn))
              == read_bytes(os.path.join(rout, fn)),
              f"bus: {fn} byte-equal, anchor route vs per read")
    stats = (res.num_processed, res.num_pseudoaligned, res.num_unique,
             res.bclen, res.umilen)
    check(stats == (rres.num_processed, rres.num_pseudoaligned,
                    rres.num_unique, rres.bclen, rres.umilen),
          f"bus: run stats equal, anchor route vs per read {stats}")
    log(f"bus per read: {rwall:.2f} s = {n_reads / rwall:,.0f} reads/s; "
        "host seconds by phase: " + json.dumps(rres.timings))
    summary = {"bus_s": wall, "bus_reads_per_s": n_reads / wall,
               "bus_routes": routes, "bus_phases_s": t,
               "bus_per_read_s": rwall,
               "bus_per_read_reads_per_s": n_reads / rwall,
               "bus_per_read_phases_s": rres.timings,
               "bus_stats": stats}
    return launches, summary, out


def _long_plain(torch, pa, didx, args, k, L, step):
    """Kernel J's plain version in slices of `step` reads (each read's
    result depends on its own row and the batch width L only)."""
    B = int(args[2].shape[0])
    parts = [pa.pseudoalign_long_plain(didx, *(a[lo:lo + step] for a in args),
                                       k, L) for lo in range(0, B, step)]
    return pa.LongResult(*(torch.cat([getattr(p, f) for p in parts])
                           for f in pa.LongResult._fields))


def _long_bytes(torch, pa, didx, args, k, L, step):
    """Kernel J's table bytes on a batch, each sector once: its probes of
    the valid windows, their EC sectors and the kmer_uid sector of every
    hit (_sector_ids over the batch, in slices of `step` reads).  Returns
    (bytes, valid windows, hits)."""
    ids, n_valid, n_hit = None, 0, 0
    B = int(args[2].shape[0])
    for lo in range(0, B, step):
        packed, nmask, lens = (a[lo:lo + step] for a in args)
        codes = pa.unpack_codes(packed, nmask, L)
        canon, _, valid = pa.rolling_canonical_kmers(codes, lens, k)
        del codes
        idx, hit, _ = pa.lookup_kmers(didx, canon, valid)
        part = _sector_ids(torch, pa, didx, canon[valid], valid[valid],
                           idx[valid], hit[valid], uids=True)
        ids = part if ids is None else _merge_sectors(torch, ids, part)
        n_valid, n_hit = n_valid + int(valid.sum()), n_hit + int(hit.sum())
    return 32 * _n_sectors(didx, ids), n_valid, n_hit


def _long_batch(fastx, fasta, path, B, k):
    """B long reads from fasta's transcripts as one packed batch, a stress
    mix: Ns, reads shorter than k, random reads, chimeras and mosaics past
    kernel J's R rows and G groups."""
    from kallisto_tpu_torch.utils.benchdata import generate_long_reads

    generate_long_reads(fasta, path, B, seed=31, novel_frac=0.02,
                        chimera_frac=0.04, mosaic_frac=0.005,
                        short_frac=0.01, n_rate=0.001)
    return next(fastx.packed_single_batches(path, B, k))


def _hold_j(torch, np, pa, kernels, didx, pb, k, dev, tag):
    """Kernel J against its plain version, both on the card, on one packed
    batch of long reads: all eight fields equal.  Returns (ms, plain_ms,
    (bound_ms, bound_by), the plain result, the uploaded batch)."""
    args = pa.upload_batch(pb, dev)
    B, L = pb.n, pb.Lp
    R, G = min(64, L - k + 1), 128
    g = pa.LongResult(*kernels.pseudoalign_long(didx, *args, k, L, R, G))
    step = max(1, (1 << 25) // L)  # ~32M windows per plain slice
    c = _long_plain(torch, pa, didx, args, k, L, step)
    torch.cuda.synchronize()
    for f in pa.LongResult._fields:
        x, y = getattr(g, f), getattr(c, f)
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"kernel J {tag} B={B} Lp={L}: {f} equal")
    ms = cuda_ms(lambda: kernels.pseudoalign_long(didx, *args, k, L, R, G),
                 5, torch)
    plain_ms = cuda_ms(lambda: _long_plain(torch, pa, didx, args, k, L, step),
                       1, torch)
    # the table sectors of its probes and hits, each once (_long_bytes);
    # codes, N mask and lengths read; R + G + 6 int32 written per read;
    # ~250 integer operations per window of a read
    table, n_valid, n_hit = _long_bytes(torch, pa, didx, args, k, L, step)
    n_win = int(np.maximum(pb.lens.astype(np.int64) - k + 1, 0).sum())
    nbytes = (table + pb.packed.nbytes + pb.nmask.nbytes + 4 * B
              + 4 * B * (R + G + 6))
    bnd = bound(nbytes, 250 * n_win, PEAK_INT_OPS)
    log(f"kernel J {tag}: {ms:.3f} ms (plain on card {plain_ms:.3f} ms), "
        f"reads={B} Lp={L} windows={n_win} valid={n_valid} hits={n_hit} "
        f"table sectors={table // 32}; bound {bnd[0]:.4f} ms ({bnd[1]})")
    return ms, plain_ms, bnd, c, args


def phase_3e(torch, np, pa, kernels, fastx, fasta, didx, k, work, dev,
             B=16384):
    """Kernel J against its plain version, both on the card, on a B-read
    stress batch of long reads (_long_batch).  Returns (ms, plain_ms,
    (bound_ms, bound_by)) at this batch's shape."""
    t0 = time.perf_counter()
    pb = _long_batch(fastx, fasta, os.path.join(work, "lr_3e.fastq.gz"), B, k)
    log(f"long reads: {pb.n}, padded to {pb.Lp}, lengths {int(pb.lens.min())}"
        f"-{int(pb.lens.max())} (mean {float(pb.lens.mean()):.0f}), "
        f"{time.perf_counter() - t0:.1f} s")
    ms, plain_ms, bnd, c, _ = _hold_j(torch, np, pa, kernels, didx, pb, k,
                                      dev, "stress")
    R = int(c.rows.shape[1])
    n_short = int((pb.lens < k).sum())
    check(bool(c.overflow.any()) and bool(c.g_overflow.any())
          and n_short > 0,
          f"kernel J: {int(c.overflow.sum())} reads past R={R} rows, "
          f"{int(c.g_overflow.sum())} past G=128 groups, {n_short} shorter "
          "than k")
    return ms, plain_ms, bnd


def _bus_records(np, path):
    """output.bus records as a structured array."""
    b = read_bytes(path)
    n = int.from_bytes(b[16:20], "little")
    return np.frombuffer(b[20 + n:], np.dtype(
        [("bc", "<u8"), ("umi", "<u8"), ("ec", "<i4"), ("count", "<u4"),
         ("flags", "<u4"), ("pad", "<u4")]))


# golden dir -> (options, compared files, with the index): the cases of
# tests/test_tcc.py
def _tcc_goldens(data):
    ec, mtx = os.path.join(data, "tcc_test.ec"), os.path.join(data,
                                                              "tcc_test.mtx")
    d = lambda n: os.path.join(data, n)  # noqa: E731
    l180 = dict(fld_mean=180, fld_sd=20)
    ab = ["matrix.abundance.mtx", "matrix.abundance.tpm.mtx"]
    return ec, {
        "tcc": (dict(tcc_file=mtx, genemap=d("t2g.txt"), **l180),
                ab + ["matrix.efflens.mtx", "matrix.fld.tsv",
                      "matrix.abundance.gene.mtx",
                      "matrix.abundance.gene.tpm.mtx", "genes.txt",
                      "transcripts.txt", "transcript_lengths.txt"], True),
        "tcc_priors": (dict(tcc_file=mtx, priors=d("priors.txt")), ab, True),
        "tcc_txnames": (dict(tcc_file=mtx, txnames_file=d("txnames.txt")),
                        ab, False),
        "tcc_gtf": (dict(tcc_file=mtx, gtf_file=d("transcripts.gtf.gz")),
                    ["genes.txt", "matrix.abundance.gene.mtx",
                     "matrix.abundance.gene.tpm.mtx"], True),
        "tcc_long": (dict(tcc_file=mtx, long_read=True, **l180),
                     ab + ["matrix.efflens.mtx", "matrix.fld.tsv"], True),
        "tcc_flat": (dict(tcc_file=d("tcc_flat.txt"), genemap=d("t2g.txt"),
                          bootstrap=2),
                     ["abundance.tsv", "abundance.gene.tsv"], True),
        "tcc_m2f": (dict(tcc_file=mtx, bootstrap=2, plaintext=True,
                         matrix_to_files=True, **l180),
                    ["abundance_1.tsv", "abundance_2.tsv"], True),
    }


def phase_4d(np, kernels, Options, run_quant, run_bus, run_quant_tcc, tidx,
             data, golden, work, dev):
    """The long-read and TCC goldens on the card, long reads also on the
    CPU (byte-equal)."""
    lr = os.path.join(data, "reads_lr.fastq.gz")
    outs = {}
    for where in (dev, "cpu"):
        out = os.path.join(work, f"qlong_{where}")
        kernels.reset_launches()
        res = run_quant(Options(files=[lr], single_end=True, long_read=True,
                                platform="PacBio", plaintext=True,
                                output_dir=out), index=tidx, device=where)
        outs[str(where)] = (res, out, dict(kernels.LAUNCHES))
    res, out, launches = outs[str(dev)]
    check(launches["pseudoalign_long"] == res.timings["long"] > 0
          and launches["em_step_batch"] > 0,
          f"quant --long on the card: kernel J launched "
          f"{launches['pseudoalign_long']} times, G "
          f"{launches['em_step_batch']}")
    check(abs(res.num_pseudoaligned - 399) <= 1,
          f"quant_long: {res.num_pseudoaligned} pseudoaligned, within 1 of "
          "the reference's 399")
    want = {}
    with open(os.path.join(golden, "quant_long", "abundance.tsv")) as f:
        next(f)
        for line in f:
            p = line.split("\t")
            want[p[0]] = float(p[3])
    dev_sum = sum(abs(est - want[n])
                  for n, est in zip(res.target_names, res.est_counts))
    check(dev_sum <= 2.0 + 1e-6,
          f"quant_long: est_counts deviate {dev_sum:.4f} <= 2 in total from "
          "the reference's")
    heads = [x for x in read_file(os.path.join(out, "novel.fastq"))
             .splitlines() if x.startswith("@")]
    check(40 <= len(heads) <= 42, f"quant_long: {len(heads)} novel.fastq "
          "headers (40-42)")
    for fn in ("abundance.tsv", "novel.fastq"):
        check(read_bytes(os.path.join(out, fn))
              == read_bytes(os.path.join(outs["cpu"][1], fn)),
              f"quant_long: {fn} byte-equal, card vs CPU")

    bouts = {}
    for where in (dev, "cpu"):
        out = os.path.join(work, f"blong_{where}")
        kernels.reset_launches()
        run_bus(Options(files=[lr], technology="bulk", long_read=True,
                        threshold=0.8, output_dir=out), index=tidx,
                device=where)
        bouts[str(where)] = (out, dict(kernels.LAUNCHES))
    out, launches = bouts[str(dev)]
    check(launches["pseudoalign_long"] > 0,
          f"bus_long on the card: kernel J launched "
          f"{launches['pseudoalign_long']} times")
    for fn in ("matrix.ec", "flens.txt"):
        check(read_bytes(os.path.join(out, fn))
              == read_bytes(os.path.join(golden, "bus_long", fn)),
              f"bus_long: {fn} byte-equal to tests/golden")
    mine = Counter(map(tuple, _bus_records(np, os.path.join(
        out, "output.bus")).tolist()))
    ref = Counter(map(tuple, _bus_records(np, os.path.join(
        golden, "bus_long", "output.bus")).tolist()))
    missing = sum((ref - mine).values())
    check(not (mine - ref) and missing <= max(1, sum(ref.values()) // 200),
          f"bus_long: output.bus a sub-multiset of the reference's "
          f"({missing} of {sum(ref.values())} records missing)")
    for fn in ("output.bus", "novel.fastq"):
        check(read_bytes(os.path.join(out, fn))
              == read_bytes(os.path.join(bouts["cpu"][0], fn)),
              f"bus_long: {fn} byte-equal, card vs CPU")

    ec, cases = _tcc_goldens(data)
    for name, (kw, files, with_index) in cases.items():
        out = os.path.join(work, name)
        kernels.reset_launches()
        run_quant_tcc(Options(ec_file=ec, output_dir=out, **kw),
                      index=tidx if with_index else None, device=dev)
        same = [fn for fn in files if read_bytes(os.path.join(out, fn))
                == read_bytes(os.path.join(golden, name, fn))]
        check(len(same) == len(files) and kernels.LAUNCHES["em_step_batch"],
              f"{name} on the card (kernel G launched "
              f"{kernels.LAUNCHES['em_step_batch']} times): "
              f"{', '.join(files)} byte-equal to tests/golden")


def phase_5d(torch, np, pa, kernels, fastx, Options, run_quant, run_bus,
             fasta, index, didx, k, work, dev):
    """quant --long and bus --long at realistic size on the card; the first
    4,096 reads also on the CPU; kernel J held against its plain version
    and timed on quant's first batch.  Returns (launches, J's row fields at
    that batch's shape, summary)."""
    from kallisto_tpu_torch.sc import bus as busmod
    from kallisto_tpu_torch.utils.benchdata import generate_long_reads

    n_long = N_LONG
    lr = os.path.join(work, "lr_5d.fastq.gz")
    t0 = time.perf_counter()
    novel_idx = generate_long_reads(fasta, lr, n_long, seed=51,
                                    novel_frac=0.05)
    gen_s = time.perf_counter() - t0
    with gzip.open(lr, "rt") as f:
        lines = f.read().split("\n")
    bases = sum(len(lines[4 * i + 1]) for i in range(n_long))
    want_novel = {lines[4 * i + 1] for i in novel_idx.tolist()}
    del lines
    log(f"long reads: {n_long} ({len(novel_idx)} random), {bases} bases, "
        f"{gen_s:.1f} s")
    # quant --long's first batch, as the pipeline packs it
    pb = next(fastx.packed_single_batches(lr, 16384, k))
    k5d = _hold_j(torch, np, pa, kernels, didx, pb, k, dev,
                  "5d first batch")[:3]
    del pb

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outq = os.path.join(work, "long_quant")
    res = run_quant(Options(files=[lr], single_end=True, long_read=True,
                            platform="PacBio", plaintext=True,
                            output_dir=outq), index=index, device=dev)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"launches on the quant --long path: {launches}")
    n_batches = -(-n_long // 16384)
    t = res.timings
    check(launches["pseudoalign_long"] == t["long"] == n_batches
          and launches["em_step_batch"] > 0,
          f"quant --long: kernel J launched {launches['pseudoalign_long']} "
          f"times ({n_batches} batches), G {launches['em_step_batch']}")
    got = [x for x in read_file(os.path.join(outq, "novel.fastq"))
           .split("\n")[1::2]]
    found = len(want_novel & set(got))
    check(found >= 0.9 * len(want_novel),
          f"quant --long: {found} of {len(want_novel)} random reads in "
          f"novel.fastq ({len(got)} reads there)")
    share = res.num_pseudoaligned / (n_long - len(novel_idx))
    check(share >= 0.9 and res.num_processed == n_long,
          f"quant --long: {res.num_pseudoaligned} of "
          f"{n_long - len(novel_idx)} transcript reads pseudoaligned "
          f"({share:.4f} >= 0.9)")
    log(f"quant --long wall {quant_s:.2f} s = {n_long / quant_s:,.0f} "
        f"reads/s; host seconds by phase: " + json.dumps(t))

    # index.saved (the same index every time, ~1 min of host compression
    # at this size, no kernel) is not written by this phase's bus runs:
    # the time limit
    saved = busmod.save_index
    busmod.save_index = lambda *a: None
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        bres = run_bus(Options(files=[lr], technology="bulk", long_read=True,
                               output_dir=os.path.join(work, "long_bus")),
                       index=index, device=dev)
        torch.cuda.synchronize()
        bus_s = time.perf_counter() - t0
        blaunches = dict(kernels.LAUNCHES)
        check(blaunches["pseudoalign_long"] == bres.timings["long"] > 0
              and bres.num_processed == n_long,
              f"bus --long: kernel J launched "
              f"{blaunches['pseudoalign_long']} times, "
              f"{bres.num_pseudoaligned} of {n_long} reads aligned")
        log(f"bus --long wall {bus_s:.2f} s = {n_long / bus_s:,.0f} "
            "reads/s (index.saved not written); host seconds by phase: "
            + json.dumps(bres.timings))

        # the first 4,096 reads on the card and on the CPU
        sub = os.path.join(work, "lr_5d_4096.fastq.gz")
        truncate_fastq(lr, sub, 4096)
        subs = {}
        for where in (dev, "cpu"):
            oq = os.path.join(work, f"long_quant_{where}")
            ob = os.path.join(work, f"long_bus_{where}")
            run_quant(Options(files=[sub], single_end=True, long_read=True,
                              platform="PacBio", plaintext=True,
                              output_dir=oq), index=index, device=where)
            run_bus(Options(files=[sub], technology="bulk", long_read=True,
                            output_dir=ob), index=index, device=where)
            subs[str(where)] = (oq, ob)
    finally:
        busmod.save_index = saved
    (gq, gb), (cq, cb) = subs[str(dev)], subs["cpu"]
    check(read_bytes(os.path.join(gq, "abundance.tsv"))
          == read_bytes(os.path.join(cq, "abundance.tsv"))
          and read_bytes(os.path.join(gb, "output.bus"))
          == read_bytes(os.path.join(cb, "output.bus")),
          "first 4,096 long reads: abundance.tsv and output.bus byte-equal, "
          "card vs CPU")
    return launches, k5d, {
        "long_n_reads": n_long, "long_bases": bases,
        "long_quant_s": quant_s, "long_quant_reads_per_s": n_long / quant_s,
        "long_quant_phases_s": t, "long_bus_s": bus_s,
        "long_bus_reads_per_s": n_long / bus_s,
        "long_bus_phases_s": bres.timings, "long_bus_launches": blaunches}


def phase_5e(torch, np, kernels, emq, Options, run_quant_tcc, index,
             bus_out, work, dev):
    """quant-tcc of phase 5c's bus output, collapsed to cells x ECs, on the
    card; the first 256 cells also on the CPU.  Returns (launches, kernel
    G's row fields at the TCC shape, summary)."""
    from kallisto_tpu_torch.quant.tcc import load_ec_file, load_tcc_matrix

    t0 = time.perf_counter()
    rec = _bus_records(np, os.path.join(bus_out, "output.bus"))
    ec_file = os.path.join(bus_out, "matrix.ec")
    n_ec = sum(1 for _ in open(ec_file))
    # distinct UMIs per (barcode, EC), as bustools count --tcc
    trip = np.unique(np.stack([rec["bc"].astype(np.int64),
                               rec["umi"].astype(np.int64),
                               rec["ec"].astype(np.int64)], axis=1), axis=0)
    cells, cell_of = np.unique(trip[:, 0], return_inverse=True)
    pairs, n = np.unique(np.stack([cell_of.reshape(-1), trip[:, 2]], axis=1),
                         axis=0, return_counts=True)

    def write_mtx(path, n_cells):
        keep = pairs[:, 0] < n_cells
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n")
            f.write(f"{n_cells}\t{n_ec}\t{int(keep.sum())}\n")
            f.write("".join(f"{r + 1}\t{c + 1}\t{v}\n" for (r, c), v in zip(
                pairs[keep].tolist(), n[keep].tolist())))

    mtx = os.path.join(work, "cells.mtx")
    write_mtx(mtx, len(cells))
    collapse_s = time.perf_counter() - t0
    log(f"TCC matrix: {len(cells)} cells x {n_ec} ECs, {len(pairs)} entries, "
        f"{int(n.sum())} UMIs, {collapse_s:.1f} s")

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_quant_tcc(Options(ec_file=ec_file, tcc_file=mtx,
                                output_dir=os.path.join(work, "tcc")),
                        index=index, device=dev)
    torch.cuda.synchronize()
    tcc_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    t = res.timings
    check(t["em_rounds"] > 0 and t["chunks"] == -(-len(cells) // 256)
          and g_launches_cover(emq, launches["em_step_batch"],
                               t["em_rounds"], t["chunks"]),
          f"quant-tcc: {len(cells)} cells in {t['chunks']} chunks, kernel G "
          f"launched {launches['em_step_batch']} times (rounds of "
          f"{emq.EM_CHUNK} per replay) for {t['em_rounds']} rounds")
    check(np.isfinite(res.est_counts).all()
          and (res.est_counts.sum(axis=1) > 0).mean() > 0.99,
          "quant-tcc: finite abundances, > 99 % of cells with counts")
    log(f"quant-tcc wall {tcc_s:.2f} s = {len(cells) / tcc_s:,.1f} cells/s, "
        f"EM {t['em_s']:.3f} s over {t['em_rounds']} rounds; host seconds "
        "by phase: " + json.dumps(t))

    sub = os.path.join(work, "cells_256.mtx")
    write_mtx(sub, 256)
    outs = {}
    for where in (dev, "cpu"):
        out = os.path.join(work, f"tcc256_{where}")
        t1 = time.perf_counter()
        r = run_quant_tcc(Options(ec_file=ec_file, tcc_file=sub,
                                  output_dir=out), index=index, device=where)
        outs[str(where)] = (out, time.perf_counter() - t1, r)
    check(np.array_equal(outs[str(dev)][2].est_counts,
                         outs["cpu"][2].est_counts)
          and read_bytes(os.path.join(outs[str(dev)][0],
                                      "matrix.abundance.mtx"))
          == read_bytes(os.path.join(outs["cpu"][0], "matrix.abundance.mtx")),
          "quant-tcc, first 256 cells: est_counts bitwise equal and "
          "matrix.abundance.mtx byte-equal, card vs CPU (CPU "
          f"{outs['cpu'][1]:.1f} s)")

    # kernel G at the TCC shape: one update of the first chunk's 256 cells
    # with their own lengths, on the card and, plain, on the CPU
    T = index.num_trans
    ec_sets = load_ec_file(ec_file, T)
    problem = emq.build_em_problem(ec_sets, T)
    rows, cols, vals, C, _, _ = load_tcc_matrix(sub)
    counts = np.zeros((C, len(ec_sets)), np.float64)
    counts[rows, cols] = vals
    sa_b, mc_b = emq.em_inputs(problem, counts)
    inv = 1.0 / res.eff_lens[:C]
    prob = emq.device_em_problem(problem, sa_b, mc_b, inv, dev)
    alpha_h = res.est_counts[:C].copy()
    alpha = torch.from_numpy(alpha_h).to(dev)
    # modes 0/1/2 mixed: frozen, updating, and updating from zeroed values
    mixed = np.arange(C, dtype=np.int32) % 3
    ng, cg = em_update(np, emq, prob, alpha_h, mixed)
    prob_cpu = emq.device_em_problem(problem, sa_b, mc_b, inv, "cpu")
    npl, cpl = emq.em_step_batch_plain(torch.from_numpy(alpha_h), prob_cpu,
                                       torch.from_numpy(mixed))
    npl, cpl = npl.numpy(), cpl.numpy()
    check(np.array_equal(ng, npl) and np.array_equal(cg, cpl),
          f"kernel G, one update of {C} cells with their own lengths (modes "
          "0/1/2 mixed): next and change counts bitwise equal to the plain "
          "version on the CPU")
    err = float(np.abs(ng - npl).max())
    del ng, cg, npl, cpl, prob_cpu
    mode = torch.ones(C, dtype=torch.int32, device=dev)
    ms = em_chunk_ms(torch, np, emq, prob)
    plain = cuda_ms(lambda: emq.em_step_batch_plain(alpha, prob, mode), 5,
                    torch)
    E, M = prob.num_multi, int(prob.flat_tx.shape[0])
    bnd = em_bound(C, T, E, M, own_eff=True)
    log(f"kernel G, {C} cells with their own lengths: {ms:.4f} ms per round "
        f"over chunks of {emq.EM_CHUNK} (plain on card "
        f"{plain:.3f} ms); the run's EM {t['em_s']:.3f} s, "
        f"{t['em_host_reads']} host reads; T={T} E={E} M={M}")
    summary = {"tcc_cells": len(cells), "tcc_ecs": n_ec,
               "tcc_entries": len(pairs), "tcc_s": tcc_s,
               "tcc_cells_per_s": len(cells) / tcc_s, "tcc_phases_s": t,
               "tcc_cpu_256_s": outs["cpu"][1],
               "tcc_card_256_s": outs[str(dev)][1]}
    return launches, (ms, plain, bnd, err), summary


def _hold_k(torch, np, pa, kernels, didx, args, kw, tag):
    """Kernels K, E with per-read slots and F's slim layout against their
    plain versions, all on the card, on one half-fail slice as
    turbo.pseudoalign_pair_halffail receives it (args: pkf, vsum, sidev,
    aux; kw: its keywords): every field, table entry and slot equal, every
    slot naming its read's own key.  Returns {name: (ms, plain_ms,
    (bound_ms, bound_by), library_ms)}."""
    from kallisto_tpu_torch.ops import anchor, turbo

    pkf, vsum, sidev, aux = args
    k, L, R, rl = kw["k"], kw["L"], kw["max_rows"], kw["rl"]
    Bp = int(pkf.shape[0])
    Rr = min(R, (rl if 0 < rl < L else L) - k + 1)
    spec = pa.KeySpec(k, kw.get("min_range", 0), kw.get("strand_key", False),
                      kw.get("pos_fl", -1), kw.get("pos_depth", 0))
    n_real = int((sidev != 0).sum())
    go = kernels.pseudoalign_halffail(didx, pkf, vsum, sidev, aux, k, L, rl,
                                      Rr)
    g1, g2 = pa.SideResult(*go[0]), pa.SideResult(*go[1])
    c1, c2 = turbo.halffail_core(didx, pkf, vsum, sidev, aux, k, L, R, rl)
    torch.cuda.synchronize()
    _equal_sides(torch, pa, g1, c1, f"kernel K mate 1 {tag}")
    _equal_sides(torch, pa, g2, c2, f"kernel K mate 2 {tag}")
    ck, slots, h, _ = _hold_e(torch, pa, kernels, g1, g2, spec, Bp + 1, didx,
                              f"on kernel K's sides {tag}", with_slots=True)
    hp, flp = pa.key_hash_plain(c1, c2, spec, didx)
    ckp, slotsp = pa.key_histogram_plain(hp, flp, Bp + 1, with_slots=True)
    torch.cuda.synchronize()
    _equal_tables(torch, ck, ckp, f"kernels K + E {tag}")
    check(torch.equal(slots, slotsp),
          f"kernel E {tag}: {Bp} per-read slots equal to the plain versions'")
    check(torch.equal(ck[1:, :2][slots.long()], h),
          f"kernel E {tag}: every read's slot names its own key")
    n_uniq = int(ck[0, 0])
    idx = ck[1 : n_uniq + 1, 3].contiguous()
    sg = pa.gather_slim(idx, g1, g2)
    check(torch.equal(sg, pa.gather_slim_plain(idx, g1, g2)),
          f"kernel F slim {tag}: {n_uniq} rows equal")
    # the windows the covered-interval core probed: the kernel's count
    # against the plain model's mask (anchor.skip_core_plain)
    codes, lens_v = turbo.codes_and_lens_plain((pkf,), aux, None, L, rl)
    _, probed = anchor.skip_core_plain(didx, codes, lens_v, k, R)
    n_pr = torch.zeros(1, dtype=torch.int64, device=pkf.device)
    kernels.pseudoalign_halffail(didx, pkf, vsum, sidev, aux, k, L, rl, Rr,
                                 probes=n_pr)
    torch.cuda.synchronize()
    n_probe = int(probed.sum())
    d_probe = _dense_probes(torch, pa, codes, lens_v, k)
    check(int(n_pr) == n_probe,
          f"kernel K {tag}: {n_probe} failed-mate windows probed of the "
          f"dense core's {d_probe}, as the plain model has them")
    ms_k = cuda_ms(lambda: kernels.pseudoalign_halffail(
        didx, pkf, vsum, sidev, aux, k, L, rl, Rr), 10, torch)
    dev_k = graph_ms(lambda: kernels.pseudoalign_halffail(
        didx, pkf, vsum, sidev, aux, k, L, rl, Rr), 10, torch)
    plain_k = cuda_ms(lambda: turbo.halffail_core(
        didx, pkf, vsum, sidev, aux, k, L, R, rl), 3, torch)
    # the failed mates' table reads: every window's (the dense work, the
    # formula of the earlier rows) or the design's probes; per real pair
    # two block_ec8 rows and its summary; codes, aux in, both mates out
    table, n_win, n_valid, n_hit = _window_bytes(torch, pa, didx, codes,
                                                 lens_v, k)
    tab_s, _ = _skip_bytes(torch, pa, didx, codes, lens_v, k, probed)
    del codes, lens_v, probed
    # the verified mates' two block_ec8 rows (32 B each), each row once
    r0 = vsum[sidev != 0, 0].clamp(min=0) >> 3
    rows8 = 32 * int(torch.unique(torch.cat([r0, r0 + 1])).numel())
    io = (pkf.numel() + 8 * Bp + 4 * Bp + 8 * aux.numel()
          + 2 * Bp * (4 * Rr + 4 * 6 + 3))
    bnd_k = bound(io + tab_s + rows8, 250 * n_probe, PEAK_INT_OPS)
    dense_k = bound(io + table + rows8, 250 * n_win, PEAK_INT_OPS)
    ms_e = cuda_ms(lambda: kernels.compact_keys(g1, g2, spec, Bp + 1, True,
                                                didx), 20, torch)
    dev_e = graph_ms(lambda: kernels.compact_keys(g1, g2, spec, Bp + 1, True,
                                                  didx), 20, torch)
    plain_e = cuda_ms(lambda: pa.key_histogram_plain(
        *pa.key_hash_plain(g1, g2, spec, didx), Bp + 1, True), 5, torch)
    h0 = h[:, 0].contiguous()
    lib_e = cuda_ms(lambda: torch.unique(h0, return_inverse=True), 20, torch)
    # the compact key's inputs read once, the table and the slots written
    bnd_e = bound(_key_in_bytes(g1, g2, spec) + 40 * (Bp + 2) + 4 * Bp, 0,
                  PEAK_INT_OPS)
    ms_f = cuda_ms(lambda: kernels.gather_slim(idx, g1, g2), 20, torch)
    plain_f = cuda_ms(lambda: pa.gather_slim_plain(idx, g1, g2), 5, torch)
    bnd_f = bound(n_uniq * (8 + 20 + 2 * 8 + 4), 0, PEAK_INT_OPS)
    log(f"{tag} ({n_real} half-fail pairs, Bp={Bp}): kernel K {ms_k:.4f} ms, "
        f"device (L2-warm) {dev_k:.4f} ms (plain on card {plain_k:.3f} ms, "
        f"bound {bnd_k[0]:.4f} ms {bnd_k[1]} over {n_probe} probes, "
        f"dense-work bound {dense_k[0]:.4f} ms, {n_win} failed-mate windows, "
        f"{n_valid} valid, {n_hit} hits, {n_probe} of the dense core's "
        f"{d_probe} probed: {1 - n_probe / max(d_probe, 1):.4f} skipped); "
        f"kernel E with slots {ms_e:.4f} ms, device (L2-warm) "
        f"{dev_e:.4f} ms (plain "
        f"{plain_e:.3f} ms, torch.unique with inverse {lib_e:.4f} ms, "
        f"bound {bnd_e[0]:.5f} ms, n_uniq {n_uniq}); kernel F slim "
        f"{ms_f:.4f} ms (plain {plain_f:.4f} ms, bound {bnd_f[0]:.6f} "
        f"ms, {n_uniq} rows)")
    return {"pseudoalign_halffail": (ms_k, plain_k, bnd_k, None),
            "pseudoalign_halffail_design": dict(
                device_ms=dev_k, dense_bound_ms=dense_k[0], probes=n_probe,
                dense_probes=d_probe,
                skipped_share=1 - n_probe / max(d_probe, 1)),
            "key_histogram_slots": (ms_e, plain_e, bnd_e, lib_e),
            "key_histogram_slots_device_ms": dev_e,
            "gather_slim": (ms_f, plain_f, bnd_f, None)}


def _host_probe(pa, index, bs, k):
    """The port's host probe (host wave 1) of the pairs bs, keys with the
    strand tail and the position rank: (probe, its result, seconds, kernel
    K's keywords for its slices)."""
    from kallisto_tpu_torch.ops.hostprobe import HostProbe
    from kallisto_tpu_torch.quant import pipeline as qp

    probe = HostProbe(index, strand_key=True, pos_key=True, pos_fl=180)
    t0 = time.perf_counter()
    hk = probe.probe_pair(bs[0], bs[1], READ_LEN, perread=True)
    probe_s = time.perf_counter() - t0
    kw = dict(k=k, min_range=0, strand_key=True, pos_fl=180,
              pos_depth=pa.pf_probe_depth(index), L=bs[0].Lp,
              max_rows=qp._W2ROWS, rl=READ_LEN)
    return probe, hk, probe_s, kw


def _half_slice(torch, np, hk, bs, pos, Bp, dev):
    """The half-fail pairs hk.fail_idx[pos] as quant/pipeline.py hands them
    to kernel K, padded to Bp rows: (failed mates' packed codes, verified
    mates' EC sums, failed side, aux)."""
    from kallisto_tpu_torch.ops import turbo
    from kallisto_tpu_torch.quant import pipeline as qp

    sub = hk.fail_idx[pos].astype(np.int64)
    side = hk.fail_side[pos]
    m1 = (side == 1)[:, None]
    pkf = np.where(m1, bs[0].packed[sub], bs[1].packed[sub])
    nmf = np.where(m1, bs[0].nmask[sub], bs[1].nmask[sub])
    exc = qp._rows_exceptions([(nmf, bs[0].lens[sub])], Bp, bs[0].Lp)
    check(exc is not None, "the slice's N positions fit the aux vector")
    return tuple(_put(torch, np, a, dev) for a in (
        qp._pad_rows(pkf, Bp), qp._pad_rows(hk.fail_vsum[pos], Bp),
        qp._pad_rows(side.astype(np.int32), Bp),
        turbo.make_aux(sub.shape[0], READ_LEN, exc)))


def phase_3f(torch, np, pa, kernels, fastx, index, didx, r1p, r2p, k, dev,
             batch):
    """Kernels K, E with slots and F's slim layout against their plain
    versions on the card, on host wave 1's wave-2 slices of phase 2's pairs
    (sparse Ns, uniform 100 bp) after the port's host probe: the half-fail
    slice at Bp = 262,144 and at the smallest bucket, 16,384, and the
    both-failed slice; keys with the strand tail and the position rank.
    Returns {name: (ms, plain_ms, (bound_ms, bound_by), library_ms)} and
    the probe's figures."""
    from kallisto_tpu_torch.ops import turbo
    from kallisto_tpu_torch.quant import pipeline as qp

    rng = np.random.default_rng(66)
    rl, R = READ_LEN, qp._W2ROWS
    n = 2 * batch
    rbs = []
    for path in (r1p, r2p):
        fs = fastx.FastqStream(path)
        rbs.append(fs.next_batch(n))
        fs.close()
    bs = _sparse_pairs(np, fastx, rbs, rbs[0].n, k, rng)
    del rbs
    probe, hk, probe_s, kw = _host_probe(pa, index, bs, k)
    half = np.flatnonzero(hk.fail_side != 3)
    both = np.flatnonzero(hk.fail_side == 3)
    n_pairs = bs[0].n
    log(f"host probe: {n_pairs} pairs in {probe_s:.3f} s "
        f"({probe.n_threads} threads): {n_pairs - hk.fail_idx.shape[0]} "
        f"verified, {half.shape[0]} half-fail, {both.shape[0]} both failed, "
        f"{hk.h128.shape[0]} host keys")
    depth = kw["pos_depth"]
    spec = pa.KeySpec(k, kw["min_range"], kw["strand_key"], kw["pos_fl"],
                      depth)

    out = {}
    L = bs[0].Lp
    for Bp in (qp._W2MAX, qp._W2MIN):
        pos = half[: min(half.shape[0],
                         Bp if Bp == qp._W2MAX else 3 * Bp // 4)]
        held = _hold_k(torch, np, pa, kernels, didx,
                       _half_slice(torch, np, hk, bs, pos, Bp, dev), kw,
                       f"3f Bp={Bp}")
        key = "" if Bp == qp._W2MAX else "_16k"
        out.update({name + key: v for name, v in held.items()})

    # the both-failed slice: kernel D and E with slots on both mates
    sub = hk.fail_idx[both[: qp._W2MAX]].astype(np.int64)
    Bp = qp._bucket_size(sub.shape[0], lo=qp._W2MIN)
    exc = qp._rows_exceptions([(b.nmask[sub], b.lens[sub]) for b in bs], Bp, L)
    aux = _put(torch, np, turbo.make_aux(sub.shape[0], rl, exc), dev)
    p1, p2 = (_put(torch, np, qp._pad_rows(b.packed[sub], Bp), dev)
              for b in bs)
    g1, g2, ck, slots = turbo.pseudoalign_pair_turbo(
        didx, p1, p2, aux, k=k, L=L, max_rows=R, max_keys=Bp + 1, rl=rl,
        with_slots=True, min_range=0, strand_key=True, pos_fl=180,
        pos_depth=depth)
    hp, flp = pa.key_hash_plain(g1, g2, spec, didx)
    ckp, slotsp = pa.key_histogram_plain(hp, flp, Bp + 1, with_slots=True)
    torch.cuda.synchronize()
    check(torch.equal(ck, ckp) and torch.equal(slots, slotsp),
          f"both-failed slice ({sub.shape[0]} pairs, Bp={Bp}): kernel D + E "
          "key table and slots equal to the plain E on D's sides")
    summary = {"probe_pairs": n_pairs, "probe_s_3f": probe_s,
               "probe_threads": probe.n_threads,
               "half_fail": int(half.shape[0]), "both_failed":
               int(both.shape[0]), "host_keys": int(hk.h128.shape[0])}
    return out, summary


def _first_hits(torch, idx, hit):
    """The slot of each read's first hit (idx, hit: [reads, windows]), for
    the reads with hits."""
    j = hit.to(torch.int32).argmax(dim=1, keepdim=True)
    return idx.gather(1, j)[:, 0][hit.any(dim=1)]


def _sector_ids(torch, pa, didx, canon, valid, idx, hit, payload=None,
                uids=False):
    """The distinct 32-byte table sectors that the probes of (canon,
    valid) must read, each once however many probes share it (idx, hit:
    the plain lookup_kmers' slots and hits), as {table: sector ids}.
    Padded: each probed bucket's row (ceil(8S / 32) key sectors: the
    invalid windows all probe the bucket of mix64(0)) and each hit's EC
    sector.  Bucketed: each probed bucket's bucket_start sectors, the key
    sector at each probe's slot and each hit's kmer_ec sector (the
    search's earlier steps are not counted).  payload: slots whose uid,
    pos and block sectors (4 B each) and fw sector (1 B) are read; uids:
    the kmer_uid sector of every hit."""
    u = torch.unique
    if isinstance(didx, pa.PaddedDeviceIndex):
        S = didx.S
        b = idx // S
        ids = {"rows": u(b), "ec": u((b * 2 * S + S + idx % S)[hit] >> 2)}
    else:
        q = pa.mix64(torch.where(valid, canon, torch.zeros_like(canon)))
        b = (q >> (64 - didx.p)) & ((1 << didx.p) - 1)
        ids = {"bucket_start": u(torch.cat([b >> 3, (b + 1) >> 3])),
               "keys": u(idx >> 2), "ec": u(idx[hit] >> 3)}
    if payload is not None:
        ids["payload"], ids["fw"] = u(payload >> 3), u(payload >> 5)
    if uids:
        ids["uid"] = u(idx[hit] >> 3)
    return ids


def _merge_sectors(torch, a, b):
    """The union of two _sector_ids results (slices of one batch)."""
    return {t: torch.unique(torch.cat([a[t], b[t]])) for t in a}


def _n_sectors(didx, ids):
    """The sector count of _sector_ids: a padded bucket row's key sectors
    each, the three 4-byte payload tables (uid, pos, block) each."""
    w = {"rows": -(-8 * getattr(didx, "S", 1) // 32), "payload": 3}
    return sum(w.get(t, 1) * int(v.numel()) for t, v in ids.items())


def _window_bytes(torch, pa, didx, codes, lens, k):
    """A probing kernel's table bytes on reads (codes [B, L], lens [B]):
    every window's probe and each read's first-hit payload, each sector
    once (_sector_ids).  Returns (bytes, windows, valid, hits)."""
    canon, _, valid = pa.rolling_canonical_kmers(codes, lens, k)
    idx, hit, _ = pa.lookup_kmers(didx, canon, valid)
    ids = _sector_ids(torch, pa, didx, canon, valid, idx, hit,
                      payload=_first_hits(torch, idx, hit))
    return (32 * _n_sectors(didx, ids), canon.numel(), int(valid.sum()),
            int(hit.sum()))


def _anchor_bytes(torch, pa, anchor, didx, codes, real, rl, k, na):
    """Kernel I's table bytes on its reads (codes [B2, L] of uniform length
    rl, real rows, na anchors), each sector once: the anchors' probes and
    every hit anchor's payload (uid, pos, fw, block), each verified read's
    two block_ec8 rows (32 B each), and the wave-2 reads' window probes
    and first-hit payloads.  Returns (bytes, wave-2 windows, verified
    reads, wave-2 reads)."""
    w1 = anchor.anchor_wave1_plain(didx, codes, rl, real, k, na)
    can_a = torch.stack([anchor._anchor_canon(codes, w, k)[0]
                         for w in w1.ws], dim=1)
    idx_a, hit_a, _ = pa.lookup_kmers(didx, can_a, w1.valid)
    fail = ~w1.ok & real
    lens = torch.full((int(fail.sum()),), rl, dtype=torch.int32,
                      device=codes.device)
    canon, _, valid = pa.rolling_canonical_kmers(codes[fail], lens, k)
    idx, hit, _ = pa.lookup_kmers(didx, canon, valid)
    ids = _sector_ids(
        torch, pa, didx, torch.cat([can_a.flatten(), canon.flatten()]),
        torch.cat([w1.valid.flatten(), valid.flatten()]),
        torch.cat([idx_a.flatten(), idx.flatten()]),
        torch.cat([hit_a.flatten(), hit.flatten()]),
        payload=torch.cat([idx_a[hit_a], _first_hits(torch, idx, hit)]))
    r0 = w1.blk.amin(dim=1)[w1.ok].clamp(min=0) >> 3
    ids["block_ec8"] = torch.unique(torch.cat([r0, r0 + 1]))
    return (32 * _n_sectors(didx, ids), canon.numel(), int(w1.ok.sum()),
            int(fail.sum()))


def _side_bytes(torch, pa, didx, codes, lens, fail, k):
    """Kernel A's table bytes on its reads (codes [B, L], lens [B], fail:
    the reads of its wave 2), each sector once: the verified reads' anchor
    probes (n_anchors_for(len, k) at w_j = (wlast * j) / (n_anchors - 1))
    and every hit anchor's payload (uid, pos, fw, block), each verified
    read's two block_ec8 rows, and the wave-2 reads' window probes and
    first-hit payloads.  Returns (bytes, probes: anchors plus wave-2
    windows)."""
    canon, _, valid = pa.rolling_canonical_kmers(codes, lens, k)
    W = canon.shape[1]
    ver = ~fail
    wl = lens[ver].long() - k
    na = torch.clamp((wl + k - 1) // k + 1, min=2)
    j = torch.arange(int(na.max()) if na.numel() else 2,
                     device=codes.device)[None, :]
    m = j < na[:, None]
    w = torch.clamp((wl[:, None] * j) // (na[:, None] - 1), 0, W - 1)
    can_a = canon[ver].gather(1, w)[m]
    val_a = valid[ver].gather(1, w)[m]
    idx_a, hit_a, _ = pa.lookup_kmers(didx, can_a, val_a)
    cf, vf = canon[fail], valid[fail]
    idx_f, hit_f, _ = pa.lookup_kmers(didx, cf, vf)
    ids = _sector_ids(
        torch, pa, didx, torch.cat([can_a, cf.flatten()]),
        torch.cat([val_a, vf.flatten()]), torch.cat([idx_a, idx_f.flatten()]),
        torch.cat([hit_a, hit_f.flatten()]),
        payload=torch.cat([idx_a[hit_a], _first_hits(torch, idx_f, hit_f)]))
    rid = torch.arange(int(ver.sum()), device=codes.device)[:, None] \
        .expand_as(w)[m]
    blo = torch.full((int(ver.sum()),), 2**31 - 1, dtype=torch.int32,
                     device=codes.device).scatter_reduce(
        0, rid[hit_a], didx.kmer_block[idx_a[hit_a]], "amin")
    r0 = blo.clamp(min=0) >> 3
    ids["block_ec8"] = torch.unique(torch.cat([r0, r0 + 1]))
    return 32 * _n_sectors(didx, ids), int(can_a.numel() + cf.numel())


def _hold_a(torch, pa, anchor, kernels, didx, g_in, L, k, tag):
    """Kernel A (both waves) against its plain version and the plain
    two-wave composition (anchor.side_waves_plain), all on the card: every
    field equal, and its wave-2 count equal to the composition's failing
    reads.  Returns the composition's fail mask."""
    R = min(16, L - k + 1)
    g, _, nf = kernels.pseudoalign_side(didx, *g_in, k, L, R)
    c = pa.pseudoalign_batch_packed_plain(didx, *g_in, k, L)
    w, fail = anchor.side_waves_plain(didx, *g_in, k, L)
    torch.cuda.synchronize()
    _equal_sides(torch, pa, pa.SideResult(*g), c, f"kernel A {tag}")
    _equal_sides(torch, pa, w, c, f"plain two-wave composition {tag}")
    B = int(g_in[2].shape[0])
    check(int(nf) == int(fail.sum()), f"kernel A {tag}: {int(nf)} of {B} "
          f"reads in wave 2 ({int(nf) / max(B, 1):.4f}), as the plain "
          "composition lists them")
    return fail


def _time_side_waves(torch, pa, kernels, didx, g_in, L, k, fail):
    """Kernel A's two launches timed alone on one batch (g_in on the card,
    fail: its wave-2 reads): wave 1, and wave 2 on the reads wave 1
    listed, with wave 2's plain version (the dense core on those reads)
    and bound (their window probes and first-hit payloads, each table
    sector once, their packed rows and N masks, the list and the
    outputs).  Returns wave 2's row fields and wave 1's ms."""
    R = min(16, L - k + 1)
    lists = kernels.pseudoalign_side(didx, *g_in, k, L, R, waves=1)
    ms1 = cuda_ms(lambda: kernels.pseudoalign_side(didx, *g_in, k, L, R,
                                                   waves=1), 10, torch)
    ms2 = cuda_ms(lambda: kernels.pseudoalign_side(didx, *g_in, k, L, R,
                                                   waves=2, lists=lists),
                  10, torch)
    n = int(lists[2])
    sel = torch.nonzero(fail).squeeze(1)
    sub = [t[sel].contiguous() for t in g_in]
    plain = cuda_ms(lambda: pa.pseudoalign_batch_packed_plain(
        didx, *sub, k, L), 3, torch)
    codes = pa.unpack_codes(sub[0], sub[1], L)
    table, n_win, _, _ = _window_bytes(torch, pa, didx, codes, sub[2], k)
    io = n * (L // 4 + L // 8 + 4 + 4 + 4 * R + 27) + 8
    bnd = bound(table + io, 250 * n_win, PEAK_INT_OPS)
    B = int(g_in[2].shape[0])
    log(f"kernel A's waves alone: wave 1 {ms1:.3f} ms on {B} reads, wave 2 "
        f"{ms2:.3f} ms on {n} listed reads ({n / B:.4f}; plain on card "
        f"{plain:.3f} ms, bound {bnd[0]:.4f} ms)")
    return dict(ms=ms2, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                reads=n, wave1_ms=ms1, wave2_share=n / B)


@contextlib.contextmanager
def _side_lists(kernels):
    """Records every kernel A call made in the block: (its reads, n_fail,
    the length of its wave-2 list, left on the card until read)."""
    got, real = [], kernels.pseudoalign_side

    def spy(didx, packed, nmask, lens, *args, **kw):
        r = real(didx, packed, nmask, lens, *args, **kw)
        got.append((int(lens.shape[0]), r[2]))
        return r

    kernels.pseudoalign_side = spy
    try:
        yield got
    finally:
        kernels.pseudoalign_side = real


def _check_side_lists(got, launches, tag):
    """Every kernel A call of a run (_side_lists) that had reads launched
    wave 1 and then wave 2, and its wave 1 listed some of its reads for
    wave 2: the run's wave-2 launches are those calls."""
    calls = [(b, int(nf)) for b, nf in got if b]
    n = launches["pseudoalign_side"]
    check(launches["pseudoalign_side_wave2"] == n == len(calls)
          and all(0 < nf <= b for b, nf in calls),
          f"{tag}: kernel A's {n} wave-2 launches each after a wave 1 that "
          f"listed reads ({sum(nf for _, nf in calls)} of "
          f"{sum(b for b, _ in calls)})")


def _time_layouts(torch, fn, dp, db, reps):
    """fn(didx) timed on the padded and the bucketed index, in turns
    (padded, bucketed, bucketed, padded): the medians of each."""
    a = cuda_ms(lambda: fn(dp), reps, torch)
    b = cuda_ms(lambda: fn(db), reps, torch)
    b2 = cuda_ms(lambda: fn(db), reps, torch)
    a2 = cuda_ms(lambda: fn(dp), reps, torch)
    return statistics.median((a, a2)), statistics.median((b, b2))


def _turns(torch, fns, reps):
    """Each fn timed by cuda_ms in turns (fns in order, then reversed):
    the median of each fn's two times."""
    first = [cuda_ms(f, reps, torch) for f in fns]
    second = [cuda_ms(f, reps, torch) for f in reversed(fns)][::-1]
    return [statistics.median(x) for x in zip(first, second)]


def _three_take_gather(torch, pa, didx, canon, valid, idx, hit):
    """A yardstick beside kernel L on one layout, timed and never used:
    one torch.take per table of the table elements that L's probes read
    (idx, hit: the plain lookup_kmers' slots and hits) -- padded: each
    query's key at its slot and each hit's EC word in the same bucket row;
    bucketed: each query's bucket_start entry, the key at its slot and
    each hit's kmer_ec entry (the search's earlier steps are not taken,
    as _sector_ids counts) --, in query order, none depending on another.
    It is no floor: its passes write 8-byte outputs of their own, and L
    can run below it.  The indices are made before the timing.  Returns
    (ms, device ms)."""
    if isinstance(didx, pa.PaddedDeviceIndex):
        S = didx.S
        flat = didx.bucket_rows.view(-1)
        base = (idx // S) * (2 * S) + idx % S
        takes = [(flat, base), (flat, (base + S)[hit])]
    else:
        q = pa.mix64(torch.where(valid, canon, torch.zeros_like(canon)))
        b = (q >> (64 - didx.p)) & ((1 << didx.p) - 1)
        takes = [(didx.bucket_start, b), (didx.kmer_hkeys, idx),
                 (didx.kmer_ec, idx[hit])]

    def fn():
        return [torch.take(t, i) for t, i in takes]

    return cuda_ms(fn, 10, torch), graph_ms(fn, 10, torch)


def _hold_l_once(torch, pa, kernels, d, canon, valid, tag):
    """Kernel L on one index (a bucketed one through its packed entries)
    against the plain lookup_kmers.  Returns the plain version's (idx,
    hit, EC row)."""
    want = pa.lookup_kmers(d, canon, valid)
    got = kernels.lookup_kmers(d, canon, valid)
    torch.cuda.synchronize()
    for name, x, y in zip(("idx", "hit", "ec"), got, want):
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"kernel L {tag}: {name} equal on {canon.numel()} windows "
              f"({int(want[1].sum())} hits)")
    return want


def _l_phase2(torch, pa, kernels, didx, canon, valid):
    """Kernel L on phase 2's bucketed index (1.1 GB: its random sectors
    come from HBM) and phase 3's A windows: held, timed from the host and
    as device time.  Returns L's row fields for this index."""
    idx, hit, _ = _hold_l_once(torch, pa, kernels, didx, canon, valid,
                               "phase 2 bucketed")

    def fn():
        return kernels.lookup_kmers(didx, canon, valid)

    ms, dev_ms = cuda_ms(fn, 10, torch), graph_ms(fn, 10, torch)
    nq = canon.numel()
    sec = _n_sectors(didx, _sector_ids(torch, pa, didx, canon, valid, idx,
                                       hit))
    bnd = bound(22 * nq + 32 * sec, 40 * nq, PEAK_INT_OPS)
    ent_bytes = kernels.packed_entries(didx).numel() * 8
    log(f"kernel L on phase 2's index ({didx.nbytes()} B bucketed), {nq} "
        f"windows ({int(valid.sum())} valid, {int(hit.sum())} hits): "
        f"{ms:.4f} ms (device {dev_ms:.4f}), bound {bnd[0]:.4f} ms ({sec} "
        f"sectors); packed entries {ent_bytes} B")
    return dict(ms_phase2_bucketed=ms, device_ms_phase2_bucketed=dev_ms,
                bound_ms_phase2_bucketed=bnd[0], queries_phase2=nq,
                packed_bytes_phase2=ent_bytes)


def _hold_l(torch, pa, kernels, dp, db, canon, valid, n):
    """Kernel L against the plain lookup_kmers in both layouts (the
    bucketed one through its packed entries), on the first n of the
    windows (canon, valid), invalid ones included, and on 64 invalid
    windows 0 (q = mix64(0)): slot, hit and EC row equal.  Then all the
    windows timed in both layouts in turns, with device times (graph_ms),
    the plain version, each layout's three-take gather
    (_three_take_gather) and torch.searchsorted beside the bucketed form.
    Returns L's row fields."""
    hc, hv = canon[:n].contiguous(), valid[:n].contiguous()
    check(int((~hv).sum()) > 0, f"{int((~hv).sum())} invalid windows held")
    z = torch.zeros(64, dtype=torch.int64, device=canon.device)
    zf = torch.zeros(64, dtype=torch.bool, device=canon.device)
    for tag, d in (("padded", dp), ("bucketed", db)):
        for what, q, v in (("windows", hc, hv), ("invalid windows 0", z, zf)):
            want = _hold_l_once(torch, pa, kernels, d, q, v,
                                f"{tag} ({what})")
        check(not bool(want[1].any()), f"kernel L {tag}: window 0 never hits")
    nq = canon.numel()
    fns = [lambda: kernels.lookup_kmers(dp, canon, valid),
           lambda: kernels.lookup_kmers(db, canon, valid)]
    ms_p, ms_b = _turns(torch, fns, 20)
    dev_p, dev_b = (graph_ms(f, 10, torch) for f in fns)
    plain_p, plain_b = _time_layouts(
        torch, lambda d: pa.lookup_kmers(d, canon, valid), dp, db, 3)
    # torch.searchsorted on the sign-flipped sorted keys finds the
    # bucketed slot (not the padded b * S + j): timed beside it only
    sk = db.kmer_hkeys ^ (-(2**63))
    qs = pa.mix64(torch.where(valid, canon, torch.zeros_like(canon))) \
        ^ (-(2**63))
    lib_b = cuda_ms(lambda: torch.searchsorted(sk, qs), 20, torch)
    del qs
    # canon + valid in, slot + hit + EC row out (22 B a window); the table
    # sectors the probes must read, each once (_sector_ids)
    bnd, sec, take3 = {}, {}, {}
    for tag, d in (("padded", dp), ("bucketed", db)):
        idx, hit, _ = pa.lookup_kmers(d, canon, valid)
        sec[tag] = _n_sectors(d, _sector_ids(torch, pa, d, canon, valid,
                                             idx, hit))
        bnd[tag] = bound(22 * nq + 32 * sec[tag], 40 * nq, PEAK_INT_OPS)
        take3[tag] = _three_take_gather(torch, pa, d, canon, valid, idx, hit)
    n_hit = int(hit.sum())
    ent_bytes = kernels.packed_entries(db).numel() * 8
    log(f"kernel L on {nq} windows ({int(valid.sum())} valid, {n_hit} "
        f"hits): padded {ms_p:.4f} ms (device {dev_p:.4f}, bound "
        f"{bnd['padded'][0]:.4f} ms, {sec['padded']} distinct sectors, "
        f"three-take gather {take3['padded'][0]:.4f} / device "
        f"{take3['padded'][1]:.4f}, plain {plain_p:.3f} ms), bucketed "
        f"{ms_b:.4f} ms (device {dev_b:.4f}; bound "
        f"{bnd['bucketed'][0]:.4f} ms, {sec['bucketed']} distinct sectors, "
        f"three-take gather {take3['bucketed'][0]:.4f} / device "
        f"{take3['bucketed'][1]:.4f}, plain {plain_b:.3f} ms, "
        f"torch.searchsorted {lib_b:.4f} ms); packed entries {ent_bytes} B")
    return dict(
        ms=ms_p, plain_ms=plain_p, bound_ms=bnd["padded"][0],
        bound_by=bnd["padded"][1], ms_padded=ms_p, ms_bucketed=ms_b,
        device_ms_padded=dev_p, device_ms_bucketed=dev_b,
        three_take_ms_padded=take3["padded"][0],
        three_take_device_ms_padded=take3["padded"][1],
        three_take_ms_bucketed=take3["bucketed"][0],
        three_take_device_ms_bucketed=take3["bucketed"][1],
        bound_ms_padded=bnd["padded"][0], bound_ms_bucketed=bnd["bucketed"][0],
        plain_ms_bucketed=plain_b, searchsorted_ms_bucketed=lib_b,
        queries=nq, valid=int(valid.sum()), hits=n_hit,
        sectors_padded=sec["padded"], sectors_bucketed=sec["bucketed"],
        packed_bytes=ent_bytes)


def _index_set(torch, np, pa, fastx, build_index, generate_transcriptome,
               generate_paired, k, work, dev, genes, n_pairs):
    """A `genes`-gene simulated transcriptome (seed 42), its index on the
    card in the layout the JAX package's rule gives it and, with the padded
    budget set to 0, bucketed, and the first batch of n_pairs simulated
    2x100 bp pairs from it.  Returns (index, that device index, the
    bucketed one, [mate-1 batch, mate-2 batch])."""
    fasta = os.path.join(work, f"tx{genes}.fasta.gz")
    generate_transcriptome(fasta, n_genes=genes, seed=42)
    index = build_index([fasta], k=k)
    d = pa.device_index_from_host(index, dev)
    budget = pa._PADDED_BYTES_BUDGET
    pa._PADDED_BYTES_BUDGET = 0
    try:
        db = pa.device_index_from_host(index, dev)
    finally:
        pa._PADDED_BYTES_BUDGET = budget
    r1p = os.path.join(work, f"tx{genes}_1.fastq.gz")
    r2p = os.path.join(work, f"tx{genes}_2.fastq.gz")
    generate_paired(fasta, r1p, r2p, n_pairs, read_len=READ_LEN,
                    frag_mean=180.0, frag_sd=20.0, error_rate=0.005)
    rbs = []
    for path in (r1p, r2p):
        fs = fastx.FastqStream(path)
        rbs.append(fs.next_batch(n_pairs))
        fs.close()
    return index, d, db, rbs


def _same_shape_times(torch, np, pa, kernels, fastx, dp, db, rbs, k, dev,
                      rng, tag, pbA):
    """A on pbA (phase 3's shape: mate 1 of rbs as ragged_batch makes it)
    held in both layouts (_hold_a) and timed on dp and db in turns
    (_time_layouts), with its wave-2 share; then D and I on the pairs of
    rbs (2x100 bp, sparse Ns): I held against its plain version on dp,
    then D and I (paired and single-end) timed on dp and db in turns, with
    I's wave-2 share on dp.  The batch shapes of phases 3, 3b and 3d (B =
    Bp = 262,144), so that the index alone differs.  Returns the times
    (A's also its bound on dp)."""
    from kallisto_tpu_torch.ops import anchor

    gA = pa.upload_batch(pbA, dev)
    LA, BA = pbA.Lp, pbA.n
    RA = min(16, LA - k + 1)
    fails = [_hold_a(torch, pa, anchor, kernels, d, gA, LA, k,
                     f"{tag}, {type(d).__name__}, B={BA} Lp={LA}")
             for d in (dp, db)]
    out = {"a_reads": BA, "a_wave2_share": int(fails[0].sum()) / BA}
    out["a_ms_1"], out["a_ms_2"] = _time_layouts(
        torch, lambda d: kernels.pseudoalign_side(d, *gA, k, LA, RA), dp, db,
        10)
    codes = pa.unpack_codes(gA[0], gA[1], LA)
    tab, n_probe = _side_bytes(torch, pa, dp, codes, gA[2], fails[0], k)
    io = pbA.packed.nbytes + pbA.nmask.nbytes + 4 * BA + BA * (4 * RA + 27)
    out["a_bound_ms_1"] = bound(io + tab, 250 * n_probe, PEAK_INT_OPS)[0]
    del gA, codes, fails
    Bp = rbs[0].n
    packed, aux, _, L, rl = _turbo_inputs(
        torch, np, _sparse_pairs(np, fastx, rbs, Bp, k, rng), Bp, dev)
    _hold_i(torch, pa, kernels, dp, packed, aux, k, L, rl,
            f"{tag}, {2 * Bp} reads")
    out["reads"] = 2 * Bp
    out["d_ms_1"], out["d_ms_2"] = _time_layouts(
        torch, lambda d: _launch_d(kernels, d, (packed, aux, None, L, rl), k),
        dp, db, 10)
    for form, sides in (("paired", packed), ("single", packed[:1])):
        out[f"i_{form}_ms_1"], out[f"i_{form}_ms_2"] = _time_layouts(
            torch, lambda d: _launch_i(kernels, d, sides, aux, k, L, rl), dp,
            db, 10)
        nf = int(_launch_i(kernels, dp, sides, aux, k, L, rl)[1])
        out[f"i_{form}_wave2_share"] = nf / (len(sides) * Bp)
    log(f"{tag} ({type(dp).__name__} {dp.nbytes()} B, then "
        f"{type(db).__name__} {db.nbytes()} B), {2 * Bp} reads: " + ", ".join(
            f"{key} {v:.4f}" for key, v in out.items()
            if key not in ("reads", "a_reads")))
    return out


def phase_3g(torch, np, pa, kernels, fastx, build_index,
             generate_transcriptome, generate_paired, k, work, dev,
             n_pairs, batch):
    """The padded index layout on the card: the PADDED_GENES-gene index
    (padded, asserted; the same index bucketed with the budget set to 0
    beside it) and n_pairs simulated 2x100 bp pairs from it.  Kernels A,
    D, I, J and K against their plain versions on the padded index, each
    on one batch of at most PADDED_HOLD reads (PADDED_LONG long reads)
    built by the set-up and hold helpers of phases 3, 3b, 3d, 3e and 3f;
    kernel L in both layouts (_hold_l); then A (the batch's mate 1), I
    (the batch's pairs, and mate 1 alone) and L (A's windows) timed in
    both layouts, and D, J and K at their held shapes.  Returns the set-up
    for phase 5h and {name: row fields}."""
    from kallisto_tpu_torch.ops import anchor
    from kallisto_tpu_torch.quant import pipeline as qp

    rng = np.random.default_rng(4242)
    fasta = os.path.join(work, "padded_tx.fasta.gz")
    t0 = time.perf_counter()
    n_tx = generate_transcriptome(fasta, n_genes=PADDED_GENES, seed=42)
    tx_s = time.perf_counter() - t0
    index, build_s, _ = build_timed(build_index, fasta, k, True)
    inp, numpy_s, _ = build_timed(build_index, fasta, k, False)
    check(same_index(np, index, inp), f"{PADDED_GENES} genes: the index "
          "built with the native helpers equal to the numpy build, array "
          "for array")
    del inp
    log(f"{PADDED_GENES}-gene index build: native helpers {build_s:.2f} s, "
        f"numpy {numpy_s:.2f} s (transcriptome {tx_s:.1f} s)")
    M, S = pa.padded_shape(pa.cached_probe_layout(index))
    t0 = time.perf_counter()
    dp = pa.device_index_from_host(index, dev, with_pos_tables=True)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    check(isinstance(dp, pa.PaddedDeviceIndex) and dp.S == S
          and M * S * 16 <= pa._PADDED_BYTES_BUDGET,
          f"{PADDED_GENES} genes, {index.num_kmers} k-mers: the padded "
          f"layout, M={M} S={S}")
    budget = pa._PADDED_BYTES_BUDGET
    pa._PADDED_BYTES_BUDGET = 0
    try:
        db = pa.device_index_from_host(index, dev, with_pos_tables=True)
    finally:
        pa._PADDED_BYTES_BUDGET = budget
    check(isinstance(db, pa.DeviceIndex), "budget 0: the bucketed layout")
    r1p = os.path.join(work, "padded_1.fastq.gz")
    r2p = os.path.join(work, "padded_2.fastq.gz")
    t1 = time.perf_counter()
    generate_paired(fasta, r1p, r2p, n_pairs, read_len=READ_LEN,
                    frag_mean=180.0, frag_sd=20.0, error_rate=0.005)
    log(f"padded index: {n_tx} targets, {index.num_kmers} k-mers, "
        f"p={dp.p} M={M} S={S}, bucket rows {dp.bucket_rows.numel() * 8} "
        f"bytes, nbytes() {dp.nbytes()} (bucketed {db.nbytes()}); build "
        f"{build_s:.1f} s, layout + upload {up_s:.2f} s; {n_pairs} pairs "
        f"2x{READ_LEN} in {time.perf_counter() - t1:.1f} s")
    rbs = []
    for path in (r1p, r2p):
        fs = fastx.FastqStream(path)
        rbs.append(fs.next_batch(batch))
        fs.close()
    n = min(PADDED_HOLD, rbs[0].n)
    out = {}

    # -- A's batch: phase 3's shape (ragged_batch), held and timed in both
    # layouts by _same_shape_times below; its windows are L's queries
    pbA = ragged_batch(rbs[0].codes, rbs[0].lens, k, rng, fastx)
    gA = pa.upload_batch(pbA, dev)
    LA = pbA.Lp
    # -- A on codes: the first n reads, held in both layouts, timed on all
    cn, ln = _code_batch(np, rbs[0].codes, rbs[0].lens, k, rng)
    codes_c, lens_c = _put(torch, np, cn, dev), _put(torch, np, ln, dev)
    for tag, d in (("padded", dp), ("bucketed", db)):
        _hold_codes(torch, pa, anchor, kernels, d, codes_c[:n], lens_c[:n], k,
                    f"{tag} index, B={n} L={cn.shape[1]}")
    ms_cp, ms_cb = _time_layouts(torch, lambda d: kernels.pseudoalign_codes(
        d, codes_c, lens_c, k, min(16, cn.shape[1] - k + 1)), dp, db, 10)
    out["pseudoalign_codes"] = dict(ms_padded=ms_cp, ms_bucketed_5h=ms_cb,
                                    reads_padded=int(cn.shape[0]))
    log(f"kernel A on codes on {cn.shape[0]} reads: padded {ms_cp:.3f} ms, "
        f"bucketed {ms_cb:.3f} ms")
    del codes_c, lens_c
    codes = pa.unpack_codes(gA[0], gA[1], LA)
    canon, _, valid = pa.rolling_canonical_kmers(codes, gA[2], k)
    del codes, gA

    # -- L: A's windows, both layouts
    out["lookup_kmers"] = _hold_l(torch, pa, kernels, dp, db, canon, valid, n)
    del canon, valid

    # -- D and I: phase 3b's and 3d's paired turbo batch, n / 2 pairs
    n2 = n // 2
    dinp = _turbo_inputs(torch, np, _sparse_pairs(np, fastx, rbs, n2, k, rng),
                         n2, dev)
    _hold_d(torch, pa, kernels, dp, dinp, k, f"padded index, {n} reads")
    ms_dp, ms_db = _time_layouts(
        torch, lambda d: _launch_d(kernels, d, dinp, k), dp, db, 10)
    out["pseudoalign_turbo"] = dict(ms_padded=ms_dp, ms_bucketed_5h=ms_db,
                                    reads_padded=n)
    log(f"kernel D on {n} reads: padded {ms_dp:.3f} ms, bucketed "
        f"{ms_db:.3f} ms")
    packed, aux, _, L, rl = dinp
    _hold_i(torch, pa, kernels, dp, packed, aux, k, L, rl,
            f"padded index, {n} reads")
    del dinp, packed, aux
    # D and I at phases 3b/3d's batch shape, both layouts; then the same on
    # an index whose bucketed tables fit in the L2
    t = _same_shape_times(torch, np, pa, kernels, fastx, dp, db, rbs, k, dev,
                          rng, f"{PADDED_GENES}-gene index", pbA)
    out["pseudoalign_side"] = dict(
        ms_padded=t["a_ms_1"], ms_bucketed_5h=t["a_ms_2"],
        bound_ms_padded=t["a_bound_ms_1"], reads_5h=t["a_reads"],
        wave2_share_5h=t["a_wave2_share"])
    log(f"kernel A on {t['a_reads']} reads: padded {t['a_ms_1']:.3f} ms "
        f"(bound {t['a_bound_ms_1']:.4f} ms), bucketed {t['a_ms_2']:.3f} ms, "
        f"wave 2 {t['a_wave2_share']:.4f}")
    del pbA
    for form in ("paired", "single"):
        out["pseudoalign_anchor_" + form] = dict(
            ms_padded=t[f"i_{form}_ms_1"], ms_bucketed_5h=t[f"i_{form}_ms_2"],
            reads_5h=t["reads"] // (1 if form == "paired" else 2),
            wave2_share_5h=t[f"i_{form}_wave2_share"])
    out["pseudoalign_turbo"].update(ms_800g_padded=t["d_ms_1"],
                                    ms_800g_bucketed=t["d_ms_2"],
                                    reads_800g=t["reads"])
    _, dl, dlb, lrbs = _index_set(
        torch, np, pa, fastx, build_index, generate_transcriptome,
        generate_paired, k, work, dev, L2_GENES, rbs[0].n)
    check(dlb.nbytes() < 50e6,
          f"{L2_GENES} genes: bucketed tables of {dlb.nbytes()} bytes, under "
          f"the 50 MB L2 ({type(dl).__name__}: {dl.nbytes()} bytes)")
    out["l2_index"] = _same_shape_times(
        torch, np, pa, kernels, fastx, dl, dlb, lrbs, k, dev, rng,
        f"{L2_GENES}-gene index",
        ragged_batch(lrbs[0].codes, lrbs[0].lens, k, rng, fastx))
    del dl, dlb, lrbs

    # -- J: phase 3e's stress batch, from this transcriptome
    pb = _long_batch(fastx, fasta, os.path.join(work, "lr_3g.fastq.gz"),
                     PADDED_LONG, k)
    args = _hold_j(torch, np, pa, kernels, dp, pb, k, dev,
                   "3g padded index")[4]
    RJ = min(64, pb.Lp - k + 1)
    ms_jp, ms_jb = _time_layouts(torch, lambda d: kernels.pseudoalign_long(
        d, *args, k, pb.Lp, RJ, 128), dp, db, 3)
    out["pseudoalign_long"] = dict(ms_padded=ms_jp, ms_bucketed_5h=ms_jb,
                                   reads_padded=pb.n)
    log(f"kernel J on {pb.n} long reads: padded {ms_jp:.3f} ms, bucketed "
        f"{ms_jb:.3f} ms")
    del args, pb

    # -- K: phase 3f's half-fail slice after the host probe, n pairs
    bs = _sparse_pairs(np, fastx, rbs, n, k, rng)
    _, hk, _, kw = _host_probe(pa, index, bs, k)
    half = np.flatnonzero(hk.fail_side != 3)
    Bp = qp._bucket_size(half.shape[0], lo=qp._W2MIN)
    kargs = _half_slice(torch, np, hk, bs, half, Bp, dev)
    held = _hold_k(torch, np, pa, kernels, dp, kargs, kw,
                   f"3g padded index Bp={Bp}")
    Rr = min(qp._W2ROWS, READ_LEN - k + 1)
    ms_kp, ms_kb = _time_layouts(
        torch, lambda d: kernels.pseudoalign_halffail(
            d, *kargs, k, kw["L"], READ_LEN, Rr), dp, db, 10)
    out["pseudoalign_halffail"] = dict(ms_padded=ms_kp, ms_bucketed_5h=ms_kb,
                                       pairs_padded=int(half.shape[0]))
    log(f"kernel K on {half.shape[0]} half-fail pairs (Bp={Bp}): padded "
        f"{ms_kp:.4f} ms, bucketed {ms_kb:.4f} ms (_hold_k's own time "
        f"{held['pseudoalign_halffail'][0]:.4f} ms)")
    del db
    ctx = dict(index=index, r1p=r1p, r2p=r2p, M=M, S=S, build_s=build_s,
               numpy_build_s=numpy_s, nbytes=dp.nbytes(),
               row_bytes=dp.bucket_rows.numel() * 8)
    return ctx, out


def phase_5h(torch, np, pa, kernels, Options, run_quant, ctx, n_pairs, dev):
    """`quant` of phase 3g's pairs on its padded index, launch counts set
    to 0 just before and read just after (A, B, I, E, F and G launched),
    then the same run with the padded budget set to 0 (the bucketed
    layout): EC counts and sets, FLD and est_counts equal.  Returns the
    summary."""
    index = ctx["index"]
    opt = Options(files=[ctx["r1p"], ctx["r2p"]], plaintext=True)
    runs = {}
    for layout in ("padded", "bucketed"):
        budget = pa._PADDED_BYTES_BUDGET
        if layout == "bucketed":
            pa._PADDED_BYTES_BUDGET = 0
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = run_quant(opt, index=index, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            pa._PADDED_BYTES_BUDGET = budget
        routes = {r: res.timings[r] for r in ROUTES + ("wave2_reads",)}
        log(f"5h {layout}: wall {wall:.2f} s = {n_pairs / wall:,.0f} "
            f"pairs/s, index_upload_s {res.timings['index_upload_s']:.3f}, "
            f"read_s {res.timings['read_s']:.3f}; routes {routes}; launches "
            f"{launches}")
        runs[layout] = (res, wall, launches, routes)
    res, _, launches, routes = runs["padded"]
    for name in PADDED_PATH_KERNELS:
        check(launches[name] > 0,
              f"5h padded: launched {name} ({launches[name]} times)")
    check(routes["turbo"] > 0 and routes["fallback"] == 0
          and launches["pseudoalign_anchor"] == routes["turbo"]
          and launches["pseudoalign_anchor_wave2"] == routes["turbo"],
          f"5h padded: the turbo batches went through kernel I {routes}")
    check(res.num_processed == n_pairs
          and res.num_pseudoaligned > 0.9 * n_pairs,
          f"5h padded: {res.num_pseudoaligned} of {res.num_processed} "
          "pairs pseudoaligned")
    rb = runs["bucketed"][0]
    check(np.array_equal(res.counts, rb.counts)
          and [s.tolist() for s in res.ec_sets]
          == [s.tolist() for s in rb.ec_sets],
          "5h: EC counts and sets equal, padded and bucketed")
    check(np.array_equal(res.fld, rb.fld), "5h: FLD equal")
    check(np.array_equal(res.est_counts, rb.est_counts),
          "5h: est_counts bitwise equal")
    summary = {}
    for layout, (r, wall, _, rts) in runs.items():
        summary[f"padded_5h_{layout}"] = {
            "wall_s": wall, "pairs_per_s": n_pairs / wall,
            "index_upload_s": r.timings["index_upload_s"],
            "read_s": r.timings["read_s"], "routes": rts}
    summary.update(padded_5h_pairs=n_pairs, padded_M=ctx["M"],
                   padded_S=ctx["S"], padded_row_bytes=ctx["row_bytes"],
                   padded_nbytes=ctx["nbytes"],
                   padded_index_build_s=ctx["build_s"],
                   padded_index_numpy_build_s=ctx["numpy_build_s"])
    return summary


def _split_bam(np, payload):
    """(header text, reference dictionary, records) of a decompressed BAM."""
    lt = int.from_bytes(payload[4:8], "little")
    p = 8 + lt
    nref = int.from_bytes(payload[p : p + 4], "little")
    p += 4
    for _ in range(nref):
        p += 4 + int.from_bytes(payload[p : p + 4], "little") + 4
    refs = payload[8 + lt : p]
    recs = []
    while p < len(payload):
        bs = int.from_bytes(payload[p : p + 4], "little")
        recs.append(payload[p + 4 : p + 4 + bs])
        p += 4 + bs
    return payload[8 : 8 + lt], refs, recs


def _self_fields(r):
    """A record but its mate fields (next refid/pos, tlen) and mate flag
    bits (tests/test_pseudobam_golden.py _self_fields)."""
    import struct

    refid, pos, lrn, mapq, bins, ncig, flag, llen = struct.unpack(
        "<iiBBHHHi", r[:20])
    return (refid, pos, mapq, bins, ncig, flag & ~(0x20 | 0x8 | 0x2), llen,
            r[32 : 32 + lrn], r[32 + lrn :])


def _genomebam_checks(np, out, tidx, data):
    """tests/test_genomebam.py's checks on a genome BAM and its BAI."""
    import struct

    from kallisto_tpu_torch.io.bam import read_bam
    from kallisto_tpu_torch.quant.genemodel import Transcriptome

    text, names, lens, recs = read_bam(
        os.path.join(out, "pseudoalignments.bam"))
    chrom = [l.split() for l in open(os.path.join(data, "chrom.txt"))]
    mapped = [r for r in recs if r.refid >= 0]
    keys = [(r.refid << 32) | ((r.pos + 1) << 1) | ((r.flag & 0x10) >> 4)
            for r in mapped]
    check(names == [c[0] for c in chrom]
          and lens == [int(c[1]) for c in chrom]
          and "@HD\tVN:1.0" in text and keys == sorted(keys)
          and all(r.flag & 0x4 for r in recs if r.refid < 0)
          and len(recs) >= 20000,
          f"genomebam: header of chrom.txt, {len(mapped)} mapped records "
          "sorted, the unmapped tail")
    model = Transcriptome(tidx.target_names, tidx.target_lens)
    model.load_chromosomes(os.path.join(data, "chrom.txt"))
    model.parse_gtf(os.path.join(data, "transcripts.gtf.gz"),
                    guess_chromosomes=False)
    exons = {}
    for t in model.transcripts:
        if t.chr >= 0:
            exons.setdefault(t.chr, []).extend(t.exons)
    inside = [any(a <= r.pos < b for a, b in exons[r.refid])
              for r in recs if r.refid >= 0 and not r.flag & 0x4]
    check(all(inside) and len(inside) > 15000,
          f"genomebam: {len(inside)} records start inside an exon")
    spliced = [r for r in recs if any(op == "N" for _, op in r.cigar)]
    check(spliced and all(
        sum(n for n, op in r.cigar if op in "MS") == r.seq_codes.shape[0]
        for r in spliced[:200]),
        f"genomebam: {len(spliced)} spliced CIGARs cover their reads")
    zw = {}
    for r in recs:
        if r.refid >= 0 and not r.flag & 0x4 and r.flag & 0x40:
            v = r.aux_get(b"ZW")
            if v is not None:
                zw[r.qname] = zw.get(r.qname, 0.0) + v
    check(zw and np.allclose(list(zw.values()), 1.0, atol=1e-4),
          f"genomebam: ZW of {len(zw)} reads sum to 1")
    bai = read_bytes(os.path.join(out, "pseudoalignments.bam.bai"))
    (n_ref,) = struct.unpack_from("<i", bai, 4)
    off, chunks = 8, 0
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", bai, off)
        off += 4
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", bai, off)
            off += 8 + 16 * n_chunk
            chunks += n_chunk if b != 37450 else 0
        (n_intv,) = struct.unpack_from("<i", bai, off)
        off += 4 + 8 * n_intv
    (n_no_coor,) = struct.unpack_from("<Q", bai, off)
    check(bai[:4] == b"BAI\x01" and off + 8 == len(bai) and chunks > 0
          and n_no_coor > 0,
          f"genomebam: BAI of {n_ref} references, {chunks} chunks, "
          f"{n_no_coor} unplaced")


def phase_4e(np, kernels, Options, run_quant, tidx, data, golden, work, dev):
    """--pseudobam and --genomebam on tests/data, the card against the
    golden and the CPU, host wave 1 on and off; quant_paired with it on."""
    from kallisto_tpu_torch.io.bam import read_bgzf

    def bam(out):
        return read_bgzf(os.path.join(out, "pseudoalignments.bam"))

    clean = [os.path.join(data, "clean_pb_1.fastq.gz"),
             os.path.join(data, "clean_pb_2.fastq.gz")]
    pf = [os.path.join(data, "reads_1.fastq.gz"),
          os.path.join(data, "reads_2.fastq.gz")]
    gt, gr, ga = _split_bam(np, read_bgzf(os.path.join(
        golden, "pseudobam_clean", "pseudoalignments.bam")))
    runs = {}
    for hw in ("1", "0"):
        os.environ["KALLISTO_TPU_HOST_WAVE1"] = hw
        for tag, files in (("clean", clean), ("reads", pf)):
            for d in ((dev, "cpu") if hw == "1" else (dev,)):
                out = os.path.join(work, f"pb_{tag}_{hw}_{d}")
                res = run_quant(Options(files=files, output_dir=out,
                                        plaintext=True, pseudobam=True),
                                index=tidx, device=d)
                route = "hw1pb" if hw == "1" else "full"
                check(res.timings[route] > 0,
                      f"--pseudobam {tag}, switch {hw}, {d}: {route} batches")
                runs[(tag, hw, str(d))] = bam(out)
        mt, mr, ma = _split_bam(np, runs[("clean", hw, str(dev))])
        fw = [(a, b) for a, b in zip(ga, ma)
              if not int.from_bytes(b[14:16], "little") & 0x14]
        check(gt == mt and gr == mr and len(ga) == len(ma)
              and all(a[32 : 32 + a[8]] == b[32 : 32 + b[8]]
                      for a, b in zip(ga, ma))
              and len(fw) >= 700
              and all(_self_fields(a) == _self_fields(b) for a, b in fw),
              f"pseudobam_clean, switch {hw}: header, references, "
              f"{len(ma)} records in name order, {len(fw)} forward records' "
              "self fields byte-equal to the golden")
    for tag in ("clean", "reads"):
        check(runs[(tag, "1", str(dev))] == runs[(tag, "1", "cpu")]
              == runs[(tag, "0", str(dev))],
              f"--pseudobam {tag}: BAM byte-equal, card (switch on and off) "
              "and CPU")
    os.environ["KALLISTO_TPU_HOST_WAVE1"] = "1"
    gb = dict(files=pf, pseudobam=True, genomebam=True,
              gtf_file=os.path.join(data, "transcripts.gtf.gz"),
              chrom_file=os.path.join(data, "chrom.txt"))
    gouts = {}
    for d in (dev, "cpu"):
        out = os.path.join(work, f"gb_{d}")
        run_quant(Options(output_dir=out, **gb), index=tidx, device=d)
        gouts[str(d)] = (bam(out), read_bytes(
            os.path.join(out, "pseudoalignments.bam.bai")))
    _genomebam_checks(np, os.path.join(work, f"gb_{dev}"), tidx, data)
    check(gouts[str(dev)] == gouts["cpu"],
          "--genomebam: BAM and BAI byte-equal, card and CPU")
    out = os.path.join(work, "golden_paired_hw1")
    res = run_quant(Options(files=pf, output_dir=out, batch_size=4096),
                    index=tidx, device=dev)
    check(read_file(os.path.join(out, "abundance.tsv")) == read_file(
        os.path.join(golden, "quant_paired", "abundance.tsv"))
        and res.timings["hw1pb"] > 0 and res.timings["full"] == 0,
        "quant_paired with host wave 1 on: hw1pb batches, abundance.tsv "
        "byte-equal to the golden")
    os.environ["KALLISTO_TPU_HOST_WAVE1"] = "0"


def phase_5f(torch, np, pa, kernels, Options, run_quant, index, r1p, r2p,
             res5, n_pairs, work, dev):
    """The 1M pairs with host wave 1 on (counts set to 0 just before):
    kernels K, E with slots and F's slim rows launched, EC counts and sets
    equal to phase 5's; then --pseudobam on the first PSEUDOBAM_PAIRS pairs
    with the switch on and off, BAM byte-equal."""
    from kallisto_tpu_torch.io.bam import read_bgzf
    from kallisto_tpu_torch.ops import turbo
    from kallisto_tpu_torch.ops.hostprobe import HostProbe

    # the wave-2 slices as run_quant hands them to kernels K and D, each
    # tagged with its batch's route (a per-read probe is hw1pb's)
    calls, route = [], ["hw1"]
    orig = (HostProbe.probe_pair, turbo.pseudoalign_pair_halffail,
            turbo.pseudoalign_pair_turbo)

    def probe_pair(self, *a, **kw):
        perread = a[3] if len(a) > 3 else kw.get("perread", False)
        route[0] = "hw1pb" if perread else "hw1"
        return orig[0](self, *a, **kw)

    def wrap(kind, fn):
        def f(*a, **kw):
            calls.append((kind, route[0], a, kw))
            return fn(*a, **kw)
        return f

    os.environ["KALLISTO_TPU_HOST_WAVE1"] = "1"
    try:
        HostProbe.probe_pair = probe_pair
        turbo.pseudoalign_pair_halffail = wrap("K", orig[1])
        turbo.pseudoalign_pair_turbo = wrap("D", orig[2])
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = run_quant(Options(files=[r1p, r2p], plaintext=True),
                            index=index, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            (HostProbe.probe_pair, turbo.pseudoalign_pair_halffail,
             turbo.pseudoalign_pair_turbo) = orig
        log(f"launches with host wave 1: {launches}")
        for name in ("pseudoalign_halffail", "key_histogram_slots",
                     "gather_slim", "pseudoalign_turbo", "read_keys",
                     "gather_exemplars", "em_step_batch"):
            check(launches[name] > 0,
                  f"host wave 1 launched {name} ({launches[name]} times)")
        t = res.timings
        check(t["hw1pb"] > 0 and t["hw1"] > 0 and t["full"] == t["turbo"]
              == t["fallback"] == 0,
              f"host wave 1: hw1pb {t['hw1pb']} batches while the FLD is "
              f"learned, then hw1 {t['hw1']}")
        check(np.array_equal(res.counts, res5.counts)
              and [s.tolist() for s in res.ec_sets]
              == [s.tolist() for s in res5.ec_sets]
              and np.array_equal(res.fld, res5.fld),
              "host wave 1: FLD, EC counts and sets equal to phase 5's")
        log(f"quant with host wave 1: wall {wall:.2f} s = "
            f"{n_pairs / wall:,.0f} pairs/s, probe_s {t['probe_s']:.3f}; "
            "host seconds by phase: " + json.dumps(t))
        check([c[0] for c in calls].count("K")
              == launches["pseudoalign_halffail"]
              and [c[0] for c in calls].count("D")
              == launches["pseudoalign_turbo"],
              f"{len(calls)} wave-2 slices captured, one per K or D launch")
        # K, E with slots and F slim held and timed on the first hw1
        # batch's half-fail slice, D + E with slots on its both-failed
        # slice; then K and D timed on every slice of the run
        first = next(i for i, c in enumerate(calls)
                     if c[0] == "K" and c[1] == "hw1")
        _, _, a, kw = calls[first]
        held = _hold_k(torch, np, pa, kernels, a[0], a[1:5], kw,
                       "5f first hw1 batch")
        both = [c for c in calls[first + 1 :] if c[0] == "D"][:1]
        if both:
            _hold_d_slots(torch, pa, kernels, *both[0][2:],
                          "5f first hw1 batch")
        k_ms, d_ms = [], []
        for kind, rt, a, kw in calls:
            didx, L, rl, k = a[0], kw["L"], kw["rl"], kw["k"]
            Rr = min(kw["max_rows"], (rl if 0 < rl < L else L) - k + 1)
            if kind == "K":
                k_ms.append((rt, int(a[1].shape[0]), cuda_ms(
                    lambda: kernels.pseudoalign_halffail(
                        didx, *a[1:5], k, L, rl, Rr), 5, torch)))
            else:
                d_ms.append((rt, int(a[1].shape[0]), cuda_ms(
                    lambda: kernels.pseudoalign_turbo(
                        didx, a[1:3], a[3], None, k, L, rl, Rr), 5, torch)))
        del calls
        log(f"5f per-launch ms (route, Bp, ms): K {k_ms}; D {d_ms}")
        n_pb = min(PSEUDOBAM_PAIRS, n_pairs)
        p1 = os.path.join(work, "pb_1.fastq.gz")
        p2 = os.path.join(work, "pb_2.fastq.gz")
        truncate_fastq(r1p, p1, n_pb)
        truncate_fastq(r2p, p2, n_pb)
        bams, pb_s = {}, {}
        for hw in ("1", "0"):
            os.environ["KALLISTO_TPU_HOST_WAVE1"] = hw
            out = os.path.join(work, f"pb5f_{hw}")
            t0 = time.perf_counter()
            rp = run_quant(Options(files=[p1, p2], output_dir=out,
                                   plaintext=True, pseudobam=True),
                           index=index, device=dev)
            pb_s[hw] = (time.perf_counter() - t0, rp.timings["write_s"])
            bams[hw] = read_bgzf(os.path.join(out, "pseudoalignments.bam"))
            shutil.rmtree(out, ignore_errors=True)
        check(bams["1"] == bams["0"],
              f"--pseudobam on {n_pb} pairs: BAM byte-equal with host wave 1 "
              f"on and off ({len(bams['1'])} bytes decompressed)")
        log(f"--pseudobam on {n_pb} pairs: wall (s, write_s) switch on "
            f"{pb_s['1']}, off {pb_s['0']}")
    finally:
        os.environ["KALLISTO_TPU_HOST_WAVE1"] = "0"
    summary = {"hw1_quant_s": wall, "hw1_pairs_per_s": n_pairs / wall,
               "hw1_probe_s": t["probe_s"], "hw1_phases_s": t,
               "hw1_k_ms": k_ms, "hw1_d_ms": d_ms,
               "pseudobam_pairs": n_pb, "pseudobam_s": pb_s}
    return launches, held, summary


def _hold_d_slots(torch, pa, kernels, a, kw, tag):
    """Kernel D and E with per-read slots on a both-failed slice as
    turbo.pseudoalign_pair_turbo receives it: D's sides, the key table and
    the slots equal to the plain versions on the card."""
    from kallisto_tpu_torch.ops import turbo

    didx, p1, p2, aux = a
    k, L, R, rl = kw["k"], kw["L"], kw["max_rows"], kw["rl"]
    Bp = int(p1.shape[0])
    spec = pa.KeySpec(k, kw.get("min_range", 0), kw.get("strand_key", False),
                      kw.get("pos_fl", -1), kw.get("pos_depth", 0))
    g1, g2, ck, slots = turbo.pseudoalign_pair_turbo(*a, **kw)
    codes, lens_v = turbo.codes_and_lens_plain((p1, p2), aux, None, L, rl)
    c = pa._pseudoalign_core(didx, codes, lens_v, k, R)
    c1 = pa.SideResult(*(x[:Bp] for x in c))
    c2 = pa.SideResult(*(x[Bp:] for x in c))
    del codes, lens_v
    hp, flp = pa.key_hash_plain(c1, c2, spec, didx)
    ckp, slotsp = pa.key_histogram_plain(hp, flp, kw["max_keys"],
                                         with_slots=True)
    torch.cuda.synchronize()
    _equal_sides(torch, pa, g1, c1, f"kernel D mate 1 {tag}")
    _equal_sides(torch, pa, g2, c2, f"kernel D mate 2 {tag}")
    check(torch.equal(ck, ckp) and torch.equal(slots, slotsp),
          f"both-failed slice {tag} (Bp={Bp}): kernel D + E key table "
          "and slots equal to the plain versions")


def phase_4b(np, run_quant, Options, tidx, pf, golden, work, dev):
    """Bootstraps and bias on tests/data, card against CPU."""
    n_bs = 20
    outs = {}
    for where in (dev, "cpu"):
        out = os.path.join(work, f"bs_{where}")
        res = run_quant(Options(files=pf, bootstrap=n_bs, batch_size=10000,
                                plaintext=True, output_dir=out),
                        index=tidx, device=where)
        outs[str(where)] = (res, out)
    (rg, og), (rc, oc) = outs[str(dev)], outs["cpu"]
    mine = rg.bootstraps
    check(mine.shape == (n_bs, tidx.num_trans)
          and np.allclose(mine.sum(axis=1), rg.counts.sum(), rtol=1e-6),
          f"-b {n_bs}: replicates conserve the aligned mass")
    # the distribution checks of tests/test_bootstrap.py against the
    # reference's 20 replicates
    ref = np.stack([est_counts_of(os.path.join(
        golden, "quant_bs", f"bs_abundance_{b}.tsv")) for b in range(n_bs)])
    se = np.maximum(ref.std(axis=0), mine.std(axis=0)) / np.sqrt(n_bs)
    big = ref.mean(axis=0) > 10
    check((np.abs(ref.mean(axis=0) - mine.mean(axis=0))[big]
           < 5 * se[big] + 1.0).all(),
          "-b 20: replicate means agree with tests/golden/quant_bs")
    nz = (ref.std(axis=0) > 1.0) & (mine.std(axis=0) > 1.0)
    ratio = mine.std(axis=0)[nz] / ref.std(axis=0)[nz]
    check(nz.any() and (ratio > 1 / 3).all() and (ratio < 3).all(),
          "-b 20: replicate spreads within 3x of tests/golden/quant_bs")
    check(all(read_file(os.path.join(og, f"bs_abundance_{b}.tsv"))
              == read_file(os.path.join(oc, f"bs_abundance_{b}.tsv"))
              for b in range(n_bs)),
          "-b 20: bs_abundance_{0..19}.tsv byte-equal, card vs CPU")
    check(np.array_equal(rg.bootstraps, rc.bootstraps),
          "-b 20: replicates bitwise equal, card vs CPU")
    from kallisto_tpu_torch.quant import pipeline

    l180 = dict(fld_mean=180, fld_sd=20)
    # the last case cuts the bias goal to 3,000 reads, as the depth test of
    # tests/test_torch_bias.py does, so that batches go turbo after it
    for case, (name, goal, kw) in enumerate((
            ("paired", None, dict(files=pf, batch_size=4096)),
            ("single", None, dict(files=pf[:1], single_end=True,
                                  batch_size=4096, **l180)),
            ("paired -l 180, goal 3000", 3000,
             dict(files=pf, batch_size=1024, **l180)))):
        got = {}
        goal0 = pipeline._BIAS_GOAL
        pipeline._BIAS_GOAL = goal or goal0
        try:
            for where in (dev, "cpu"):
                out = os.path.join(work, f"bias_{case}_{where}")
                res = run_quant(Options(bias=True, plaintext=True,
                                        output_dir=out, **kw),
                                index=tidx, device=where)
                got[str(where)] = (res, read_file(
                    os.path.join(out, "abundance.tsv")))
        finally:
            pipeline._BIAS_GOAL = goal0
        (rg, tg), (rc, tc) = got[str(dev)], got["cpu"]
        check(rg.bias5.sum() > 0 and np.array_equal(rg.bias5, rc.bias5)
              and tg == tc,
              f"--bias {name}: {int(rg.bias5.sum())} hexamers equal and "
              "abundance.tsv byte-equal, card vs CPU")
        if goal:
            check(rg.bias5.sum() >= goal and rg.timings["turbo"] > 0
                  and rc.timings["turbo"] > 0,
                  f"--bias {name}: turbo batches after the goal on the card "
                  f"({rg.timings['turbo']}) and on the CPU "
                  f"({rc.timings['turbo']})")


def phase_6b(torch, np, emq, bsq, kernels, problem, res, dev):
    """Kernel G with replicates on the main path's EM problem.  Returns
    (kernel row fields, summary fields)."""
    seeds = bsq.bootstrap_seeds(42, 8)
    cb = np.stack([bsq.resample_counts(res.counts, s) for s in seeds])
    eg = emq.run_em_batch(problem, cb, res.eff_lens, device=dev)
    ec = emq.run_em_batch(problem, cb, res.eff_lens, device="cpu")
    check(np.array_equal(eg.n_rounds, ec.n_rounds),
          f"8 replicates: rounds equal per replicate ({eg.n_rounds.tolist()})")
    check(np.array_equal(eg.alpha, ec.alpha)
          and np.array_equal(eg.alpha_before_zeroes, ec.alpha_before_zeroes),
          "8 replicates: alpha bitwise equal, card vs CPU")
    err = float(np.max(np.abs(eg.alpha - ec.alpha)))

    n_bs = 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resampled = np.stack([bsq.resample_counts(res.counts, s)
                          for s in bsq.bootstrap_seeds(42, n_bs)])
    t1 = time.perf_counter()
    before = kernels.LAUNCHES["em_step_batch"]
    eb = emq.run_em_batch(problem, resampled, res.eff_lens, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launched = kernels.LAUNCHES["em_step_batch"] - before
    rounds = eb.rounds
    check(rounds == int(eb.n_rounds.max()) + 1
          and g_launches_cover(emq, launched, rounds, 1),
          f"{n_bs} replicates: {rounds} rounds on the card, kernel G "
          f"launched {launched} times (rounds of {emq.EM_CHUNK} per replay)")
    sa_b, mc_b = emq.em_inputs(problem, resampled)
    prob = emq.device_em_problem(problem, sa_b, mc_b, 1.0 / res.eff_lens, dev)
    alpha = torch.from_numpy(eb.alpha_before_zeroes).to(dev)
    # one update at the bootstrap shape with replicates frozen, updating
    # and zeroing (the converged alphas hold values below the zeroing
    # limit), against the plain version on the CPU
    mixed = np.arange(n_bs, dtype=np.int32) % 3
    ng, cg = em_update(np, emq, prob, eb.alpha_before_zeroes, mixed)
    prob_cpu = emq.device_em_problem(problem, sa_b, mc_b, 1.0 / res.eff_lens,
                                     "cpu")
    npl, cpl = emq.em_step_batch_plain(
        torch.from_numpy(eb.alpha_before_zeroes), prob_cpu,
        torch.from_numpy(mixed))
    npl, cpl = npl.numpy(), cpl.numpy()
    n_zeroed = int((eb.alpha_before_zeroes[mixed == 2] < 1e-8).sum())
    check(n_zeroed > 0 and np.array_equal(ng, npl)
          and np.array_equal(cg, cpl),
          f"kernel G, one update of {n_bs} replicates (modes 0/1/2 mixed, "
          f"{n_zeroed} values zeroed): next and change counts bitwise equal "
          "to the plain version on the CPU")
    err = max(err, float(np.abs(ng - npl).max()))
    del ng, cg, npl, cpl, prob_cpu
    mode = torch.ones(n_bs, dtype=torch.int32, device=dev)
    ms = em_chunk_ms(torch, np, emq, prob)
    plain = cuda_ms(lambda: emq.em_step_batch_plain(alpha, prob, mode), 5,
                    torch)
    T, E = problem.num_trans, prob.num_multi
    M = int(prob.flat_tx.shape[0])
    bnd = em_bound(n_bs, T, E, M)
    log(f"kernel G: {ms:.4f} ms per round of {n_bs} replicates over chunks "
        f"of {emq.EM_CHUNK} (plain on card {plain:.3f} "
        f"ms); bootstraps: resampling {t1 - t0:.3f} s, batched EM "
        f"{t2 - t1:.3f} s over {rounds} rounds "
        f"({(t2 - t1) / rounds * 1e3:.4f} ms per round, host wall), "
        f"{eb.host_reads} host reads, replicate rounds "
        f"{int(eb.n_rounds.min())}-{int(eb.n_rounds.max())}; T={T} E={E} "
        f"M={M}")
    summary = {"bs100_resample_s": t1 - t0, "bs100_em_s": t2 - t1,
               "bs100_rounds": rounds,
               "bs100_round_ms": (t2 - t1) / rounds * 1e3,
               "bs100_host_reads": eb.host_reads}
    return (ms, plain, bnd, err, eb.host_reads), summary


def _mesh_side_bytes(torch, pa, didx, up, L, k, side):
    """Kernel A's byte bound terms on one shard's mate (phase 3's
    formula): inputs and outputs once, and the table sectors its anchors,
    wave-2 windows, payloads and block_ec8 rows read, each once
    (_side_bytes on the plain two-wave composition's wave-2 reads).
    Returns (bytes, probes)."""
    from kallisto_tpu_torch.ops import anchor

    packed, nmask, lens = up
    B = int(lens.shape[0])
    fail = anchor.side_waves_plain(didx, packed, nmask, lens, k, L)[1]
    codes = pa.unpack_codes(packed, nmask, L)
    table, n_probe = _side_bytes(torch, pa, didx, codes, lens, fail, k)
    R = int(side.rows.shape[1])
    return (packed.numel() + nmask.numel() + 4 * B + B * (4 * R + 4 * 6 + 3)
            + table, n_probe)


def phase_5g(torch, np, pa, kernels, Options, run_quant, run_bus,
             run_quant_tcc, index, r1p, r2p, bus_r1, bus_out, work, dev, k):
    """Several devices: `quant`, `bus -x 10xv2` and `quant-tcc` over
    N_SHARDS shards on the visible cards (with one card all share it)
    against one device, the dry run, and K18's per-shard step held
    against its plain version and timed.  Returns (K18's row fields,
    summary)."""
    from kallisto_tpu_torch.io.fastx import packed_paired_batches
    from kallisto_tpu_torch.parallel.dryrun import dryrun_multichip
    from kallisto_tpu_torch.parallel.mesh import MeshRunner, make_mesh

    n = N_SHARDS
    devices = make_mesh(n, dev)
    n_cards = len(set(devices))
    log(f"{n} shards on {n_cards} card(s): {[str(d) for d in devices]}"
        + ("; one card is visible, so all four shards share it and run "
           "one after another" if n_cards == 1 else ""))
    summary = {"mesh_shards": n, "mesh_cards": n_cards}

    def sync():
        for d in set(devices):
            torch.cuda.synchronize(d)

    # -- quant: the first MESH_PAIRS pairs, one device and n shards
    q1 = os.path.join(work, "mesh_1.fastq.gz")
    q2 = os.path.join(work, "mesh_2.fastq.gz")
    truncate_fastq(r1p, q1, MESH_PAIRS)
    truncate_fastq(r2p, q2, MESH_PAIRS)
    runs = {}
    for nd in (1, n):
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        r = run_quant(Options(files=[q1, q2], batch_size=MESH_BATCH,
                              n_devices=nd), index=index, device=dev)
        sync()
        runs[nd] = (r, time.perf_counter() - t0, dict(kernels.LAUNCHES))
    (ref, ref_s, _), (got, got_s, launches) = runs[1], runs[n]
    t = got.timings
    log(f"launches of the {n}-shard quant: {launches}")
    for name in ("pseudoalign_side", "read_keys", "key_histogram",
                 "gather_exemplars", "em_step_batch"):
        check(launches[name] > 0, f"{n} shards: {name} launched "
              f"({launches[name]} times)")
    for name in ("pseudoalign_anchor", "pseudoalign_anchor_wave2",
                 "pseudoalign_turbo", "pseudoalign_halffail"):
        check(launches[name] == 0, f"{n} shards: {name} not launched")
    check(t["full"] > 0 and t["cmesh"] > 0 and t["full"] + t["cmesh"]
          == -(-MESH_PAIRS // MESH_BATCH) and t["fallback"] == 0,
          f"{n} shards: per read while the FLD is learned, then cmesh "
          f"(full {t['full']}, cmesh {t['cmesh']})")
    check(launches["key_histogram"] == n * t["cmesh"]
          and launches["pseudoalign_side"] == 2 * n * (t["full"]
                                                      + t["cmesh"]),
          f"{n} shards: kernel E once per shard of every cmesh batch, A "
          "once per shard and mate of every batch")
    check(got.num_processed == ref.num_processed == MESH_PAIRS
          and np.array_equal(got.counts, ref.counts)
          and [x.tolist() for x in got.ec_sets]
          == [x.tolist() for x in ref.ec_sets],
          f"{n} shards: {len(got.ec_sets)} EC sets and their counts equal "
          "to one device")
    check(np.array_equal(got.est_counts, ref.est_counts)
          and np.array_equal(got.flens, ref.flens)
          and np.array_equal(got.fld, ref.fld),
          f"{n} shards: est_counts bitwise and the FLD equal to one device")
    log(f"quant of {MESH_PAIRS} pairs: one device {ref_s:.2f} s, {n} shards "
        f"{got_s:.2f} s; host seconds by phase: " + json.dumps(t))
    summary.update(mesh_quant_s=got_s, mesh_quant_one_device_s=ref_s,
                   mesh_quant_phases_s=t, mesh_quant_launches=launches)

    # -- bus -x 10xv2: the first MESH_PAIRS reads of phase 5c
    b1 = os.path.join(work, "mesh_bus_1.fastq.gz")
    b2 = os.path.join(work, "mesh_bus_2.fastq.gz")
    truncate_fastq(bus_r1, b1, MESH_PAIRS)
    truncate_fastq(r1p, b2, MESH_PAIRS)
    outs = {}
    for nd in (1, n):
        out = os.path.join(work, f"mesh_bus_{nd}")
        t0 = time.perf_counter()
        rb = run_bus(Options(files=[b1, b2], technology="10xv2",
                             output_dir=out, n_devices=nd),
                     index=index, device=dev)
        outs[nd] = (out, time.perf_counter() - t0, rb.timings)
    check(outs[n][2]["anchor"] == 0 and outs[n][2]["full"] > 0,
          f"bus over {n} shards: every chunk per read "
          f"({outs[n][2]['full']})")
    for fn in ("output.bus", "matrix.ec"):
        check(read_bytes(os.path.join(outs[1][0], fn))
              == read_bytes(os.path.join(outs[n][0], fn)),
              f"bus over {n} shards: {fn} byte-equal to one device")
    summary.update(mesh_bus_s=outs[n][1], mesh_bus_one_device_s=outs[1][1])

    # -- quant-tcc: the first MESH_CELLS cells of phase 5e's matrix
    with open(os.path.join(work, "cells.mtx")) as f:
        head = [f.readline(), f.readline()]
        ents = [ln for ln in f if int(ln.split("\t", 1)[0]) <= MESH_CELLS]
    sub = os.path.join(work, "mesh_cells.mtx")
    n_ec = int(head[1].split("\t")[1])
    with open(sub, "w") as f:
        f.write(head[0] + f"{MESH_CELLS}\t{n_ec}\t{len(ents)}\n")
        f.write("".join(ents))
    ec_file = os.path.join(bus_out, "matrix.ec")
    tccs = {}
    for nd in (1, n):
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rt = run_quant_tcc(Options(ec_file=ec_file, tcc_file=sub,
                                   n_devices=nd), index=index, device=dev)
        sync()
        tccs[nd] = (rt, time.perf_counter() - t0, dict(kernels.LAUNCHES))
    check(tccs[n][2]["em_step_batch"] > 0
          and np.array_equal(tccs[n][0].est_counts, tccs[1][0].est_counts),
          f"quant-tcc of {MESH_CELLS} cells over {n} shards: kernel G "
          f"launched ({tccs[n][2]['em_step_batch']} times), est_counts "
          "bitwise equal to one device")
    log(f"quant-tcc of {MESH_CELLS} cells: one device {tccs[1][1]:.2f} s, "
        f"{n} shards {tccs[n][1]:.2f} s")
    summary.update(mesh_tcc_s=tccs[n][1], mesh_tcc_one_device_s=tccs[1][1])

    # -- the dry run on the card
    routes = dryrun_multichip(n, dev)
    check(routes["fld"]["full"] > 0 and routes["l180"]["cmesh"] > 0,
          f"dryrun_multichip({n}, {dev}): equal counts, EC order and "
          f"est_counts, routes {routes}")

    # -- K18: A + E per shard, held against the plain versions on every
    # shard and one shard timed, at two batches: MESH_BATCH (the shape of
    # the sharded quant above) and MESH_PAIRS in one batch (the CLI's
    # default --batch-size over four shards); the whole step beside it
    mesh = MeshRunner(devices)
    mesh.replicate(index)
    spec0 = pa.KeySpec(k=k)
    step_names = ("pseudoalign_side", "pseudoalign_side_wave2",
                  "key_histogram")

    def hold_k18(pb1, pb2):
        up1, sb = mesh.put_batch(pb1)
        up2, _ = mesh.put_batch(pb2)
        L = pb1.Lp

        def plain_step(s):
            d = mesh.didxs[s]
            p1 = pa.pseudoalign_batch_packed_plain(d, *up1[s], k, L)
            p2 = pa.pseudoalign_batch_packed_plain(d, *up2[s], k, L)
            h, fl = pa.key_hash_plain(p1, p2, spec0, d)
            return p1, p2, pa.key_histogram_plain(h, fl, sb + 1)

        # the launches of one sharded batch, counted by the wrappers
        sync()
        kernels.reset_launches()
        r1s, r2s, cks, sb2 = mesh.pair_compact(pb1, pb2, k)
        sync()
        per_batch = sum(kernels.LAUNCHES[nm] for nm in step_names)
        check(sb2 == sb == -(-pb1.n // n), f"shard shape {sb} pairs")
        check(per_batch == 5 * n and kernels.LAUNCHES["read_keys"] == 0,
              f"K18 at {sb} pairs per shard: {per_batch} launches per batch "
              f"(A's two waves on both mates and E with the keys fused, per "
              f"shard)")
        for s in range(n):
            p1, p2, pck = plain_step(s)
            torch.cuda.synchronize(devices[s])
            check(all(torch.equal(getattr(a, f), getattr(b, f))
                      for a, b in ((r1s[s], p1), (r2s[s], p2))
                      for f in pa.SideResult._fields)
                  and torch.equal(cks[s], pck),
                  f"K18 shard {s} of {sb} pairs on {devices[s]}: both mates' "
                  f"fields and the key table (n_uniq {int(cks[s][0, 0])}) "
                  "equal to the plain versions")
        d0 = mesh.didxs[0]
        kw = dict(k=k, L=L, max_keys=sb + 1)
        with torch.cuda.device(devices[0]):
            ms = cuda_ms(lambda: pa.pseudoalign_pair_compact_packed(
                d0, *up1[0], *up2[0], **kw), 10, torch)
            dev_ms = graph_ms(lambda: pa.pseudoalign_pair_compact_packed(
                d0, *up1[0], *up2[0], **kw), 10, torch)
            plain = cuda_ms(lambda: plain_step(0), 3, torch)
        R = int(r1s[0].rows.shape[1])
        (b1, p1n), (b2, p2n) = (
            _mesh_side_bytes(torch, pa, d0, u[0], L, k, r[0])
            for u, r in ((up1, r1s), (up2, r2s)))
        # A's bytes on both mates, then E's: the compact key's columns (the
        # SideResults A wrote) read once and the table written once
        nbytes = b1 + b2 + sb * (4 * 2 * R + 4) + 40 * (sb + 2)
        bnd = bound(nbytes, 250 * (p1n + p2n), PEAK_INT_OPS)
        log(f"K18: one shard's A + E {ms:.4f} ms at {sb} pairs, device (L2-warm) "
            f"{dev_ms:.4f} ms (plain on card {plain:.3f} ms, bound "
            f"{bnd[0]:.4f} ms), {per_batch} launches per batch")
        return ms, plain, bnd, per_batch, sb, dev_ms

    pb1, pb2 = next(packed_paired_batches(q1, q2, MESH_BATCH, k))
    ms, plain, bnd, per_batch, sb, dev_ms = hold_k18(pb1, pb2)
    walls = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        mesh.pair_compact(pb1, pb2, k)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(walls)
    log(f"K18: the {n}-shard step of {MESH_BATCH} pairs with its uploads "
        f"{step_ms:.3f} ms (median of 5 host walls: "
        f"{', '.join(f'{w:.3f}' for w in walls)})")
    db1, db2 = next(packed_paired_batches(q1, q2, MESH_PAIRS, k))
    ms_d, plain_d, bnd_d, per_batch_d, sb_d, dev_ms_d = hold_k18(db1, db2)
    row = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
               device_ms=dev_ms, device_ms_default_batch=dev_ms_d,
               launches=launches["key_histogram"], step_ms=step_ms,
               shard_pairs=sb, shards=n, cards=n_cards,
               kernel_launches_per_batch=per_batch,
               ms_default_batch=ms_d, plain_ms_default_batch=plain_d,
               bound_ms_default_batch=bnd_d[0],
               shard_pairs_default_batch=sb_d,
               kernel_launches_per_default_batch=per_batch_d)
    summary.update(mesh_k18_ms=ms, mesh_step_ms=step_ms,
                   mesh_k18_ms_default_batch=ms_d)
    del mesh
    return row, summary


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genes", type=int, default=N_GENES,
                    help="genes of the simulated transcriptome")
    ap.add_argument("--pairs", type=int, default=N_PAIRS,
                    help="simulated read pairs for the main path")
    args = ap.parse_args(argv)
    n_genes, n_pairs = args.genes, args.pairs
    n_sub = min(CPU_RERUN_PAIRS, n_pairs)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np

    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.index import build_index
    from kallisto_tpu_torch.io import fastx
    from kallisto_tpu_torch.ops import anchor
    from kallisto_tpu_torch.ops import kernels
    from kallisto_tpu_torch.ops import pseudoalign as pa
    from kallisto_tpu_torch.quant import bootstrap as bsq
    from kallisto_tpu_torch.quant import em as emq
    from kallisto_tpu_torch.quant.pipeline import run_quant
    from kallisto_tpu_torch.quant.tcc import run_quant_tcc
    from kallisto_tpu_torch.sc.bus import run_bus
    from kallisto_tpu_torch.utils.benchdata import generate_paired
    from kallisto_tpu_torch.utils.simtx import generate_transcriptome

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    k = 31
    # the earlier phases hold the card's own routes (host wave 1 off);
    # phases 4e and 5f turn it on
    os.environ["KALLISTO_TPU_HOST_WAVE1"] = "0"

    # ---------------------------------------------------------- 1. device
    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    build_s = kernels.build_all()
    log(f"kernel build: {build_s:.2f} s (one nvcc per source, in parallel)")

    work = tempfile.mkdtemp(prefix="kt_smoke_")
    try:
        # ------------------------------------------------ 2. set-up
        log("== phase 2: realistic-size set-up")
        fasta = os.path.join(work, "simtx.fasta.gz")
        t0 = time.perf_counter()
        n_tx = generate_transcriptome(fasta, n_genes=n_genes, seed=42)
        log(f"transcriptome: {n_tx} targets, "
            f"{time.perf_counter() - t0:.1f} s")
        index, index_build_s, calls = build_timed(build_index, fasta, k, True)
        log(f"index build (native helpers, {min(8, os.cpu_count() or 1)} "
            f"threads): {index_build_s:.1f} s, {index.num_kmers} k-mers, "
            f"{index.num_trans} targets; helper calls {calls}")
        t0 = time.perf_counter()
        didx = pa.device_index_from_host(index, dev, with_pos_tables=True)
        torch.cuda.synchronize()
        log(f"device tables: {didx.nbytes() / 1e9:.3f} GB, p={didx.p}, layout + "
            f"upload {time.perf_counter() - t0:.1f} s")
        r1p = os.path.join(work, "sim_1.fastq.gz")
        r2p = os.path.join(work, "sim_2.fastq.gz")
        t0 = time.perf_counter()
        generate_paired(fasta, r1p, r2p, n_pairs, read_len=READ_LEN,
                        frag_mean=180.0, frag_sd=20.0, error_rate=0.005)
        log(f"reads: {n_pairs} pairs 2x{READ_LEN}, "
            f"{time.perf_counter() - t0:.1f} s")

        # ----------------------------------------- 2b. the two readers
        log("== phase 2b: the native reader against the Python reader")
        reader_summary = phase_2b(np, fastx, r1p, r2p, Options().batch_size,
                                  k)

        # ------------------------------------------ 3. kernels A and B
        log("== phase 3: kernels A and B against their plain versions")
        rng = np.random.default_rng(1234)
        rbs = []
        for path in (r1p, r2p):
            fs = fastx.FastqStream(path)
            rbs.append(fs.next_batch(Options().batch_size))
            fs.close()
        rb1, rb2 = rbs
        B = rb1.n
        pb1 = ragged_batch(rb1.codes, rb1.lens, k, rng, fastx)
        pb2 = ragged_batch(rb2.codes, rb2.lens, k, rng, fastx)
        c76 = rb1.codes[:, :76]
        pb76 = ragged_batch(c76, np.full(B, 76, np.int32), k, rng, fastx)
        didx_cpu = pa.device_index_from_host(index, "cpu")
        side_gpu = {}
        side_cpu = {}
        stats_a = {}
        for tag, pb in (("m1", pb1), ("m2", pb2), ("r76", pb76)):
            g_in = pa.upload_batch(pb, dev)
            c_in = pa.upload_batch(pb, "cpu")
            sg = pa.pseudoalign_batch_packed(didx, *g_in, k=k, L=pb.Lp)
            torch.cuda.synchronize()
            sc = pa.pseudoalign_batch_packed(didx_cpu, *c_in, k=k, L=pb.Lp)
            for f in pa.SideResult._fields:
                a = getattr(sg, f).cpu()
                b = getattr(sc, f)
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"kernel A {tag} Lp={pb.Lp}: {f} equal")
            side_gpu[tag], side_cpu[tag] = sg, sc
            # its wave-2 list against the plain two-wave composition, and
            # this input's data-dependent work, for the bound
            fail = _hold_a(torch, pa, anchor, kernels, didx, g_in, pb.Lp, k,
                           f"{tag} Lp={pb.Lp}")
            codes = pa.unpack_codes(g_in[0], g_in[1], pb.Lp)
            stats_a[tag] = (g_in, fail, *_side_bytes(torch, pa, didx, codes,
                                                     g_in[2], fail, k))
            del codes
        # kernel B: paired on (m1, m2), single-end on r76
        for tag, s1, s2, c1, c2 in (
            ("paired", side_gpu["m1"], side_gpu["m2"], side_cpu["m1"],
             side_cpu["m2"]),
            ("single", side_gpu["r76"], None, side_cpu["r76"], None),
        ):
            hg, tg, _ = pa.read_keys(s1, s2, k)
            torch.cuda.synchronize()
            hc, tc, _ = pa.read_keys(c1, c2, k)
            check(torch.equal(hg.cpu(), hc), f"kernel B {tag}: keys equal")
            if s2 is not None:
                check(torch.equal(tg.cpu(), tc),
                      f"kernel B {tag}: fragment lengths equal")

        # timings at the main path's shape (mate 1, 2x100 bp batch)
        g_in, fail_a, table_bytes, n_probe = stats_a["m1"]
        R = min(16, pb1.Lp - k + 1)
        ms_a = cuda_ms(lambda: kernels.pseudoalign_side(
            didx, *g_in, k, pb1.Lp, R), 10, torch)
        plain_a = cuda_ms(lambda: pa.pseudoalign_batch_packed_plain(
            didx, *g_in, k=k, L=pb1.Lp), 3, torch)
        in_bytes = pb1.packed.nbytes + pb1.nmask.nbytes + 4 * B
        out_bytes = B * (4 * R + 4 * 6 + 3)
        # table_bytes: the sectors its anchors, wave-2 windows, payloads
        # and block_ec8 rows read, each once (_side_bytes)
        ops_a = 250 * n_probe
        bound_a = bound(in_bytes + out_bytes + table_bytes, ops_a, PEAK_INT_OPS)
        k3a_w2 = _time_side_waves(torch, pa, kernels, didx, g_in, pb1.Lp, k,
                                  fail_a)
        s1g, s2g = side_gpu["m1"], side_gpu["m2"]
        ms_b = cuda_ms(lambda: kernels.read_keys(s1g, s2g, k), 20, torch)
        plain_b = cuda_ms(lambda: pa.read_keys_plain(s1g, s2g, k), 5, torch)
        R2 = int(s2g.rows.shape[1])
        bytes_b = B * (4 * (R + R2) + 2 * (2 + 13) + 16 + 4)
        bound_b = bound(bytes_b, B * (R + R2 + 1) * 8, PEAK_INT_OPS)
        dev_b = graph_ms(lambda: kernels.read_keys(s1g, s2g, k), 20, torch)
        log(f"kernel A: {ms_a:.3f} ms (plain on card {plain_a:.3f} ms, "
            f"bound {bound_a[0]:.4f} ms), B={B} Lp={pb1.Lp}, "
            f"{n_probe} probes, wave 2 {k3a_w2['reads']} reads "
            f"({k3a_w2['wave2_share']:.4f})")
        log(f"kernel B: {ms_b:.4f} ms, device (L2-warm) {dev_b:.4f} ms (plain on card "
            f"{plain_b:.3f} ms, bound {bound_b[0]:.4f} ms)")
        k3codes, k3codes_w2 = phase_3_codes(torch, np, pa, anchor, kernels,
                                            didx, rb1, k, dev, rng)

        # L, the probe alone, on this index (bucketed, 1.1 GB) and phase 3's
        # A windows (mate 1's batch), through its packed entries: held
        # and timed
        codes = pa.unpack_codes(g_in[0], g_in[1], pb1.Lp)
        canon, _, lvalid = pa.rolling_canonical_kmers(codes, g_in[2], k)
        del codes
        k3l = _l_phase2(torch, pa, kernels, didx, canon, lvalid)
        del canon, lvalid

        # ------------------------------------------------- 3c. kernel H
        log(f"== phase 3c: kernel H, B's epilogue, against its plain "
            f"version ({time.perf_counter() - t_start:.0f} s)")
        bt = pa.bias_tables_from_host(index, dev)
        for tag, s1, s2 in (("paired", s1g, s2g),
                            ("single", side_gpu["r76"], None)):
            got = kernels.read_keys(s1, s2, k, bias=bt)
            alone = kernels.read_keys(s1, s2, k)
            hp, tp = pa.read_keys_plain(s1, s2, k)
            hv = s2.has_hits if s2 is not None else torch.ones_like(
                s1.has_hits)
            xp = pa.bias_hexamers_plain(bt, s1, hv, k)
            torch.cuda.synchronize()
            check(torch.equal(got[0], alone[0]) and torch.equal(got[0], hp)
                  and (s2 is None or (torch.equal(got[1], alone[1])
                                      and torch.equal(got[1], tp))),
                  f"kernel B + H {tag}: keys and fragment lengths equal to B "
                  "alone and to the plain version")
            check(torch.equal(got[2], xp),
                  f"kernel B + H {tag}: {xp.shape[0]} hexamer ids equal "
                  f"({int((xp >= 0).sum())} reads with one)")
        valid = s2g.has_hits
        check(torch.equal(pa.bias_hexamers(bt, s1g, valid, k),
                          pa.bias_hexamers_plain(bt, s1g, valid, k)),
              "bias_hexamers (the fused launch) equal to the plain version")
        # B alone and B + H in turns (B, B + H, B + H, B), from the host
        # and as device time
        t_b, t_bh = [], []
        for fn_list in ((t_b, None), (t_bh, bt), (t_bh, bt), (t_b, None)):
            lst, bb = fn_list
            lst.append((cuda_ms(lambda: kernels.read_keys(
                s1g, s2g, k, bias=bb), 20, torch), graph_ms(
                lambda: kernels.read_keys(s1g, s2g, k, bias=bb), 20, torch)))
        ms_b3c = statistics.median(x[0] for x in t_b)
        dev_b3c = statistics.median(x[1] for x in t_b)
        ms_bh = statistics.median(x[0] for x in t_bh)
        dev_bh = statistics.median(x[1] for x in t_bh)
        plain_h = cuda_ms(lambda: pa.bias_hexamers_plain(bt, s1g, valid, k),
                          5, torch)
        # H taken alone: per read four int32 and three bool fields in, one
        # int32 out; per read with a hit and a valid mate one sector each
        # of block_start, block_end, unitig_seq_off and unitig_seq.  B + H
        # in one launch: B's bytes (which already hold mate 1's block,
        # upos, rpos, strand and has_hits and mate 2's has_hits, H's
        # valid), mate 1's f_uid and hx out, and the same four sectors a
        # read whose two mates hit; B's operations
        n_ok = int((s1g.has_hits & valid).sum())
        bound_h = bound(B * (4 * 4 + 3 + 4) + 32 * 4 * n_ok, 0, PEAK_INT_OPS)
        bound_bh = bound(bytes_b + B * (4 + 4) + 32 * 4 * n_ok,
                         B * (R + R2 + 1) * 8, PEAK_INT_OPS)
        log(f"kernel B + H (one launch): {ms_bh:.4f} ms, device (L2-warm) "
            f"{dev_bh:.4f} ms; B alone {ms_b3c:.4f} ms, device {dev_b3c:.4f}"
            f" ms (plain H on card {plain_h:.3f} ms); bound B + H "
            f"{bound_bh[0]:.4f} ms (H alone {bound_h[0]:.4f}), B={B}, "
            f"{n_ok} reads with hits on both mates")
        del side_gpu, side_cpu, stats_a, g_in, didx_cpu, valid, bt

        # ---------------------------- 3b. kernels D, E, F and B extended
        log("== phase 3b: kernels D, E, F and B (compact keys) against "
            "their plain versions on the card")
        k3b = phase_3b(torch, np, pa, kernels, fastx, index, didx, rb1, rb2,
                       k, dev)

        # ---------------------------------------------- 3d. kernel I
        log(f"== phase 3d: kernel I against its plain version and kernel D "
            f"on the card ({time.perf_counter() - t_start:.0f} s)")
        k3d, ms_b_single = phase_3d(torch, np, pa, kernels, fastx, didx,
                                    rb1, rb2, k, dev)
        del rb1, rb2

        # ---------------------------------------------- 3e. kernel J
        log(f"== phase 3e: kernel J against its plain version on the card "
            f"({time.perf_counter() - t_start:.0f} s)")
        k3e = phase_3e(torch, np, pa, kernels, fastx, fasta, didx, k, work,
                       dev)

        # ------------------------------------ 3f. kernels K, E slots, F slim
        log(f"== phase 3f: kernels K, E with slots and F slim against their "
            f"plain versions on the card ({time.perf_counter() - t_start:.0f}"
            " s)")
        k3f, probe_summary = phase_3f(torch, np, pa, kernels, fastx, index,
                                      didx, r1p, r2p, k, dev,
                                      Options().batch_size)

        # ------------------------------ 3g. the padded index layout
        log(f"== phase 3g: kernels A, D, I, J, K and L on the padded index "
            f"layout ({time.perf_counter() - t_start:.0f} s)")
        padded_ctx, k3g = phase_3g(
            torch, np, pa, kernels, fastx, build_index,
            generate_transcriptome, generate_paired, k, work, dev,
            PADDED_PAIRS, Options().batch_size)

        # ------------------------------------------------ 4. golden bytes
        log("== phase 4: golden bytes on the card")
        data = os.path.join(here, "tests", "data")
        golden = os.path.join(here, "tests", "golden")
        tidx = build_index([os.path.join(data, "transcripts.fasta.gz")], k=k)
        pf = [os.path.join(data, "reads_1.fastq.gz"),
              os.path.join(data, "reads_2.fastq.gz")]
        # phases 4-4e run on the padded layout (tests/data's indexes are
        # small): each asserts the layout of the indexes its runs place
        with _padded_runs(pa, "phase 4"):
            for name, gdir, kw in (
                ("paired", "quant_paired", dict(files=pf)),
                ("single", "quant_single", dict(
                    files=pf[:1], single_end=True, fld_mean=180, fld_sd=20)),
                ("halfmapped", "quant_halfmapped", dict(
                    files=[pf[0], os.path.join(data, "halfmapped_2.fastq.gz")],
                    fld_mean=180, fld_sd=20)),
            ):
                out = os.path.join(work, f"golden_{name}")
                res = run_quant(Options(output_dir=out, batch_size=4096, **kw),
                                index=tidx, device=dev)
                mine = open(os.path.join(out, "abundance.tsv")).read()
                want = open(os.path.join(golden, gdir, "abundance.tsv")).read()
                check(mine == want, f"{name}: abundance.tsv byte-equal to {gdir}")
                routes = {r: res.timings[r] for r in ROUTES}
                if name == "paired":
                    check((res.num_processed, res.num_pseudoaligned,
                           res.num_unique) == (10000, 9413, 7174),
                          "paired run stats 10000 / 9413 / 7174")
                    check(routes["full"] > 0 and routes["turbo"] == 0
                          and routes["compact"] == routes["fallback"] == 0,
                          f"{name}: per-read batches only {routes}")
                else:
                    check(routes["turbo"] > 0 and routes["fallback"] == 0
                          and routes["full"] == 0,
                          f"{name}: turbo batches, no fallback {routes}")

        log(f"== phase 4b: bootstraps and bias, card against CPU "
            f"({time.perf_counter() - t_start:.0f} s)")
        with _padded_runs(pa, "phase 4b"):
            phase_4b(np, run_quant, Options, tidx, pf, golden, work, dev)

        log(f"== phase 4c: bus goldens on the card "
            f"({time.perf_counter() - t_start:.0f} s)")
        with _padded_runs(pa, "phase 4c"):
            bus_golden_routes = phase_4c(Options, build_index, run_bus,
                                         tidx, data, golden, work, dev)

        log(f"== phase 4d: long-read and TCC goldens on the card "
            f"({time.perf_counter() - t_start:.0f} s)")
        with _padded_runs(pa, "phase 4d"):
            phase_4d(np, kernels, Options, run_quant, run_bus, run_quant_tcc,
                     tidx, data, golden, work, dev)

        log(f"== phase 4e: --pseudobam and --genomebam on the card "
            f"({time.perf_counter() - t_start:.0f} s)")
        with _padded_runs(pa, "phase 4e"):
            phase_4e(np, kernels, Options, run_quant, tidx, data, golden,
                     work, dev)

        # -------------------------------------- 5. main path, full size
        log(f"== phase 5: main path at realistic size "
            f"({time.perf_counter() - t_start:.0f} s)")
        torch.cuda.synchronize()
        kernels.reset_launches()
        with _side_lists(kernels) as a_lists:
            t0 = time.perf_counter()
            res = run_quant(Options(files=[r1p, r2p], plaintext=True),
                            index=index, device=dev)
            torch.cuda.synchronize()
            quant_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        log(f"launches on the main path: {launches}")
        for name in MAIN_PATH_KERNELS:
            check(launches[name] > 0,
                  f"main path launched {name} ({launches[name]} times)")
        check(res.num_processed == n_pairs,
              f"num_processed {res.num_processed} == {n_pairs}")
        share = res.num_pseudoaligned / res.num_processed
        check(share > 0.90, f"aligned share {share:.4f} > 0.90")
        tot = float(res.est_counts.sum())
        check(np.isfinite(res.est_counts).all()
              and abs(tot - res.num_pseudoaligned)
              <= 1e-6 * res.num_pseudoaligned,
              f"est_counts sum {tot:.3f} within 1e-6 of "
              f"{res.num_pseudoaligned}")
        routes = {r: res.timings[r] for r in ROUTES + ("wave2_reads",)}
        check(routes["turbo"] > 0 and routes["full"] > 0
              and routes["fallback"] == 0,
              f"main path: FLD batches per read, then turbo {routes}")
        check(launches["pseudoalign_anchor"] == routes["turbo"]
              and launches["pseudoalign_anchor_wave2"] == routes["turbo"]
              and launches["pseudoalign_turbo"] == 0,
              f"main path: the turbo batches went through kernel I "
              f"({launches['pseudoalign_anchor']} launches, "
              f"{routes['wave2_reads']} reads in wave 2), none through D")
        check(launches["key_histogram"] == routes["turbo"]
              and launches["read_keys"] == routes["full"],
              f"main path: one C call for the key step of each turbo batch "
              f"(kernel E with the keys fused, {launches['key_histogram']} "
              f"launches), kernel B only on the per-read batches "
              f"({launches['read_keys']})")
        _check_side_lists(a_lists, launches, "main path")
        n_uniq_mean = res.timings["n_uniq_sum"] / max(routes["turbo"], 1)
        log(f"quant wall {quant_s:.2f} s = {n_pairs / quant_s:,.0f} pairs/s, "
            f"read_s {res.timings['read_s']:.3f} (native reader), "
            f"EM {res.em.n_rounds} rounds; routes {routes}, n_uniq max "
            f"{res.timings['n_uniq_max']} mean {n_uniq_mean:.1f} per turbo "
            "batch; host seconds by phase: " + json.dumps(res.timings))

        # the same pairs with every batch per read
        os.environ["KALLISTO_TPU_FLEN_GOAL"] = str(10 * n_pairs)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rfull = run_quant(Options(files=[r1p, r2p], plaintext=True),
                              index=index, device=dev)
            torch.cuda.synchronize()
            full_s = time.perf_counter() - t0
        finally:
            del os.environ["KALLISTO_TPU_FLEN_GOAL"]
        check(rfull.timings["turbo"] == 0,
              "per-read rerun: no turbo batch")
        check(np.array_equal(res.counts, rfull.counts)
              and [s.tolist() for s in res.ec_sets]
              == [s.tolist() for s in rfull.ec_sets],
              "main path: EC counts and sets equal to the all-per-read run")
        log(f"all-per-read run: {full_s:.2f} s = {n_pairs / full_s:,.0f} "
            "pairs/s; host seconds by phase: " + json.dumps(rfull.timings))

        sub1 = os.path.join(work, "sub_1.fastq.gz")
        sub2 = os.path.join(work, "sub_2.fastq.gz")
        # kernel D's path: mate 1 of mixed lengths, so that the turbo
        # batches take kernel D
        truncate_fastq(r1p, sub1, n_sub, ragged=True)
        truncate_fastq(r2p, sub2, n_sub)
        os.environ["KALLISTO_TPU_FLEN_GOAL"] = "1000"
        try:
            sub_opt = Options(files=[sub1, sub2], batch_size=8192)
            torch.cuda.synchronize()
            kernels.reset_launches()
            rg = run_quant(sub_opt, index=index, device=dev)
            torch.cuda.synchronize()
            launches_d = dict(kernels.LAUNCHES)
            rc = run_quant(sub_opt, index=index, device="cpu")
        finally:
            del os.environ["KALLISTO_TPU_FLEN_GOAL"]
        log(f"launches on mixed-length pairs: {launches_d}")
        check(rg.timings["turbo"] > 0 and rc.timings["turbo"] > 0,
              f"first {n_sub} pairs: turbo batches on the card "
              f"({rg.timings['turbo']}) and on the CPU ({rc.timings['turbo']})")
        check(launches_d["pseudoalign_turbo"] == rg.timings["turbo"]
              and launches_d["pseudoalign_anchor"] == 0
              and launches_d["pseudoalign_anchor_wave2"] == 0,
              f"first {n_sub} pairs, mixed lengths: the turbo batches went "
              f"through kernel D ({launches_d['pseudoalign_turbo']} "
              "launches), none through I")
        check(np.array_equal(rg.counts, rc.counts)
              and [s.tolist() for s in rg.ec_sets]
              == [s.tolist() for s in rc.ec_sets],
              f"first {n_sub} pairs: EC counts and sets equal, card vs CPU")
        del rg, rc

        # ------------------------- 5i. the profiler and timing hooks
        log(f"== phase 5i: quant with KALLISTO_TPU_PROFILE and "
            f"KALLISTO_TPU_TIMING ({time.perf_counter() - t_start:.0f} s)")
        prof_summary = phase_5i(torch, np, Options, run_quant, index, r1p,
                                r2p, work, dev, PROFILE_PAIRS)

        # ------------------------------- 5b. --bias -b 100, full size
        log(f"== phase 5b: quant --bias -b 100 at realistic size "
            f"({time.perf_counter() - t_start:.0f} s)")
        n_bs = 100
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rbias = run_quant(Options(files=[r1p, r2p], bias=True,
                                  bootstrap=n_bs, plaintext=True,
                                  output_dir=os.path.join(work, "bias_bs")),
                          index=index, device=dev)
        torch.cuda.synchronize()
        bias_quant_s = time.perf_counter() - t0
        launches_b = dict(kernels.LAUNCHES)
        log(f"launches on the --bias -b {n_bs} path: {launches_b}")
        for name in ("bias_hexamers", "em_step_batch", "pseudoalign_side",
                     "read_keys"):
            check(launches_b[name] > 0,
                  f"--bias -b {n_bs} launched {name} ({launches_b[name]} "
                  "times)")
        n_al = rbias.num_pseudoaligned
        check(rbias.bias5.sum() > 0,
              f"{int(rbias.bias5.sum())} hexamers counted")
        check(not np.allclose(rbias.eff_lens, res.eff_lens),
              "bias-corrected effective lengths differ from phase 5's")
        check(rbias.bootstraps.shape == (n_bs, index.num_trans)
              and np.isfinite(rbias.bootstraps).all()
              and (np.abs(rbias.bootstraps.sum(axis=1) - n_al)
                   <= 1e-6 * n_al).all(),
              f"{n_bs} replicates of {index.num_trans} targets, each sums to "
              f"{n_al} within 1e-6")
        check(np.array_equal(rbias.counts, res.counts)
              and [s.tolist() for s in rbias.ec_sets]
              == [s.tolist() for s in res.ec_sets],
              "--bias run (every batch per read): EC counts and sets equal "
              "to phase 5's")
        routes_b = {r: rbias.timings[r] for r in ROUTES}
        tb = rbias.timings
        untimed = bias_quant_s - sum(tb[key] for key in (
            "index_upload_s", "pseudoalign_s", "em_problem_s",
            "bias_tables_s", "em_s", "bootstrap_s", "write_s"))
        log(f"--bias -b {n_bs} wall {bias_quant_s:.2f} s (outputs written), "
            f"em_s {tb['em_s']:.3f} ({rbias.em.n_rounds} rounds), "
            f"bias_update_s {tb['bias_update_s']:.3f}, bias_tables_s "
            f"{tb['bias_tables_s']:.3f}, em_problem_s {tb['em_problem_s']:.3f}"
            f", bootstrap_s {tb['bootstrap_s']:.3f}, write_s "
            f"{tb['write_s']:.3f}, not timed {untimed:.3f}; routes "
            f"{routes_b}; host seconds by phase: " + json.dumps(tb))
        bias_timings = rbias.timings
        del rbias

        # ---------------------------------- 5c. bus -x 10xv2, full size
        log(f"== phase 5c: bus -x 10xv2 at realistic size "
            f"({time.perf_counter() - t_start:.0f} s)")
        launches_bus, bus_summary, bus_out = phase_5c(
            torch, np, kernels, Options, run_bus, index, r1p, n_pairs, work,
            dev)

        # ------------------------------- 5d. long reads, full size
        log(f"== phase 5d: quant --long and bus --long at realistic size "
            f"({time.perf_counter() - t_start:.0f} s)")
        launches_long, k5d, long_summary = phase_5d(
            torch, np, pa, kernels, fastx, Options, run_quant, run_bus,
            fasta, index, didx, k, work, dev)

        # ------------------------------------ 5e. quant-tcc, full size
        log(f"== phase 5e: quant-tcc of phase 5c's cells at realistic size "
            f"({time.perf_counter() - t_start:.0f} s)")
        launches_tcc, k5e, tcc_summary = phase_5e(
            torch, np, kernels, emq, Options, run_quant_tcc, index, bus_out,
            work, dev)

        # ------------------------------------ 5f. host wave 1, full size
        log(f"== phase 5f: quant with host wave 1 at realistic size "
            f"({time.perf_counter() - t_start:.0f} s)")
        launches_hw1, k5f, hw1_summary = phase_5f(
            torch, np, pa, kernels, Options, run_quant, index, r1p, r2p, res,
            n_pairs, work, dev)

        # ------------------------------------- 5g. several devices
        log(f"== phase 5g: quant, bus and quant-tcc over {N_SHARDS} shards "
            f"({time.perf_counter() - t_start:.0f} s)")
        k18, mesh_summary = phase_5g(
            torch, np, pa, kernels, Options, run_quant, run_bus,
            run_quant_tcc, index, r1p, r2p,
            os.path.join(work, "bus_r1.fastq.gz"), bus_out, work, dev, k)

        # ------------------------------- 5h. the padded layout, quant
        log(f"== phase 5h: quant on the padded index, then bucketed "
            f"({time.perf_counter() - t_start:.0f} s)")
        padded_summary = phase_5h(torch, np, pa, kernels, Options, run_quant,
                                  padded_ctx, PADDED_PAIRS, dev)

        # ------------------------------------ 6. kernel G, one replicate
        log(f"== phase 6: kernel G with one replicate (the main EM) on the "
            f"main path's EM problem ({time.perf_counter() - t_start:.0f} s)")
        problem = emq.build_em_problem(res.ec_sets, index.num_trans)
        em_walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            before = kernels.LAUNCHES["em_step_batch"]
            t0 = time.perf_counter()
            emg = emq.run_em(problem, res.counts, res.eff_lens, device=dev)
            em_walls.append(time.perf_counter() - t0)
            launched_1 = kernels.LAUNCHES["em_step_batch"] - before
        em_wall_s = statistics.median(em_walls)
        emc = emq.run_em(problem, res.counts, res.eff_lens, device="cpu")
        check(emg.n_rounds == emc.n_rounds and emg.rounds == emc.rounds
              and g_launches_cover(emq, launched_1, emg.rounds, 1),
              f"EM rounds equal ({emg.n_rounds}; {emg.rounds} rounds ran, "
              f"kernel G launched {launched_1} times)")
        check(np.array_equal(emg.alpha, emc.alpha)
              and np.array_equal(emg.alpha_before_zeroes,
                                 emc.alpha_before_zeroes),
              "EM alpha bitwise equal, card vs CPU")
        err_1 = float(np.max(np.abs(emg.alpha - emc.alpha)))
        sa, mc = emq.em_inputs(problem, res.counts[None])
        prob = emq.device_em_problem(problem, sa, mc, 1.0 / res.eff_lens, dev)
        alpha = torch.from_numpy(emg.alpha_before_zeroes[None]).to(dev)
        mode = torch.ones(1, dtype=torch.int32, device=dev)
        ms_1 = em_chunk_ms(torch, np, emq, prob)
        plain_1 = cuda_ms(lambda: emq.em_step_batch_plain(alpha, prob, mode),
                          10, torch)
        T, E = problem.num_trans, prob.num_multi
        M = int(prob.flat_tx.shape[0])
        bound_1 = em_bound(1, T, E, M)
        round_wall_ms = em_wall_s / emg.rounds * 1e3
        log(f"kernel G, one replicate: {ms_1:.4f} ms per round over chunks "
            f"of {emq.EM_CHUNK} (plain on card "
            f"{plain_1:.4f} ms); whole EM {em_wall_s * 1e3:.2f} ms over "
            f"{emg.rounds} rounds, {round_wall_ms:.4f} ms per round "
            f"(host wall), {emg.host_reads} host reads (median of 5: "
            f"{', '.join(f'{w * 1e3:.2f}' for w in em_walls)}); "
            f"T={T} E={E} M={M}")

        # -------------------------------------------------- 6b. kernel G
        log(f"== phase 6b: kernel G on the main path's EM problem "
            f"({time.perf_counter() - t_start:.0f} s)")
        (ms_g, plain_g, bound_g, err_g, reads_g), bs_summary = phase_6b(
            torch, np, emq, bsq, kernels, problem, res, dev)

        # ----------------------------------------------------- 7. summary
        csrc = "kallisto_tpu_torch/csrc/"
        # kernel G has two rows: the main EM (one replicate, K8; launches
        # of phase 5) and the bootstraps (100 replicates, K15; launches of
        # the --bias -b 100 run, main EM included)
        rows = [
            dict(name="pseudoalign_side", route="cuda",
                 source=csrc + "pseudoalign.cu",
                 replaces="kallisto_tpu/ops/pseudoalign.py:479",
                 launches=launches["pseudoalign_side"], max_abs_err=0.0,
                 ms=ms_a, plain_ms=plain_a, bound_ms=bound_a[0],
                 bound_by=bound_a[1], library_ms=None,
                 wave1_ms=k3a_w2["wave1_ms"],
                 wave2_share=k3a_w2["wave2_share"],
                 **k3g["pseudoalign_side"]),
            # A's wave 2 alone on its list (phase 3's mate-1 batch)
            dict(name="pseudoalign_side_wave2", route="cuda",
                 source=csrc + "pseudoalign.cu",
                 replaces="kallisto_tpu/ops/pseudoalign.py:504",
                 launches=launches["pseudoalign_side_wave2"], max_abs_err=0.0,
                 library_ms=None, **{key: v for key, v in k3a_w2.items()
                                     if key != "wave1_ms"}),
            dict(name="read_keys", route="cuda",
                 source=csrc + "read_keys.cu",
                 replaces="kallisto_tpu/ops/pseudoalign.py:567",
                 launches=launches["read_keys"], max_abs_err=0.0,
                 ms=ms_b, plain_ms=plain_b, bound_ms=bound_b[0],
                 bound_by=bound_b[1], library_ms=None, device_ms=dev_b),
            dict(name="em_step_batch", route="cuda", source=csrc + "em.cu",
                 replaces="kallisto_tpu/quant/em.py:112",
                 launches=launches["em_step_batch"], max_abs_err=err_1,
                 ms=ms_1, plain_ms=plain_1, bound_ms=bound_1[0],
                 bound_by=bound_1[1], library_ms=None, replicates=1,
                 em_wall_s=em_wall_s, host_reads=emg.host_reads,
                 rounds=emg.rounds),
        ]
        # kernel D: launches of its own path (phase 5's mixed-length run);
        # the main path's count beside it
        for name, src, replaces, n in (
                ("pseudoalign_turbo", "pseudoalign.cu",
                 "kallisto_tpu/ops/turbo.py:131",
                 launches_d["pseudoalign_turbo"]),
                ("key_histogram", "compact.cu",
                 "kallisto_tpu/ops/pseudoalign.py:689",
                 launches["key_histogram"]),
                ("gather_exemplars", "compact.cu",
                 "kallisto_tpu/quant/pipeline.py:495",
                 launches["gather_exemplars"])):
            ms, plain, bnd, lib = k3b[name]
            rows.append(dict(
                name=name, route="cuda", source=csrc + src, replaces=replaces,
                launches=n, max_abs_err=0.0, ms=ms,
                plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=lib, main_path_launches=launches[name],
                **k3b["device"].get(name, {}), **k3g.get(name, {})))
        # kernel I has two rows: paired (quant, launches of phase 5) and
        # single-end (bus, launches of phase 5c)
        for form, replaces, n in (
                ("paired", "kallisto_tpu/ops/anchor.py:218",
                 launches["pseudoalign_anchor"]),
                ("single", "kallisto_tpu/ops/anchor.py:249",
                 launches_bus["pseudoalign_anchor"])):
            (ms_i, plain_i, bound_i), share = k3d[form]
            rows.append(dict(
                name="pseudoalign_anchor", route="cuda",
                source=csrc + "pseudoalign.cu", replaces=replaces,
                launches=n, max_abs_err=0.0, ms=ms_i, plain_ms=plain_i,
                bound_ms=bound_i[0], bound_by=bound_i[1], library_ms=None,
                mates=2 if form == "paired" else 1, wave2_share=share,
                **k3g["pseudoalign_anchor_" + form]))
        # kernel I's wave 2 alone (phase 3d's paired batch) and A on codes
        # (launches: its own path, pseudoalign_batch in phase 3); D and I at
        # the same shape on an index that fits in the L2 (phase 3g)
        rows.append(dict(
            name="pseudoalign_anchor_wave2", route="cuda",
            source=csrc + "pseudoalign.cu",
            replaces="kallisto_tpu/ops/anchor.py:143",
            launches=launches["pseudoalign_anchor_wave2"], max_abs_err=0.0,
            library_ms=None, **k3d["wave2"]))
        rows.append(dict(
            name="pseudoalign_codes", route="cuda",
            source=csrc + "pseudoalign.cu",
            replaces="kallisto_tpu/ops/pseudoalign.py:493", max_abs_err=0.0,
            library_ms=None, **k3codes, **k3g["pseudoalign_codes"]))
        # A on codes' wave 2 alone on its list (phase 3's batch)
        rows.append(dict(
            name="pseudoalign_codes_wave2", route="cuda",
            source=csrc + "pseudoalign.cu",
            replaces="kallisto_tpu/ops/pseudoalign.py:504", max_abs_err=0.0,
            library_ms=None, **k3codes_w2))
        l2 = k3g["l2_index"]
        for r in rows:
            if r["name"] == "pseudoalign_side":
                r.update(l2_index_ms_padded=l2["a_ms_1"],
                         l2_index_ms_bucketed=l2["a_ms_2"],
                         l2_index_wave2_share=l2["a_wave2_share"])
            if r["name"] == "pseudoalign_turbo":
                r.update(l2_index_ms_padded=l2["d_ms_1"],
                         l2_index_ms_bucketed=l2["d_ms_2"])
            if r["name"] == "pseudoalign_anchor":
                form = "paired" if r["mates"] == 2 else "single"
                r.update(l2_index_ms_padded=l2[f"i_{form}_ms_1"],
                         l2_index_ms_bucketed=l2[f"i_{form}_ms_2"],
                         l2_index_wave2_share=l2[f"i_{form}_wave2_share"])
        # the bus run's kernel time from this run's per-launch times: I and
        # B at the chunk's shape, F at phase 3b's
        bus_busy = {
            "pseudoalign_anchor": launches_bus["pseudoalign_anchor"]
            * k3d["single"][0][0],
            "read_keys": launches_bus["read_keys"] * ms_b_single,
            "gather_exemplars": launches_bus["gather_exemplars"]
            * k3b["gather_exemplars"][0]}
        log(f"bus kernel ms (launches x ms): {bus_busy}, sum "
            f"{sum(bus_busy.values()):.3f} ms of {bus_summary['bus_s']:.2f} s")
        # G with replicates and H: launches of the --bias -b 100 run
        rows += [
            dict(name="em_step_batch", route="cuda", source=csrc + "em.cu",
                 replaces="kallisto_tpu/quant/em.py:236",
                 launches=launches_b["em_step_batch"], max_abs_err=err_g,
                 ms=ms_g, plain_ms=plain_g, bound_ms=bound_g[0],
                 bound_by=bound_g[1], library_ms=None, replicates=100,
                 em_wall_s=bs_summary["bs100_em_s"],
                 host_reads=reads_g, rounds=bs_summary["bs100_rounds"]),
            # H: B's epilogue (the fused launch: B + H, timed with B
            # alone beside it in phase 3c; bound: the fused work's, and
            # H's taken alone apart as h_bound_ms)
            dict(name="bias_hexamers", route="cuda",
                 source=csrc + "read_keys.cu",
                 replaces="kallisto_tpu/ops/pseudoalign.py:1172",
                 launches=launches_b["bias_hexamers"], max_abs_err=0.0,
                 ms=ms_bh, plain_ms=plain_b + plain_h, bound_ms=bound_bh[0],
                 bound_by=bound_bh[1], library_ms=None,
                 fused_into="read_keys", device_ms=dev_bh,
                 b_alone_ms=ms_b3c, b_alone_device_ms=dev_b3c,
                 h_bound_ms=bound_h[0], h_plain_ms=plain_h),
            # J: launches of phase 5d's quant --long, held and timed on its
            # first batch; the stress batch of phase 3e beside it
            dict(name="pseudoalign_long", route="cuda",
                 source=csrc + "pseudoalign.cu",
                 replaces="kallisto_tpu/ops/pseudoalign.py:1082",
                 launches=launches_long["pseudoalign_long"], max_abs_err=0.0,
                 ms=k5d[0], plain_ms=k5d[1], bound_ms=k5d[2][0],
                 bound_by=k5d[2][1], library_ms=None,
                 stress_ms=k3e[0],
                 stress_plain_ms=k3e[1], stress_bound_ms=k3e[2][0],
                 **k3g["pseudoalign_long"]),
            # G per cell (quant-tcc, K15 with per-cell lengths): launches of
            # phase 5e
            dict(name="em_step_batch", route="cuda", source=csrc + "em.cu",
                 replaces="kallisto_tpu/quant/em.py:236",
                 launches=launches_tcc["em_step_batch"], max_abs_err=k5e[3],
                 ms=k5e[0], plain_ms=k5e[1], bound_ms=k5e[2][0],
                 bound_by=k5e[2][1], library_ms=None, replicates=256,
                 form="tcc",
                 em_wall_s=tcc_summary["tcc_phases_s"]["em_s"],
                 host_reads=tcc_summary["tcc_phases_s"]["em_host_reads"],
                 rounds=tcc_summary["tcc_phases_s"]["em_rounds"]),
        ]
        # host wave 1's kernels (launches of phase 5f, held and timed on
        # its first hw1 batch's half-fail slice; phase 3f's stress slices,
        # all real at Bp = 262,144 and the smallest bucket, beside them): K,
        # E with per-read slots (a row of its own beside E's) and F's slim
        # layout, which phase 5's anchor route launches too
        for name, key, replaces, extra in (
                ("pseudoalign_halffail", "pseudoalign_halffail",
                 "kallisto_tpu/ops/turbo.py:244", {
                     **k5f["pseudoalign_halffail_design"],
                     **{"stress_" + key: v for key, v in
                        k3f["pseudoalign_halffail_design"].items()},
                     **{key + "_16k": v for key, v in
                        k3f["pseudoalign_halffail_design_16k"].items()}}),
                ("key_histogram", "key_histogram_slots",
                 "kallisto_tpu/ops/pseudoalign.py:774", {
                     "form": "slots",
                     "device_ms": k5f["key_histogram_slots_device_ms"],
                     "stress_device_ms": k3f["key_histogram_slots_device_ms"],
                     "device_ms_16k":
                     k3f["key_histogram_slots_device_ms_16k"]}),
                ("gather_slim", "gather_slim",
                 "kallisto_tpu/quant/pipeline.py:466",
                 {"main_path_launches": launches["gather_slim"]})):
            ms, plain, bnd, lib = k5f[key]
            st, st_plain, st_bnd, st_lib = k3f[key]
            ms16, plain16, bnd16, lib16 = k3f[key + "_16k"]
            rows.append(dict(
                name=name, route="cuda",
                source=csrc + ("pseudoalign.cu" if name.startswith("pseudo")
                               else "compact.cu"),
                replaces=replaces, launches=launches_hw1[key],
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=lib, stress_ms=st,
                stress_plain_ms=st_plain, stress_bound_ms=st_bnd[0],
                stress_library_ms=st_lib, ms_16k=ms16, plain_ms_16k=plain16,
                bound_ms_16k=bnd16[0], library_ms_16k=lib16,
                **k3g.get(name, {}), **extra))
        # L, K2's probe alone (phase 3g: A's windows on the padded index
        # and on the same index bucketed; phase 3: phase 2's bucketed
        # index); no run loop launches it
        rows.append(dict(
            name="lookup_kmers", route="cuda", source=csrc + "pseudoalign.cu",
            replaces="kallisto_tpu/ops/pseudoalign.py:325",
            launches=launches["lookup_kmers"], max_abs_err=0.0,
            library_ms=None, **k3g["lookup_kmers"], **k3l))
        # K18: one shard's A + E at 5g's shard shape; launches: the
        # shard steps of 5g's sharded quant (one E each)
        rows.append(dict(
            name="mesh_pair_compact", route="cuda",
            source="kallisto_tpu_torch/parallel/mesh.py",
            replaces="kallisto_tpu/parallel/mesh.py:101", max_abs_err=0.0,
            library_ms=None, **k18))
        # the host-wave-1 run's kernel time: K and D as timed on each of its
        # slices, the others as launches x this run's per-launch times (E
        # with slots and F slim at 5f's first hw1 batch, B at phase 3's
        # shape, F at 3b's, G at the main EM's)
        hw1_busy = {
            "pseudoalign_halffail": sum(x[2] for x in hw1_summary["hw1_k_ms"]),
            "pseudoalign_turbo": sum(x[2] for x in hw1_summary["hw1_d_ms"]),
            "key_histogram_slots": launches_hw1["key_histogram_slots"]
            * k5f["key_histogram_slots"][0],
            "gather_slim": launches_hw1["gather_slim"] * k5f["gather_slim"][0],
            "read_keys": launches_hw1["read_keys"] * ms_b,
            "gather_exemplars": launches_hw1["gather_exemplars"]
            * k3b["gather_exemplars"][0],
            "em_step_batch": launches_hw1["em_step_batch"] * ms_1}
        hw1_busy_s = sum(hw1_busy.values()) / 1e3
        log(f"host-wave-1 kernel ms: {hw1_busy}, sum {hw1_busy_s:.4f} s of "
            f"{hw1_summary['hw1_quant_s']:.2f} s: card idle "
            f"{100 * (1 - hw1_busy_s / hw1_summary['hw1_quant_s']):.2f} %")
        log(json.dumps({
            "index_build_s": index_build_s, "quant_s": quant_s,
            "pairs_per_s": n_pairs / quant_s, "routes": routes,
            "n_uniq_max": res.timings["n_uniq_max"],
            "n_uniq_mean": n_uniq_mean, "per_read_quant_s": full_s,
            "per_read_pairs_per_s": n_pairs / full_s,
            "per_read_phases_s": rfull.timings,
            "compact_keys_ms": k3b["compact_keys"],
            "n_pairs": n_pairs, "n_genes": n_genes, "em_rounds": res.em.n_rounds,
            "em_s": res.timings["em_s"], "em_round_wall_ms": round_wall_ms,
            "em_wall_s": em_wall_s, "em_host_reads": emg.host_reads,
            "quant_phases_s": res.timings,
            "bias_bs100_quant_s": bias_quant_s,
            "bias_bs100_phases_s": bias_timings, **bs_summary,
            "read_keys_single_ms": ms_b_single, "bus_kernel_ms": bus_busy,
            "bus_launches": launches_bus,
            "bus_golden_routes": bus_golden_routes, **bus_summary,
            **long_summary, "long_launches": launches_long, **tcc_summary,
            "tcc_launches": launches_tcc, **probe_summary, **hw1_summary,
            "hw1_launches": launches_hw1, "hw1_kernel_ms": hw1_busy,
            **mesh_summary, **padded_summary, **reader_summary,
            **prof_summary,
            "kernel_build_s": build_s, "n_targets": index.num_trans,
            "n_kmers": index.num_kmers, "card": smi,
            "smoke_s": time.perf_counter() - t_start,
        }))
        log(smi)
        print(json.dumps({"kernels": rows}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
