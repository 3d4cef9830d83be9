#!/usr/bin/env python3
"""Smoke run of kallisto_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path -- `quant` on paired-end reads through the
per-read path -- on the card, and holds every CUDA kernel of that path
against its plain PyTorch version:

1. device: requires CUDA, prints the card's name and power limit, builds
   the kernels (one nvcc per source, in parallel);
2. set-up at realistic size: a 10,000-gene isoform-structured transcriptome
   (~29k targets, ~24M distinct 31-mers), its index built by the port's
   numpy builder, and 1,000,000 simulated 2x100 bp pairs;
3. kernels A (pseudoalign_side) and B (read_keys) on the card against their
   plain versions on the CPU, at the main path's batch shape (2x100 bp and
   76 bp reads with random Ns, ragged lengths and reads shorter than k):
   every field must be equal;
4. golden bytes: `quant` paired and `--single -l 180 -s 20` on tests/data,
   abundance.tsv byte-equal to tests/golden, run stats 10000/9413/7174;
5. the main path at realistic size: `quant` of the 1M pairs on the card
   with every launch count set to 0 just before and read just after; checks
   of its output, and a CPU re-run of the first 65,536 pairs with equal EC
   counts;
6. kernel C (em_step) on the main path's EM problem: the whole EM on the
   card against the plain version on the CPU, bitwise equal alpha and equal
   rounds;
7. one `kernels` JSON line, then the result line.

Any failed check raises, which ends the run with a non-zero exit and no
result line.  Without CUDA, or outside a checkout of the repo, it exits
non-zero before doing anything.
"""

import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

N_GENES = 10000
N_PAIRS = 1_000_000
READ_LEN = 100
CPU_RERUN_PAIRS = 65536

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


def bound(nbytes, nops, op_rate):
    tb = nbytes / PEAK_BYTES * 1e3
    to = nops / op_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def truncate_fastq(src, dst, n_records):
    with gzip.open(src, "rb") as f, gzip.open(dst, "wb", compresslevel=1) as g:
        for _ in range(4 * n_records):
            g.write(f.readline())


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
    from kallisto_tpu_torch.ops import kernels
    from kallisto_tpu_torch.ops import pseudoalign as pa
    from kallisto_tpu_torch.quant import em as emq
    from kallisto_tpu_torch.quant.pipeline import run_quant
    from kallisto_tpu_torch.utils.benchdata import generate_paired
    from kallisto_tpu_torch.utils.simtx import generate_transcriptome

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    k = 31

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
        t0 = time.perf_counter()
        index = build_index([fasta], k=k)
        index_build_s = time.perf_counter() - t0
        log(f"index build (numpy): {index_build_s:.1f} s, "
            f"{index.num_kmers} k-mers, {index.num_trans} targets")
        t0 = time.perf_counter()
        didx = pa.device_index_from_host(index, dev)
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
            # this input's data-dependent work, for the bound
            codes = pa.unpack_codes(c_in[0], c_in[1], pb.Lp)
            canon, _, valid = pa.rolling_canonical_kmers(codes, c_in[2], k)
            _, hit, _ = pa.lookup_kmers(didx_cpu, canon, valid)
            stats_a[tag] = (g_in, int(valid.sum()), int(hit.sum()),
                            int(sc.has_hits.sum()), canon.numel())
        # kernel B: paired on (m1, m2), single-end on r76
        for tag, s1, s2, c1, c2 in (
            ("paired", side_gpu["m1"], side_gpu["m2"], side_cpu["m1"],
             side_cpu["m2"]),
            ("single", side_gpu["r76"], None, side_cpu["r76"], None),
        ):
            hg, tg = pa.read_keys(s1, s2, k)
            torch.cuda.synchronize()
            hc, tc = pa.read_keys(c1, c2, k)
            check(torch.equal(hg.cpu(), hc), f"kernel B {tag}: keys equal")
            if s2 is not None:
                check(torch.equal(tg.cpu(), tc),
                      f"kernel B {tag}: fragment lengths equal")

        # timings at the main path's shape (mate 1, 2x100 bp batch)
        g_in, n_valid, n_hit, n_has, n_win = stats_a["m1"]
        R = min(16, pb1.Lp - k + 1)
        ms_a = cuda_ms(lambda: kernels.pseudoalign_side(
            didx, *g_in, k, pb1.Lp, R), 10, torch)
        plain_a = cuda_ms(lambda: pa.pseudoalign_batch_packed_plain(
            didx, *g_in, k=k, L=pb1.Lp), 3, torch)
        in_bytes = pb1.packed.nbytes + pb1.nmask.nbytes + 4 * B
        out_bytes = B * (4 * R + 4 * 6 + 3)
        # per valid window one 32 B sector of bucket_start and one of the
        # sorted keys, per hit one of kmer_ec, per read with hits the four
        # payload sectors (uid, pos, fw, block)
        table_bytes = 32 * (2 * n_valid + n_hit + 4 * n_has)
        ops_a = 250 * n_win
        bound_a = bound(in_bytes + out_bytes + table_bytes, ops_a, PEAK_INT_OPS)
        s1g, s2g = side_gpu["m1"], side_gpu["m2"]
        ms_b = cuda_ms(lambda: kernels.read_keys(s1g, s2g, k), 20, torch)
        plain_b = cuda_ms(lambda: pa.read_keys_plain(s1g, s2g, k), 5, torch)
        R2 = int(s2g.rows.shape[1])
        bytes_b = B * (4 * (R + R2) + 2 * (2 + 13) + 16 + 4)
        bound_b = bound(bytes_b, B * (R + R2 + 1) * 8, PEAK_INT_OPS)
        log(f"kernel A: {ms_a:.3f} ms (plain on card {plain_a:.3f} ms), "
            f"B={B} Lp={pb1.Lp} windows={n_win} valid={n_valid} hits={n_hit}")
        log(f"kernel B: {ms_b:.3f} ms (plain on card {plain_b:.3f} ms)")
        del side_gpu, side_cpu, stats_a, g_in, didx_cpu

        # ------------------------------------------------ 4. golden bytes
        log("== phase 4: golden bytes on the card")
        data = os.path.join(here, "tests", "data")
        golden = os.path.join(here, "tests", "golden")
        tidx = build_index([os.path.join(data, "transcripts.fasta.gz")], k=k)
        pf = [os.path.join(data, "reads_1.fastq.gz"),
              os.path.join(data, "reads_2.fastq.gz")]
        for name, gdir, kw in (
            ("paired", "quant_paired", dict(files=pf)),
            ("single", "quant_single", dict(
                files=pf[:1], single_end=True, fld_mean=180, fld_sd=20)),
        ):
            out = os.path.join(work, f"golden_{name}")
            res = run_quant(Options(output_dir=out, batch_size=4096, **kw),
                            index=tidx, device=dev)
            mine = open(os.path.join(out, "abundance.tsv")).read()
            want = open(os.path.join(golden, gdir, "abundance.tsv")).read()
            check(mine == want, f"{name}: abundance.tsv byte-equal to {gdir}")
            if name == "paired":
                check((res.num_processed, res.num_pseudoaligned,
                       res.num_unique) == (10000, 9413, 7174),
                      "paired run stats 10000 / 9413 / 7174")

        # -------------------------------------- 5. main path, full size
        log("== phase 5: main path at realistic size")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = run_quant(Options(files=[r1p, r2p], plaintext=True),
                        index=index, device=dev)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        log(f"launches on the main path: {launches}")
        for name, n in launches.items():
            check(n > 0, f"main path launched {name} ({n} times)")
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
        log(f"quant wall {quant_s:.1f} s = {n_pairs / quant_s:,.0f} pairs/s, "
            f"EM {res.em.n_rounds} rounds; host seconds by phase: "
            + json.dumps(res.timings))

        sub1 = os.path.join(work, "sub_1.fastq.gz")
        sub2 = os.path.join(work, "sub_2.fastq.gz")
        truncate_fastq(r1p, sub1, n_sub)
        truncate_fastq(r2p, sub2, n_sub)
        rg = run_quant(Options(files=[sub1, sub2]), index=index, device=dev)
        rc = run_quant(Options(files=[sub1, sub2]), index=index, device="cpu")
        check(np.array_equal(rg.counts, rc.counts)
              and [s.tolist() for s in rg.ec_sets]
              == [s.tolist() for s in rc.ec_sets],
              f"first {n_sub} pairs: EC counts equal, card vs CPU")

        # --------------------------------------------------- 6. kernel C
        log("== phase 6: kernel C on the main path's EM problem")
        problem = emq.build_em_problem(res.ec_sets, index.num_trans)
        emg = emq.run_em(problem, res.counts, res.eff_lens, device=dev)
        emc = emq.run_em(problem, res.counts, res.eff_lens, device="cpu")
        check(emg.n_rounds == emc.n_rounds,
              f"EM rounds equal ({emg.n_rounds})")
        check(np.array_equal(emg.alpha, emc.alpha)
              and np.array_equal(emg.alpha_before_zeroes,
                                 emc.alpha_before_zeroes),
              "EM alpha bitwise equal, card vs CPU")
        err_c = float(np.max(np.abs(emg.alpha - emc.alpha)))
        T = problem.num_trans
        sa = np.zeros(T)
        sa[problem.singleton_tx] = res.counts[problem.singleton_ec]
        prob = emq.device_em_problem(
            problem, sa, res.counts[problem.multi_ec_ids].astype(np.float64),
            1.0 / res.eff_lens, dev)
        alpha = torch.from_numpy(emg.alpha_before_zeroes).to(dev)
        ms_c = cuda_ms(lambda: kernels.em_step(alpha, prob, False), 50, torch)
        plain_c = cuda_ms(lambda: emq.em_step_plain(alpha, prob, False), 10,
                          torch)
        M, E = int(prob.flat_tx.shape[0]), prob.num_multi
        bytes_c = 8 * T * 4 + 8 * (T + 1) + 8 * (E + 1) + 8 * E + 8 * M + 4
        bound_c = bound(bytes_c, 4 * M + 10 * T, PEAK_F64)
        t0 = time.perf_counter()
        for _ in range(200):
            _, ch = kernels.em_step(alpha, prob, False)
            int(ch.item())
        loop_ms = (time.perf_counter() - t0) / 200 * 1e3
        log(f"kernel C: {ms_c:.4f} ms per update (plain on card "
            f"{plain_c:.4f} ms); loop step with the host read of the change "
            f"count: {loop_ms:.4f} ms; T={T} E={E} M={M}")

        # ----------------------------------------------------- 7. summary
        csrc = "kallisto_tpu_torch/csrc/"
        rows = [
            dict(name="pseudoalign_side", route="cuda",
                 source=csrc + "pseudoalign.cu",
                 replaces="kallisto_tpu/ops/pseudoalign.py:479",
                 launches=launches["pseudoalign_side"], max_abs_err=0.0,
                 ms=ms_a, plain_ms=plain_a, bound_ms=bound_a[0],
                 bound_by=bound_a[1], library_ms=None),
            dict(name="read_keys", route="cuda",
                 source=csrc + "read_keys.cu",
                 replaces="kallisto_tpu/ops/pseudoalign.py:567",
                 launches=launches["read_keys"], max_abs_err=0.0,
                 ms=ms_b, plain_ms=plain_b, bound_ms=bound_b[0],
                 bound_by=bound_b[1], library_ms=None),
            dict(name="em_step", route="cuda", source=csrc + "em.cu",
                 replaces="kallisto_tpu/quant/em.py:112",
                 launches=launches["em_step"], max_abs_err=err_c,
                 ms=ms_c, plain_ms=plain_c, bound_ms=bound_c[0],
                 bound_by=bound_c[1], library_ms=None),
        ]
        log(json.dumps({
            "index_build_s": index_build_s, "quant_s": quant_s,
            "pairs_per_s": n_pairs / quant_s,
            "n_pairs": n_pairs, "n_genes": n_genes, "em_rounds": res.em.n_rounds,
            "em_s": res.timings["em_s"], "em_loop_step_ms": loop_ms,
            "quant_phases_s": res.timings,
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
