#!/usr/bin/env python3
"""Kernels K and A on codes from several builds of csrc/pseudoalign.cu, in turns.

    python3 probe_ab.py [OTHER ...] [--genes 10000] [--pairs 524288]
                        [--rounds 4]

Each OTHER is a checkout of the repository whose csrc/pseudoalign.cu has
this checkout's C interface (a variant of the kernels' insides: another
interface is called with this one's arguments and crashes).  Builds
every source with this checkout's nvcc flags (one nvcc each, together),
then the transcriptome, index and read pairs of chip_smoke.py's phase 2
(its generators and seeds; `pairs` pairs), the inputs of phase 3's A on
codes (the first 262,144 mate-1 reads as unpacked codes, chip_smoke's
_code_batch) and of phase 3f's kernel K (the half-fail pairs after the
host probe, at Bp = 131,072 -- phase 5f's first slice has that bucket --
and 262,144), holds every build's kernels equal to their plain versions
on the card, and times each kernel with each build in turns (the builds'
order rotating from round to round): by CUDA events from the host
(chip_smoke.cuda_ms) and as device time from CUDA-graph replays
(chip_smoke.graph_ms, L2-warm).  Prints the card's name and power limit,
each build's registers and spills, and last one JSON object with each
build's medians.
"""

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile


def _build(kernels, src_dirs, out_dir):
    """csrc/pseudoalign.cu of each checkout, built with this checkout's
    flags into out_dir and loaded, each function with its argtypes."""
    unit = kernels.SOURCES["pseudoalign_halffail"]
    procs = []
    for i, d in enumerate(src_dirs):
        out = os.path.join(out_dir, f"libpseudoalign_{i}.so")
        src = os.path.join(d, "kallisto_tpu_torch", "csrc", unit[0])
        procs.append((d, out, subprocess.Popen(
            [kernels._nvcc(), src, *kernels._NVCC_FLAGS, *unit[1], "-o", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for d, out, p in procs:
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {d}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "halffail" in line or "codes" in line:
                print(d, " ".join(x.strip() for x in lines[i:i + 3]),
                      flush=True)
        lib = ctypes.CDLL(out)
        for name, u in kernels.SOURCES.items():
            if u == unit:
                fn = getattr(lib, name)
                fn.argtypes = kernels._ARGTYPES[name]
                fn.restype = ctypes.c_int
        libs.append((d, lib))
    return libs


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*")
    ap.add_argument("--genes", type=int, default=10_000)
    ap.add_argument("--pairs", type=int, default=524_288)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device; nothing run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np

    import chip_smoke as cs
    from kallisto_tpu_torch.index import build_index
    from kallisto_tpu_torch.io import fastx
    from kallisto_tpu_torch.ops import kernels, turbo
    from kallisto_tpu_torch.ops import pseudoalign as pa
    from kallisto_tpu_torch.utils.benchdata import generate_paired
    from kallisto_tpu_torch.utils.simtx import generate_transcriptome

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    k = 31
    work = tempfile.mkdtemp(prefix="probe_ab_")
    try:
        kernels.build_all()
        unit = kernels.SOURCES["pseudoalign_halffail"]
        builds = [(here, kernels._libs[unit])] + _build(kernels, args.others,
                                                       work)

        fasta = os.path.join(work, "simtx.fasta.gz")
        generate_transcriptome(fasta, n_genes=args.genes, seed=42)
        index = build_index([fasta], k=k)
        didx = pa.device_index_from_host(index, dev, with_pos_tables=True)
        r1p = os.path.join(work, "sim_1.fastq.gz")
        r2p = os.path.join(work, "sim_2.fastq.gz")
        generate_paired(fasta, r1p, r2p, args.pairs, read_len=cs.READ_LEN,
                        frag_mean=180.0, frag_sd=20.0, error_rate=0.005)
        rbs = []
        for path in (r1p, r2p):
            fs = fastx.FastqStream(path)
            rbs.append(fs.next_batch(args.pairs))
            fs.close()
        B = min(262_144, args.pairs)
        cn, ln = cs._code_batch(np, rbs[0].codes[:B], rbs[0].lens[:B], k,
                                np.random.default_rng(1234))
        codes, lens = cs._put(torch, np, cn, dev), cs._put(torch, np, ln, dev)
        R = min(16, codes.shape[1] - k + 1)
        bs = cs._sparse_pairs(np, fastx, rbs, rbs[0].n, k,
                              np.random.default_rng(66))
        del rbs
        _, hk, _, kw = cs._host_probe(pa, index, bs, k)
        half = np.flatnonzero(hk.fail_side != 3)
        L, rl = kw["L"], kw["rl"]
        Rr = min(kw["max_rows"], rl - k + 1)
        slices = {Bp: cs._half_slice(torch, np, hk, bs, half[:Bp], Bp, dev)
                  for Bp in (131_072, 262_144) if half.shape[0] >= Bp // 2}
        del bs, hk

        want_c = pa._pseudoalign_core(didx, codes, lens, k, 16)
        want_k = {Bp: turbo.halffail_core(didx, *a, k, L, kw["max_rows"], rl)
                  for Bp, a in slices.items()}
        for d, lib in builds:
            kernels._libs[unit] = lib
            cs._equal_sides(torch, pa, pa.pseudoalign_batch(didx, codes, lens,
                                                            k),
                            want_c, f"A on codes ({d})")
            for Bp, a in slices.items():
                got = kernels.pseudoalign_halffail(didx, *a, k, L, rl, Rr)
                for m in (0, 1):
                    cs._equal_sides(torch, pa, pa.SideResult(*got[m]),
                                    want_k[Bp][m], f"K Bp={Bp} ({d})")
        del want_c, want_k

        def codes_w2(lists):
            return kernels.pseudoalign_codes(didx, codes, lens, k, R,
                                             waves=2, lists=lists)

        times = {d: {} for d, _ in builds}
        for r in range(args.rounds):
            for d, lib in builds[r % len(builds):] + builds[:r % len(builds)]:
                kernels._libs[unit] = lib
                t = times[d]

                def codes_all():
                    return kernels.pseudoalign_codes(didx, codes, lens, k, R)

                lists = kernels.pseudoalign_codes(didx, codes, lens, k, R,
                                                  waves=1)
                t.setdefault("codes_ms", []).append(
                    cs.cuda_ms(codes_all, 10, torch))
                t.setdefault("codes_device_ms", []).append(
                    cs.graph_ms(codes_all, 10, torch))
                t.setdefault("codes_wave2_ms", []).append(
                    cs.cuda_ms(lambda: codes_w2(lists), 10, torch))
                for Bp, a in slices.items():
                    def k_call(a=a):
                        return kernels.pseudoalign_halffail(didx, *a, k, L,
                                                            rl, Rr)
                    t.setdefault(f"k_{Bp}_ms", []).append(
                        cs.cuda_ms(k_call, 10, torch))
                    t.setdefault(f"k_{Bp}_device_ms", []).append(
                        cs.graph_ms(k_call, 10, torch))
                print(f"round {r} {d}: " + ", ".join(
                    f"{key} {v[-1]:.4f}" for key, v in t.items()), flush=True)
        out = {d: {key: statistics.median(v) for key, v in t.items()}
               for d, t in times.items()}
        out["reads"] = {"codes": int(codes.shape[0]),
                        "k_pairs": {Bp: int(min(half.shape[0], Bp))
                                    for Bp in slices}}
        print(json.dumps(out), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
