#!/usr/bin/env python3
"""Kernels K, A on codes, L and B from several checkouts, in turns.

    python3 probe_ab.py [OTHER ...] [--genes 10000] [--pairs 524288]
                        [--rounds 4] [--kernels k,codes,l,b]

Each OTHER is a checkout of the repository whose csrc/pseudoalign.cu has
this checkout's C interface (a variant of the kernels' insides: another
interface is called with this one's arguments and crashes; a function
that the other build lacks is not called).  Builds
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
(chip_smoke.graph_ms, L2-warm).  Kernel L (`--kernels l`) is held and
timed on the windows of phase 3's A batch (the first 262,144 mate-1
reads as chip_smoke's ragged_batch makes them) of phase 2's bucketed
index and of phase 3g's 800-gene index (262,144 pairs from it), padded
and bucketed: every build through its C function lookup_kmers (the
index's own tables), this checkout's also through its wrapper (bucketed:
the packed (key, EC row) entries).  Kernel B (`--kernels b`, read_keys
with no bias) runs through each checkout's own Python wrapper (its
ops/kernels.py loaded apart, its read_keys.cu built into its own
_kbuild), so that host work the wrappers add is timed too: paired on the
first 262,144 pairs' A results and single-end on 76 bp reads.  Prints
the card's name and power limit,
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
            if "halffail" in line or "codes" in line or "lookup" in line:
                print(d, " ".join(x.strip() for x in lines[i:i + 3]),
                      flush=True)
        lib = ctypes.CDLL(out)
        for name, u in kernels.SOURCES.items():
            if u == unit and hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = kernels._ARGTYPES[name]
                fn.restype = ctypes.c_int
        libs.append((d, lib))
    return libs


def _k_codes(torch, np, cs, pa, kernels, turbo, fastx, index, didx, rbs,
             builds, unit, k, dev, args):
    """K and A on codes with each build, in turns: {build: medians}."""
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
    return out


def _l_windows(torch, np, cs, pa, fastx, rb, k, dev):
    """The canonical k-mers and valid mask of phase 3's A batch: the first
    262,144 reads of mate-1 batch rb as chip_smoke's ragged_batch makes
    them (its seed, 1234)."""
    B = min(262_144, rb.n)
    pb = cs.ragged_batch(rb.codes[:B], rb.lens[:B], k,
                         np.random.default_rng(1234), fastx)
    g = pa.upload_batch(pb, dev)
    codes = pa.unpack_codes(g[0], g[1], pb.Lp)
    canon, _, valid = pa.rolling_canonical_kmers(codes, g[2], k)
    return canon, valid


def _l_entries_off(torch, kernels, ix, c, v):
    """Kernel L through the loaded build's C function lookup_kmers: the
    index's own key and EC tables, no packed entries, in either layout
    (every build has this function)."""
    shape, dev = tuple(c.shape), c.device
    out = (torch.empty(shape, dtype=torch.int64, device=dev),
           torch.empty(shape, dtype=torch.bool, device=dev),
           torch.empty(shape, dtype=torch.int32, device=dev))
    kernels._launch("lookup_kmers", dev,
                    ctypes.byref(kernels._index_args(ix)), c.data_ptr(),
                    v.data_ptr(), c.numel(), *(t.data_ptr() for t in out))
    return out


def _l_ab(torch, np, cs, pa, kernels, fastx, build_index,
          generate_transcriptome, generate_paired, didx, rbs, builds, unit,
          k, work, dev, rounds):
    """Kernel L with each build, in turns, on phase 2's bucketed index and
    the 800-gene index (padded and bucketed), each on its A windows: every
    build through its C function lookup_kmers (no packed entries), this
    checkout's (the first build) also through its wrapper (a bucketed
    index: the packed entries).  Returns {index: {form: medians}}."""
    sets = {"phase2_bucketed": (didx, *_l_windows(torch, np, cs, pa, fastx,
                                                   rbs[0], k, dev))}
    fasta = os.path.join(work, "tx800.fasta.gz")
    generate_transcriptome(fasta, n_genes=cs.PADDED_GENES, seed=42)
    ix800 = build_index([fasta], k=k)
    dp = pa.device_index_from_host(ix800, dev)
    budget = pa._PADDED_BYTES_BUDGET
    pa._PADDED_BYTES_BUDGET = 0
    try:
        db = pa.device_index_from_host(ix800, dev)
    finally:
        pa._PADDED_BYTES_BUDGET = budget
    r1p = os.path.join(work, "tx800_1.fastq.gz")
    r2p = os.path.join(work, "tx800_2.fastq.gz")
    generate_paired(fasta, r1p, r2p, 262_144, read_len=cs.READ_LEN,
                    frag_mean=180.0, frag_sd=20.0, error_rate=0.005)
    fs = fastx.FastqStream(r1p)
    rb = fs.next_batch(262_144)
    fs.close()
    canon, valid = _l_windows(torch, np, cs, pa, fastx, rb, k, dev)
    sets["800g_padded"] = (dp, canon, valid)
    sets["800g_bucketed"] = (db, canon, valid)
    forms = [(d, False) for d, _ in builds] + [(builds[0][0], True)]

    def call(ix, c, v, packed):
        if packed:
            return kernels.lookup_kmers(ix, c, v)
        return _l_entries_off(torch, kernels, ix, c, v)

    for name, (ix, c, v) in sets.items():
        want = pa.lookup_kmers(ix, c, v)
        for d, packed in forms:
            kernels._libs[unit] = dict(builds)[d]
            got = call(ix, c, v, packed)
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                assert torch.equal(x, y), (name, d, packed)
        del want
    times = {name: {} for name in sets}
    for r in range(rounds):
        order = forms[r % len(forms):] + forms[:r % len(forms)]
        for name, (ix, c, v) in sets.items():
            for d, packed in order:
                if packed and isinstance(ix, pa.PaddedDeviceIndex):
                    continue
                kernels._libs[unit] = dict(builds)[d]
                tag = f"{d}{' packed' if packed else ''}"

                def fn(ix=ix, c=c, v=v, packed=packed):
                    return call(ix, c, v, packed)

                t = times[name].setdefault(tag, {})
                t.setdefault("ms", []).append(cs.cuda_ms(fn, 10, torch))
                t.setdefault("device_ms", []).append(
                    cs.graph_ms(fn, 10, torch))
            print(f"round {r} {name}: " + ", ".join(
                f"{tag} {t['ms'][-1]:.4f} / {t['device_ms'][-1]:.4f}"
                for tag, t in times[name].items()), flush=True)
    kernels._libs[unit] = builds[0][1]
    return {name: {tag: {key: statistics.median(v) for key, v in t.items()}
                   for tag, t in ts.items()}
            for name, ts in times.items()}


def _b_ab(torch, np, cs, pa, kernels, fastx, didx, rbs, others, k, dev,
          rounds):
    """Kernel B alone (read_keys with no bias) through each checkout's own
    wrapper (its ops/kernels.py, loaded apart, built into its own
    _kbuild), in turns: paired on the A results of the first 262,144
    pairs (chip_smoke's ragged_batch, seed 1234) and single-end on the
    first 76 columns of mate 1.  Every build's h and tl held equal to
    read_keys_plain first.  Returns {build: medians}."""
    import importlib.util

    mods = [(os.path.dirname(os.path.abspath(__file__)), kernels)]
    for i, d in enumerate(others):
        spec = importlib.util.spec_from_file_location(
            f"_kernels_{i}", os.path.join(d, "kallisto_tpu_torch", "ops",
                                          "kernels.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append((d, mod))
    B = min(262_144, rbs[0].n)
    rng = np.random.default_rng(1234)
    pbs = [cs.ragged_batch(rb.codes[:B], rb.lens[:B], k, rng, fastx)
           for rb in rbs]
    pbs.append(cs.ragged_batch(rbs[0].codes[:B, :76],
                               np.full(B, 76, np.int32), k, rng, fastx))
    sides = [pa.pseudoalign_batch_packed(didx, *pa.upload_batch(pb, dev),
                                         k=k, L=pb.Lp) for pb in pbs]
    forms = {"paired": (sides[0], sides[1]), "single": (sides[2], None)}
    for tag, (s1, s2) in forms.items():
        want = pa.read_keys_plain(s1, s2, k)
        for d, mod in mods:
            got = mod.read_keys(s1, s2, k)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (tag, d, "h")
            assert s2 is None or torch.equal(got[1], want[1]), (tag, d, "tl")
    times = {d: {} for d, _ in mods}
    for r in range(rounds):
        for d, mod in mods[r % len(mods):] + mods[:r % len(mods)]:
            t = times[d]
            for tag, (s1, s2) in forms.items():
                def fn(mod=mod, s1=s1, s2=s2):
                    return mod.read_keys(s1, s2, k)

                t.setdefault(f"{tag}_ms", []).append(
                    cs.cuda_ms(fn, 20, torch))
                t.setdefault(f"{tag}_device_ms", []).append(
                    cs.graph_ms(fn, 20, torch))
            print(f"round {r} {d}: " + ", ".join(
                f"{key} {v[-1]:.4f}" for key, v in t.items()), flush=True)
    out = {d: {key: statistics.median(v) for key, v in t.items()}
           for d, t in times.items()}
    out["reads"] = B
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*")
    ap.add_argument("--genes", type=int, default=10_000)
    ap.add_argument("--pairs", type=int, default=524_288)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--kernels", default="k,codes,l",
                    help="comma-separated: k, codes, l, b")
    args = ap.parse_args(argv)
    which = set(args.kernels.split(","))

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
        builds = [(here, kernels._libs[unit])]
        if which & {"k", "codes", "l"}:
            builds += _build(kernels, args.others, work)

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
        out = {}
        if "b" in which:
            out["b"] = _b_ab(torch, np, cs, pa, kernels, fastx, didx, rbs,
                             args.others, k, dev, args.rounds)
        if which & {"k", "codes"}:
            out.update(_k_codes(torch, np, cs, pa, kernels, turbo, fastx,
                                index, didx, rbs, builds, unit, k, dev,
                                args))
        if "l" in which:
            out["l"] = _l_ab(torch, np, cs, pa, kernels, fastx, build_index,
                             generate_transcriptome, generate_paired, didx,
                             rbs, builds, unit, k, work, dev, args.rounds)
        print(json.dumps(out), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
