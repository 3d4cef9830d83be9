#!/usr/bin/env python3
"""glibc's allocator settings for `quant`: alternating runs with and without.

    python3 malloc_tune_ab.py [--genes 10000] [--pairs 1000000] [--rounds 6]

The JAX package's CLI re-executes itself with MALLOC_MMAP_MAX_=0 and
MALLOC_TRIM_THRESHOLD_=-1 (glibc then serves large blocks from the heap
and never returns freed memory to the kernel).  This script measures what
those settings do to the port's `quant` on one CUDA card: it builds the
transcriptome, the index and the read pairs of chip_smoke.py's phase 2
(same generators, seeds and sizes), saves the index, then in each of
`rounds` rounds runs `quant` once per arm, each run a new process (glibc
reads the settings when the process starts), the arms' order alternating
from round to round:

- `tuned`: MALLOC_MMAP_MAX_=0 MALLOC_TRIM_THRESHOLD_=-1;
- `default`: neither variable set.

Each run loads the saved index and runs quant/pipeline.py run_quant on the
pairs (outputs written, --plaintext).  Every run's EC counts and sets must
equal the first run's.  Prints the card's name and power limit, one line
per run (the process's wall, the index load, run_quant's wall and host
seconds by phase), and last one JSON object with each arm's times, their
medians and quartiles, and for each time the median of the per-round
differences (tuned - default) and the rounds in which `tuned` took longer.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ARMS = ("tuned", "default")
TUNE = {"MALLOC_MMAP_MAX_": "0", "MALLOC_TRIM_THRESHOLD_": "-1"}
PHASES = ("read_s", "dispatch_s", "fetch_s", "resolve_s", "index_upload_s",
          "em_s", "write_s")

# one run: load the index, quant the pairs, print one JSON line
_RUN = r"""
import hashlib, json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import load_index
from kallisto_tpu_torch.quant.pipeline import run_quant
t1 = time.perf_counter()
index = load_index(sys.argv[2])
t2 = time.perf_counter()
res = run_quant(Options(files=sys.argv[3:5], output_dir=sys.argv[5],
                        plaintext=True), index=index, device="cuda")
torch.cuda.synchronize()
t3 = time.perf_counter()
h = hashlib.sha256(res.counts.tobytes())
for s in res.ec_sets:
    h.update(s.tobytes() + b";")
print(json.dumps({"import_s": t1 - t0, "load_s": t2 - t1,
                  "quant_s": t3 - t2, "timings": res.timings,
                  "ec_digest": h.hexdigest()}))
"""


def _spread(v):
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2]}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genes", type=int, default=10_000)
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("malloc_tune_ab: no CUDA device; nothing run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)

    from kallisto_tpu_torch.index import build_index, save_index
    from kallisto_tpu_torch.ops import kernels
    from kallisto_tpu_torch.utils.benchdata import generate_paired
    from kallisto_tpu_torch.utils.simtx import generate_transcriptome

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kernels.build_all()  # every run loads these builds from _kbuild/
    work = tempfile.mkdtemp(prefix="kt_malloc_")
    try:
        fasta = os.path.join(work, "simtx.fasta.gz")
        generate_transcriptome(fasta, n_genes=args.genes, seed=42)
        t0 = time.perf_counter()
        idx_path = os.path.join(work, "index.npz")
        save_index(build_index([fasta], k=31), idx_path)
        print(f"index build + save {time.perf_counter() - t0:.1f} s",
              flush=True)
        r1, r2 = (os.path.join(work, f"sim_{m}.fastq.gz") for m in (1, 2))
        generate_paired(fasta, r1, r2, args.pairs, read_len=100,
                        frag_mean=180.0, frag_sd=20.0, error_rate=0.005)
        base_env = {key: v for key, v in os.environ.items()
                    if key not in TUNE}
        times = {a: {"process_s": [], "load_s": [], "quant_s": [],
                     "read_s": []} for a in ARMS}
        ref = None
        for i in range(args.rounds):
            order = ARMS if i % 2 == 0 else ARMS[::-1]
            for arm in order:
                env = dict(base_env, **(TUNE if arm == "tuned" else {}))
                out = os.path.join(work, f"out_{i}_{arm}")
                t0 = time.perf_counter()
                p = subprocess.run(
                    [sys.executable, "-c", _RUN, here, idx_path, r1, r2, out],
                    env=env, capture_output=True, text=True)
                wall = time.perf_counter() - t0
                if p.returncode != 0:
                    raise RuntimeError(f"round {i} {arm} failed:\n{p.stderr}")
                got = json.loads(p.stdout.strip().splitlines()[-1])
                if ref is None:
                    ref = got["ec_digest"]
                elif got["ec_digest"] != ref:
                    raise AssertionError(f"round {i} {arm}: EC counts or "
                                         "sets differ from the first run's")
                t = got["timings"]
                for key, v in (("process_s", wall), ("load_s", got["load_s"]),
                               ("quant_s", got["quant_s"]),
                               ("read_s", t["read_s"])):
                    times[arm][key].append(v)
                shutil.rmtree(out, ignore_errors=True)
                print(f"round {i} {arm}: process {wall:.3f} s, import "
                      f"{got['import_s']:.3f} s, index load "
                      f"{got['load_s']:.3f} s, quant {got['quant_s']:.3f} s; "
                      + json.dumps({key: t[key] for key in PHASES}),
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    differences = {}
    for key in ("process_s", "load_s", "quant_s", "read_s"):
        d = [x - y for x, y in zip(times["tuned"][key],
                                   times["default"][key])]
        differences[key] = {"median_s": statistics.median(d),
                            "tuned_longer_in": sum(x > 0 for x in d)}
    print(json.dumps({
        "card": smi, "pairs": args.pairs, "rounds": args.rounds,
        "times_s": times,
        "spread_s": {a: {key: _spread(v) for key, v in times[a].items()}
                     for a in ARMS},
        "tuned_minus_default": differences}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
