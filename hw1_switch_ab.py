#!/usr/bin/env python3
"""Host wave 1 against the card's anchor route: alternating `quant` runs.

    python3 hw1_switch_ab.py [--genes 10000] [--pairs 1000000] [--rounds 10]

Builds the transcriptome and the read pairs of chip_smoke.py's phase 2
(same generators, seeds and sizes), then runs `quant` of the pairs once
per arm in each of `rounds` rounds on one CUDA card, the arms' order
rotating from round to round so that no arm always runs first:

- `hw1`: KALLISTO_TPU_HOST_WAVE1=1 (host wave 1);
- `anchor`: KALLISTO_TPU_HOST_WAVE1=0 (the card's anchor route);
- `anchor_full_exemplars`: the anchor route with the slim fetch taken out
  of its key-table part (quant/pipeline.py _table_part), so that every
  new key is resolved from its full exemplar row, as the route did before
  it read kernel F's slim rows.

Every run's EC counts and sets must equal the first run's.  Prints the
card's name and power limit, one line per run (wall and host seconds by
phase), and last one JSON object with each arm's walls and resolve_s,
their medians and quartiles, and per pair of arms the median of the
per-round differences and the rounds in which the first arm was longer.
The `hw1` - `anchor` pair sets the switch's default (quant/pipeline.py
_HOST_WAVE1_DEFAULT).
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ARMS = ("hw1", "anchor", "anchor_full_exemplars")
PHASES = ("read_s", "resolve_s", "fetch_s", "dispatch_s", "probe_s",
          "index_upload_s", "em_s")


def _spread(v):
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2]}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genes", type=int, default=10_000)
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("hw1_switch_ab: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.index import build_index
    from kallisto_tpu_torch.ops import hostprobe, kernels
    from kallisto_tpu_torch.quant import pipeline
    from kallisto_tpu_torch.utils.benchdata import generate_paired
    from kallisto_tpu_torch.utils.simtx import generate_transcriptome

    table_part = pipeline._table_part

    def full_exemplars_part(*a, **kw):
        part, valid = table_part(*a, **kw)
        return part[:5] + (None,), valid

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kernels.build_all()
    hostprobe.load()
    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="kt_ab_")
    try:
        fasta = os.path.join(work, "simtx.fasta.gz")
        generate_transcriptome(fasta, n_genes=args.genes, seed=42)
        t0 = time.perf_counter()
        index = build_index([fasta], k=31)
        print(f"index build {time.perf_counter() - t0:.1f} s", flush=True)
        r1, r2 = (os.path.join(work, f"sim_{m}.fastq.gz") for m in (1, 2))
        generate_paired(fasta, r1, r2, args.pairs, read_len=100,
                        frag_mean=180.0, frag_sd=20.0, error_rate=0.005)
        walls = {a: [] for a in ARMS}
        resolve = {a: [] for a in ARMS}
        ref = None
        for i in range(args.rounds):
            j = i % len(ARMS)
            for arm in ARMS[j:] + ARMS[:j]:
                os.environ["KALLISTO_TPU_HOST_WAVE1"] = \
                    "1" if arm == "hw1" else "0"
                if arm == "anchor_full_exemplars":
                    pipeline._table_part = full_exemplars_part
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = pipeline.run_quant(
                        Options(files=[r1, r2], plaintext=True), index=index,
                        device=dev)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    pipeline._table_part = table_part
                got = (res.counts.tolist(), [s.tolist() for s in res.ec_sets])
                if ref is None:
                    ref = got
                elif got != ref:
                    raise AssertionError(f"round {i} {arm}: EC counts or sets "
                                         "differ from the first run's")
                t = res.timings
                walls[arm].append(wall)
                resolve[arm].append(t["resolve_s"])
                print(f"round {i} {arm}: wall {wall:.3f} s; " + json.dumps(
                    {key: t[key] for key in PHASES}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    differences = {}
    for a, b in (("hw1", "anchor"), ("anchor", "anchor_full_exemplars")):
        for name, v in (("wall", walls), ("resolve_s", resolve)):
            d = [x - y for x, y in zip(v[a], v[b])]
            differences[f"{name} {a} - {b}"] = {
                "median_s": statistics.median(d),
                "first_longer_in": sum(x > 0 for x in d)}
    print(json.dumps({
        "card": smi, "pairs": args.pairs, "rounds": args.rounds,
        "wall_s": walls, "resolve_s": resolve,
        "wall_spread_s": {a: _spread(walls[a]) for a in ARMS},
        "resolve_spread_s": {a: _spread(resolve[a]) for a in ARMS},
        "differences": differences}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
