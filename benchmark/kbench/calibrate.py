"""The readings that a cell's limits are set from: the program against the
reference on many seeds, and the control (the reference in the program's
place, one step below what the configuration states) on a few, one
sample each at the cell's own size, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6

Prints one JSON line per reading.
"""

import argparse
import json
import os
import shutil
import tempfile

from . import deploy, harness, traffic


def readings(cell, seeds, control_seeds, device, tmp, emit):
    """emit({"seed", "kind": "program" | control name, "checks"}) for each
    seed; the control is the workload's "control" entry."""
    import kallisto_tpu_torch

    from reference import kmers, seqio

    program_dir = os.path.dirname(kallisto_tpu_torch.__file__)
    cfg, entry = cell.config, cell.entry
    fasta, index, _ = deploy.program_index(cfg, program_dir, harness.log)
    pool = deploy.read_pool(fasta)
    names, seqs, lens = seqio.read_transcripts(fasta)
    ref = kmers.build_ref_index(names, seqs, lens, k=cfg["k"], device=device)
    n = int(cfg["sample_size"])
    control = cell.wl["control"]
    for seed in sorted(set(seeds) | set(control_seeds)):
        sample = entry.traffic(cfg, pool, traffic.rng_for(seed, 1), n, tmp,
                               f"s{seed}")
        ans = entry.reference(ref, sample)
        if seed in seeds:
            out = os.path.join(tmp, f"out{seed}")
            _, _, kept = entry.run(sample, out, index, device)
            emit({"seed": seed, "kind": "program",
                  "checks": entry.compare(kept, ans, n)})
            shutil.rmtree(out, ignore_errors=True)
        if seed in control_seeds:
            out = os.path.join(tmp, f"ctl{seed}")
            kept = entry.as_output(entry.reference(ref, sample, control), out)
            emit({"seed": seed, "kind": control,
                  "checks": entry.compare(kept, ans, n)})
            shutil.rmtree(out, ignore_errors=True)
        for f in sample.files:
            os.remove(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    ints = [[int(x) for x in s.split(",") if x]
            for s in (args.seeds, args.control_seeds)]
    manifest = harness.with_held(
        harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")))
    cell = harness.Cell(args.workload, manifest)
    tmp = tempfile.mkdtemp(prefix="kbench-cal-")
    try:
        readings(cell, ints[0], ints[1], "cuda", tmp,
                 lambda r: print(json.dumps(r), flush=True))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0
