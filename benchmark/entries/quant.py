"""The `quant` entry: paired reads through run_quant, as `cli.py quant`
calls it; the reference's answer and the comparison.

With `options.bootstrap` B > 0 (`quant -b B`) the reference also draws and
solves the B replicates (reference/bootstrap.py) over the classes in the
order the judged output lists them, and `bootstrap_gap` compares the
program's replicates (`QuantResult.bootstraps`) with them.

An entry is a file entries/<name>.py with a class Entry(workload), named
by a workload file's "entry"; see benchmark/README.md for what it gives.
"""

import os
from typing import Tuple

import numpy as np

from kbench import traffic
from kbench.traffic import Sample


def _gap_classes(prog: dict, ref: dict) -> int:
    return int(sum(abs(prog.get(c, 0) - ref.get(c, 0))
                   for c in set(prog) | set(ref)))


class Entry:
    """`quant` of paired reads: run_quant, as `cli.py quant` calls it."""

    unit = "fragments"

    def __init__(self, wl: dict):
        self.reads, self.options = wl["reads"], wl.get("options", {})
        self.bootstrap = int(self.options.get("bootstrap", 0))
        # the seed of the replicates' seeds (quant --seed; kallisto's
        # default 42)
        self.seed = int(self.options.get("seed", 42))

    def traffic(self, cfg, pool, rng, n, tmp, tag) -> Sample:
        p = self.reads
        r1, r2 = traffic.paired(pool, rng, n, p["read_len"], p["frag_mean"],
                                p["frag_sd"], p["error_rate"],
                                p.get("expression"), p.get("positions"))
        files = [os.path.join(tmp, f"{tag}_{m}.fastq.gz") for m in (1, 2)]
        traffic.write_fastq(files[0], r1, b"a")
        traffic.write_fastq(files[1], r2, b"b")
        return Sample(files, n, (r1, r2))

    def run(self, sample: Sample, out: str, index, device):
        from kallisto_tpu_torch.common import Options
        from kallisto_tpu_torch.quant import pipeline

        opt = Options(files=sample.files, output_dir=out, **self.options)
        res = pipeline.run_quant(opt, index=index, device=device)
        kept = {"n": res.num_processed, "counts": res.counts,
                "ec_sets": res.ec_sets, "flens": res.flens,
                "est_counts": res.est_counts}
        if self.bootstrap:
            kept["bootstraps"] = res.bootstraps
        return res.num_processed, dict(res.timings), kept

    def bases(self, sample: Sample) -> Tuple[int, int]:
        """(reads, bases) the kernels read."""
        return 2 * sample.n, 2 * sample.n * self.reads["read_len"]

    def reference(self, ref, sample: Sample, control=None):
        """The reference's answer; with B > 0 it carries the sample's
        replicates, solved per class order when compare() first asks.
        The control `em_float32` runs both EMs in float32."""
        import torch

        from reference import bootstrap, runs
        from reference.em import effective_lengths

        r1, r2 = sample.data
        lens = np.full(r1.shape[0], r1.shape[1], np.int64)
        dtype = torch.float32 if control == "em_float32" else torch.float64
        ans = runs.quant(ref, r1, lens, r2, lens, em_dtype=dtype)
        if not self.bootstrap:
            return ans
        return ans._replace(boot=bootstrap.Replicates(
            ans.classes, ref.T, effective_lengths(ref.lens, ans.flens),
            self.bootstrap, self.seed, ans.est_counts, dtype, ref.device))

    def as_output(self, ans, out: str) -> dict:
        """An answer in the form run() keeps the program's output (the
        control, and the answer altered by a test, are judged so); with
        B > 0 its replicates, drawn in the order it lists the classes."""
        kept = {"n": ans.n, "counts": list(ans.classes.values()),
                "ec_sets": [np.array(c) for c in ans.classes],
                "flens": ans.flens, "est_counts": ans.est_counts}
        if self.bootstrap:
            kept["bootstraps"] = ans.boot.for_order(list(ans.classes))
        return kept

    def compare(self, kept: dict, ans, n: int) -> dict:
        prog = {tuple(int(t) for t in s): int(c)
                for s, c in zip(kept["ec_sets"], kept["counts"]) if c > 0}
        est, ref_est = np.asarray(kept["est_counts"]), ans.est_counts
        got = {
            "processed_gap": abs(int(kept["n"]) - n) + abs(ans.n - n),
            "class_count_gap": _gap_classes(prog, ans.classes),
            "fld_gap": int(np.abs(np.asarray(kept["flens"], np.int64)
                                  - ans.flens).sum()),
            "est_counts_gap": float(np.max(
                np.abs(est - ref_est) / np.maximum(ref_est, 1.0))),
        }
        if self.bootstrap:
            # max over replicates b and targets t of |bs_b[t] - ref_b[t]| /
            # max(ref_b[t], 1), ref_b drawn over the classes in the order
            # of the output's ec_sets; inf where the program gives no
            # replicates or another number of them
            bs = kept["bootstraps"]
            ref = ans.boot.for_order([tuple(int(t) for t in s)
                                      for s in kept["ec_sets"]])
            got["bootstrap_gap"] = (
                float(np.max(np.abs(bs - ref) / np.maximum(ref, 1.0)))
                if bs is not None and np.shape(bs) == ref.shape
                else float("inf"))
        return got
