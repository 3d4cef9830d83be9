"""The `bus` entry: barcode reads and single-end cDNA reads through
run_bus, as `cli.py bus -x <technology>` calls it; the reference's BUS
records and the comparison."""

import os
import struct
from collections import Counter
from typing import Tuple

import numpy as np

from kbench import traffic
from kbench.traffic import Sample


_BUS_REC = np.dtype([("barcode", "<u8"), ("UMI", "<u8"), ("ec", "<i4"),
                     ("count", "<u4"), ("flags", "<u4"), ("pad", "<u4")])


def read_bus(out: str):
    """(records, {EC id: transcripts}) of a bus output directory."""
    with open(os.path.join(out, "output.bus"), "rb") as f:
        data = f.read()
    magic, _, _, _, tlen = struct.unpack("<4sIIII", data[:20])
    if magic != b"BUS\x00":
        raise ValueError(f"{out}/output.bus is not a BUS file")
    recs = np.frombuffer(data[20 + tlen:], _BUS_REC)
    ecs = {}
    with open(os.path.join(out, "matrix.ec")) as f:
        for line in f:
            i, s = line.rstrip("\n").split("\t")
            ecs[int(i)] = tuple(int(x) for x in s.split(","))
    return recs, ecs


class Entry:
    """`bus -x <technology>` of barcode reads and single-end cDNA reads:
    run_bus, as `cli.py bus` calls it."""

    unit = "reads"

    def __init__(self, wl: dict):
        self.reads, self.options = wl["reads"], wl.get("options", {})

    def traffic(self, cfg, pool, rng, n, tmp, tag) -> Sample:
        p = self.reads
        bcs = traffic.barcode_pool(cfg["n_barcodes"], p["barcode_len"],
                                   cfg["barcode_seed"])
        r1 = traffic.barcode_reads(bcs, rng, n, p["umi_len"])
        r2 = traffic.sense(pool, rng, n, p["cdna_len"], p["frag_mean"],
                           p["frag_sd"], p["error_rate"],
                           p.get("expression"), p.get("positions"))
        files = [os.path.join(tmp, f"{tag}_{m}.fastq.gz") for m in (1, 2)]
        traffic.write_fastq(files[0], r1, b"c")
        traffic.write_fastq(files[1], r2, b"d")
        return Sample(files, n, (r1, r2))

    def run(self, sample: Sample, out: str, index, device):
        from kallisto_tpu_torch.common import Options
        from kallisto_tpu_torch.sc import bus

        opt = Options(files=sample.files, output_dir=out, **self.options)
        res = bus.run_bus(opt, index=index, device=device)
        return res.num_processed, dict(res.timings), {
            "n": res.num_processed, "out": out}

    def bases(self, sample: Sample) -> Tuple[int, int]:
        return sample.n, sample.n * self.reads["cdna_len"]

    def reference(self, ref, sample: Sample, control=None):
        from reference import runs

        r1, r2 = sample.data
        b = self.reads["barcode_len"]
        u = self.reads["umi_len"]
        return runs.bus(ref, r1[:, :b], r1[:, b:b + u], r2,
                        np.full(r2.shape[0], r2.shape[1], np.int64),
                        fingerprint_bits=int(control[len("fingerprint"):])
                        if control else None)

    @staticmethod
    def as_output(ans, out: str) -> dict:
        """An answer written as the program writes its output (output.bus,
        matrix.ec) into out."""
        os.makedirs(out, exist_ok=True)
        recs = np.zeros(ans.records.shape[0], _BUS_REC)
        for f in ("barcode", "UMI", "count", "flags"):
            recs[f] = ans.records[f]
        recs["ec"] = ans.records["cls"]
        with open(os.path.join(out, "output.bus"), "wb") as f:
            f.write(struct.pack("<4sIIII", b"BUS\x00", 1, 16, 10, 0))
            f.write(recs.tobytes())
        with open(os.path.join(out, "matrix.ec"), "w") as f:
            for c, i in sorted(ans.class_ids.items(), key=lambda x: x[1]):
                f.write(f"{i}\t{','.join(str(t) for t in c)}\n")
        return {"n": ans.n, "out": out}

    @staticmethod
    def compare(kept: dict, ans, n: int) -> dict:
        from reference.runs import REC

        recs, ecs = read_bus(kept["out"])
        # the program's EC ids -> the reference's class ids (a set the
        # reference does not have gets an id of its own below 0)
        ids = np.unique(recs["ec"])
        vals = np.empty(ids.shape[0], np.int64)
        for j, e in enumerate(ids.tolist()):
            s = ecs.get(e)
            vals[j] = ans.class_ids[s] if s in ans.class_ids else -1 - j
        cls = vals[np.searchsorted(ids, recs["ec"])]
        prog = np.zeros(recs.shape[0], REC)
        for f in ("barcode", "UMI", "count", "flags"):
            prog[f] = recs[f]
        prog["cls"] = cls
        prog.sort(order=list(REC.names))
        if prog.shape == ans.records.shape and np.array_equal(prog, ans.records):
            gap = 0
        else:
            a, b = Counter(prog.tolist()), Counter(ans.records.tolist())
            gap = sum(((a - b) + (b - a)).values())
        return {
            "processed_gap": abs(int(kept["n"]) - n) + abs(ans.n - n),
            "record_gap": int(gap),
        }
