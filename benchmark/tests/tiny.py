"""The cells at a size a CPU test holds: the real workload files with a
40-gene transcriptome and samples of 3,000 fragments; the cells held out
of BENCHMARK.json (held/) too."""

import json
import os

from kbench import harness

TINY = {"n_genes": 40, "sample_size": 3000}


def cell(name: str, **over) -> "harness.Cell":
    manifest = harness.with_held(
        harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")))
    full = harness.Cell(name, manifest)
    return harness.Cell(name, manifest, wl=json.loads(json.dumps(full.wl)),
                        config=dict(full.config, **dict(TINY, **over)))
