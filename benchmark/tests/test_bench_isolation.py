"""What the harness and the reference load: never JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference nothing of the program either."""

import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

_PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body: str):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(bench=BENCH, root=ROOT,
                                              body=body)],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_any_kallisto_package():
    top = _loaded("""
import os
from reference import align, bootstrap, em, kmers, runs, seqio
d = os.path.join({root!r}, "tests", "data")
names, seqs, lens = seqio.read_transcripts(os.path.join(d, "transcripts.fasta.gz"))
ref = kmers.build_ref_index(names, seqs, lens)
c1, l1 = seqio.read_fastq(os.path.join(d, "reads_1.fastq.gz"))
c2, l2 = seqio.read_fastq(os.path.join(d, "reads_2.fastq.gz"))
ans = runs.quant(ref, c1, l1, c2, l2)
bootstrap.Replicates(ans.classes, ref.T, em.effective_lengths(ref.lens, ans.flens),
                     2, 42, ans.est_counts).for_order(list(ans.classes))
""".format(root=ROOT))
    assert not top & {"jax", "jaxlib", "flax", "kallisto_tpu",
                      "kallisto_tpu_torch"}


def test_a_run_loads_no_jax():
    top = _loaded("""
import json, os, shutil, tempfile, time
sys.path.insert(0, os.path.join({bench!r}, "tests"))
from kbench import deploy, harness
import tiny
deploy.CACHE_DIR = tempfile.mkdtemp()
tmp = tempfile.mkdtemp()
out = harness.run_cell(tiny.cell("bulk-pe100"), 5, 0.1, False, "cpu",
                       time.time(), tmp)
assert out["correct"], out
shutil.rmtree(tmp); shutil.rmtree(deploy.CACHE_DIR)
""".format(bench=BENCH))
    assert "kallisto_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "kallisto_tpu"}


def test_sources_import_no_jax():
    """No file under benchmark/ names JAX or the JAX package in an
    import."""
    import re

    pat = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|kallisto_tpu)\b",
                     re.M)
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    assert not pat.search(fh.read()), f
