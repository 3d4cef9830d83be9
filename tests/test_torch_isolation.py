"""The port stands alone: importing any of its modules, chip_smoke.py,
hw1_switch_ab.py or malloc_tune_ab.py loads neither jax nor the JAX
package, and its entry points want the card unless the caller asks for
the CPU."""

import json
import os
import pkgutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import kallisto_tpu_torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _port_modules():
    names = ["kallisto_tpu_torch"]
    for m in pkgutil.walk_packages(kallisto_tpu_torch.__path__,
                                   "kallisto_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("common", "cli", "io.fastx", "io.writers", "utils.mt19937",
              "utils.simtx", "utils.benchdata", "index.kmers",
              "index.sanitize", "index.build", "index.format",
              "ops.pseudoalign", "ops.kernels", "ops.host_fallback",
              "ops.turbo", "ops.anchor", "io.h5", "io.bam",
              "sc.bus", "sc.technologies",
              "quant.ecmap", "quant.fld", "quant.filters", "quant.em",
              "quant.bias", "quant.bootstrap", "quant.pipeline",
              "quant.longread", "quant.tcc", "quant.genemodel",
              "io.pseudobam", "ops.hostprobe", "io.native", "parallel",
              "parallel.mesh", "parallel.multihost", "parallel.dryrun"):
        assert f"kallisto_tpu_torch.{m}" in mods, m


def test_imports_load_no_jax_and_no_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import hw1_switch_ab\n"
        "import malloc_tune_ab\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "             or m == 'kallisto_tpu' or m.startswith('kallisto_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, check=True)
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_package():
    pkg = os.path.join(ROOT, "kallisto_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            for line in open(os.path.join(dirpath, f)):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    assert "jax" not in s and "kallisto_tpu." not in s \
                        and s.split()[1] != "kallisto_tpu", (f, s)


def test_host_probe_loads_nothing_of_the_jax_native_library():
    """The port's host probe and native reader are its own
    (csrc/hostprobe.cpp and csrc/ktio.cpp, built into
    kallisto_tpu_torch/_kbuild/): after a quant run with host wave 1 on,
    which reads its FASTQs through the native reader, and a call of each
    native build helper, the process has mapped no library of
    kallisto_tpu/native/."""
    code = (
        "import json, os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "os.environ['KALLISTO_TPU_HOST_WAVE1'] = '1'\n"
        "from kallisto_tpu_torch.common import Options\n"
        "from kallisto_tpu_torch.index import build_index\n"
        "from kallisto_tpu_torch.quant.pipeline import run_quant\n"
        f"d = {os.path.join(HERE, 'data')!r}\n"
        "idx = build_index([os.path.join(d, 'transcripts.fasta.gz')])\n"
        "r = run_quant(Options(files=[os.path.join(d, 'reads_1.fastq.gz'),\n"
        "    os.path.join(d, 'reads_2.fastq.gz')]), index=idx, device='cpu')\n"
        "import numpy as np\n"
        "from kallisto_tpu_torch.io import native\n"
        "c = np.zeros(1 << 16, np.uint8)\n"
        "native.kmer_scan(c, 31, 2)\n"
        "native.revcomp64(c.astype(np.uint64), 31, 2)\n"
        "native.u64_lookup(np.zeros(1, np.uint64), np.array([0, 1]), 0,\n"
        "                  c.astype(np.uint64), 2)\n"
        "maps = open('/proc/self/maps').read()\n"
        "libs = sorted({l.split()[-1] for l in maps.splitlines()\n"
        "               if l.split()[-1].endswith('.so')})\n"
        "print(json.dumps([r.timings['hw1pb'], libs]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, check=True)
    hw1pb, libs = json.loads(p.stdout.strip().splitlines()[-1])
    assert hw1pb > 0
    for name in ("libhostprobe_", "libktreader_", "libecresolve_"):
        ours = [x for x in libs if name in x]
        assert ours and all(
            os.path.join("kallisto_tpu_torch", "_kbuild") in x for x in ours)
    native = os.path.join(ROOT, "kallisto_tpu", "native")
    assert not [x for x in libs if x.startswith(native) or "libktio" in x]


def test_sources_load_no_jax_native_library():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "kallisto_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu")):
                text = open(os.path.join(dirpath, f)).read()
                assert "libktio" not in text and "ktio_wave1" not in text, f


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        kallisto_tpu_torch.default_device()
    with pytest.raises(RuntimeError):
        kallisto_tpu_torch.resolve_device("cuda")
    assert kallisto_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_device_index_and_quant_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.index import build_index
    from kallisto_tpu_torch.ops.pseudoalign import device_index_from_host
    from kallisto_tpu_torch.quant.pipeline import run_quant

    index = build_index([os.path.join(HERE, "data", "transcripts.fasta.gz")])
    with pytest.raises(RuntimeError):
        device_index_from_host(index)
    with pytest.raises(RuntimeError):
        run_quant(Options(files=[os.path.join(HERE, "data", "reads_1.fastq.gz"),
                                 os.path.join(HERE, "data", "reads_2.fastq.gz")]),
                  index=index)


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the rest of the repo, the script
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    from kallisto_tpu_torch.ops import kernels
    from kallisto_tpu_torch.ops.pseudoalign import SideResult

    z = torch.zeros(4, dtype=torch.int32)
    s = SideResult(torch.zeros((4, 2), dtype=torch.int32), z,
                   *(torch.zeros(4, dtype=torch.bool),) * 2, z, z, z, z,
                   torch.zeros(4, dtype=torch.bool), z)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        kernels.read_keys(s, None, 31)
    didx = SimpleNamespace(kmer_hkeys=torch.zeros(4, dtype=torch.int64),
                           device=torch.device("cpu"))
    with pytest.raises(ValueError):
        kernels.pseudoalign_long(didx, torch.zeros((4, 8), dtype=torch.uint8),
                                 torch.zeros((4, 4), dtype=torch.uint8), z,
                                 31, 32, 2, 128)
    with pytest.raises(ValueError):
        kernels.pseudoalign_codes(didx, torch.zeros((4, 40), dtype=torch.uint8),
                                  z, 31, 10)
    import numpy as np

    from kallisto_tpu_torch.quant import em as tem

    p = tem.build_em_problem([np.array([0], np.int32),
                              np.array([0, 1], np.int32)], 2)
    prob = tem.device_em_problem(p, np.zeros((1, 2)), np.ones((1, 1)),
                                 np.ones(2), "cpu")
    with pytest.raises(ValueError):
        kernels.EmGraph(prob, torch.zeros((2, 2, 1), dtype=torch.float64),
                        torch.zeros(7, dtype=torch.int64),
                        torch.zeros(1, dtype=torch.int32), 0, 1)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("module", ["io.native", "ops.hostprobe",
                                    "quant.ecresolve"])
def test_host_library_without_its_compiler_raises(monkeypatch, tmp_path,
                                                  module):
    """No fallback: where g++ is missing the native reader (and the host
    probe, and the EC resolver) raise instead of reading with Python."""
    import importlib

    mod = importlib.import_module(f"kallisto_tpu_torch.{module}")
    monkeypatch.setattr(mod, "_BUILD_DIR", str(tmp_path))
    if module == "io.native":
        monkeypatch.setattr(mod, "_libs", {})
        monkeypatch.setattr(mod, "_CXX", "no-such-g++")
        with pytest.raises(OSError):
            mod.NativeFastqReader(os.path.join(HERE, "data",
                                               "reads_1.fastq.gz"), 10)
        from kallisto_tpu_torch.io.fastx import packed_single_batches

        with pytest.raises(OSError):
            next(packed_single_batches(
                os.path.join(HERE, "data", "reads_1.fastq.gz"), 10, 31))
    else:
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(OSError):
            mod.load()
