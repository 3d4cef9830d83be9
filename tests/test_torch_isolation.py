"""The port stands alone: importing any of its modules, or chip_smoke.py,
loads neither jax nor the JAX package, and its entry points want the card
unless the caller asks for the CPU."""

import json
import os
import pkgutil
import subprocess
import sys

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
              "quant.ecmap", "quant.fld", "quant.filters", "quant.em",
              "quant.pipeline"):
        assert f"kallisto_tpu_torch.{m}" in mods, m


def test_imports_load_no_jax_and_no_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
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
    assert kernels.LAUNCHES == before
