"""The port's host-only subcommands against the JAX package's CLI.

`inspect`, `h5dump`, `version`, `cite`, `pseudo` and `merge` run through
kallisto_tpu/cli.py and kallisto_tpu_torch/cli.py on the same inputs (one
index file built from the bundled transcripts for `inspect`, one
abundance.h5 with bootstraps for `h5dump`): stdout, the stderr lines,
every written file and the exit code must be equal.
"""

import os
import sys

import numpy as np
import pytest

from kallisto_tpu import cli as jcli
from kallisto_tpu.io.h5 import write_abundance_h5
from kallisto_tpu_torch import cli as tcli

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def index_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("idx") / "idx.npz")
    assert tcli.main(["index", "-i", path,
                      os.path.join(DATA, "transcripts.fasta.gz")]) == 0
    return path


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    T = 40
    path = str(tmp_path_factory.mktemp("h5") / "abundance.h5")
    write_abundance_h5(
        path, rng.random(T) * 100, [f"tx{i}" for i in range(T)],
        rng.integers(200, 3000, T), rng.random(T) * 1000 + 100,
        np.zeros(1000, np.int32), np.zeros(4096, np.int32),
        np.zeros(4096), 3, 12345, "0.51.1", 13, "Sat Oct 17 2026",
        "kallisto quant -i idx -o out r1.fq r2.fq",
        bootstraps=rng.random((3, T)) * 100)
    return path


def _run(main, argv, capsys):
    """(exit code, stdout, stderr lines) of one CLI call; a sys.exit with
    a message exits 1 with the message on stderr, as the interpreter
    would."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
    out, err = capsys.readouterr()
    return rc, out, err.splitlines()


def _files(d):
    got = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            got[name] = f.read()
    return got


@pytest.mark.parametrize("cmd", ["version", "cite", "pseudo", "merge"])
def test_plain_subcommands_match_jax(capsys, cmd):
    want = _run(jcli.main, [cmd], capsys)
    got = _run(tcli.main, [cmd], capsys)
    assert got == want
    assert want[0] == (1 if cmd in ("pseudo", "merge") else 0)
    assert (want[1] if want[0] == 0 else want[2])


def test_inspect_matches_jax(capsys, index_file):
    want = _run(jcli.main, ["inspect", index_file], capsys)
    got = _run(tcli.main, ["inspect", index_file], capsys)
    assert got == want
    assert want[0] == 0 and "[inspect] Index version number = 13" in want[1]
    assert want[2][0] == "[index] k-mer length: 31"


def test_h5dump_matches_jax(capsys, tmp_path, h5_file):
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        d = str(tmp_path / name)
        outs[name] = (_run(main, ["h5dump", "-o", d, h5_file], capsys),
                      _files(d))
    assert outs["port"] == outs["jax"]
    (rc, _, _), files = outs["jax"]
    assert rc == 0
    assert set(files) == {"abundance.tsv", "run_info.json",
                          "bs_abundance_0.tsv", "bs_abundance_1.tsv",
                          "bs_abundance_2.tsv"}


def test_missing_index_matches_jax(capsys, tmp_path):
    missing = str(tmp_path / "nope.npz")
    want = _run(jcli.main, ["inspect", missing], capsys)
    got = _run(tcli.main, ["inspect", missing], capsys)
    assert got == want and want[0] == 1


@pytest.mark.parametrize("tune", ["on", "opted_out"])
@pytest.mark.parametrize("cmd", [["version"], ["cite"], ["pseudo"],
                                 ["inspect", "missing.idx"]])
def test_entry_module_matches_jax(tmp_path, cmd, tune):
    """`python -m <package>.cli`: both CLIs re-execute themselves with
    glibc's allocator settings (or not, under KALLISTO_TPU_NO_MALLOC_TUNE=1)
    and give the same stdout, stderr and exit code."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MALLOC_MMAP_MAX_", "MALLOC_TRIM_THRESHOLD_",
                        "KALLISTO_TPU_NO_MALLOC_TUNE")}
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    if tune == "opted_out":
        env["KALLISTO_TPU_NO_MALLOC_TUNE"] = "1"
    out = []
    for mod in ("kallisto_tpu_torch.cli", "kallisto_tpu.cli"):
        p = subprocess.run([sys.executable, "-m", mod] + cmd, env=env,
                           cwd=str(tmp_path), capture_output=True, text=True)
        out.append((p.returncode, p.stdout, p.stderr))
    assert out[0] == out[1]


@pytest.mark.parametrize("case", ["entry", "imported", "opted_out",
                                  "already_on"])
def test_malloc_tune_argv(monkeypatch, case):
    """The re-exec decision: only this CLI as the entry module, without
    the opt-out and with the settings not yet on, re-executes itself as
    `python -m kallisto_tpu_torch.cli <its arguments>`."""
    import types

    name = "pytest" if case == "imported" else "kallisto_tpu_torch.cli"
    main = types.ModuleType("__main__")
    main.__spec__ = types.SimpleNamespace(name=name)
    monkeypatch.setitem(sys.modules, "__main__", main)
    monkeypatch.setattr(sys, "argv", ["cli.py", "quant", "-i", "x"])
    for k in ("MALLOC_MMAP_MAX_", "KALLISTO_TPU_NO_MALLOC_TUNE"):
        monkeypatch.delenv(k, raising=False)
    if case == "opted_out":
        monkeypatch.setenv("KALLISTO_TPU_NO_MALLOC_TUNE", "1")
    if case == "already_on":
        monkeypatch.setenv("MALLOC_MMAP_MAX_", "0")
    got = tcli._malloc_tune_argv()
    if case == "entry":
        assert got == [sys.executable, "-m", "kallisto_tpu_torch.cli",
                       "quant", "-i", "x"]
    else:
        assert got is None
