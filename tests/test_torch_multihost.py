"""Two processes on a gloo group (parallel/multihost.py): the port's
multi-process `quant` writes the bytes of a one-process run.

Each test starts this file twice as a script (`_rank_main` at the bottom),
ranks 0 and 1 of a gloo group that meet through a file store under the
test's tmp_path (file://: no port is chosen ahead of the ranks, so no
other process can take it first); each rank
takes its contiguous share of two FASTQ pairs (bulkb0 = 1,500 pairs,
bulkb1 = 2,000), and after the rank-order merge both report the global
3,500 processed pairs while rank 0 writes.  abundance.tsv and counts.txt
must be byte-equal to the port's one-process run and to the JAX
package's, with a fixed FLD (-l 180 -s 20) and with an estimated one,
whose goal of 2,000 puts the cut of the global subsample inside rank 1's
share.  On a machine with several cards the cuda-marked test runs one
rank per card (up to four; ranks past the second get no file), each on
cuda:<rank>.

    python tests/test_torch_multihost.py RANK WORLD ADDRESS INDEX OUT \\
        [--cuda] [--est-fld] FILES...

(ADDRESS: an init_method, e.g. file:///tmp/x/rendezvous or
tcp://127.0.0.1:PORT.)
"""

import os
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
FILES = [os.path.join(DATA, f) for f in (
    "bulkb0_1.fastq.gz", "bulkb0_2.fastq.gz",
    "bulkb1_1.fastq.gz", "bulkb1_2.fastq.gz")]
COMPARED = ("abundance.tsv", "counts.txt")
# both ranks together: ~10 s alone on a CPU, a few times that beside a
# full parallel test run
RANK_TIMEOUT_S = 300


def _options(files, out, est_fld, opt_cls):
    fl = dict() if est_fld else dict(fld_mean=180.0, fld_sd=20.0)
    return opt_cls(files=files, output_dir=out, plaintext=True,
                   write_index=True, **fl)


def _run_ranks(tmp_path, est_fld, goal, world=2, cuda=False):
    """Every rank's stdout after a `world`-process run into
    tmp_path/multi."""
    from kallisto_tpu_torch.index import build_index, save_index

    idx = str(tmp_path / "idx.npz")
    save_index(build_index([os.path.join(DATA, "transcripts.fasta.gz")],
                           k=31), idx)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if goal is not None:
        env["KALLISTO_TPU_FLEN_GOAL"] = str(goal)
    addr = f"file://{tmp_path / 'rendezvous'}"
    out = str(tmp_path / "multi")
    # each rank writes to a file of its own, so that neither can block on
    # a full pipe while the other waits for it in a collective
    logs = [tmp_path / f"rank{rank}.log" for rank in range(world)]
    procs = []
    for rank in range(world):
        with open(logs[rank], "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank),
                 str(world), addr, idx, out]
                + (["--cuda"] if cuda else [])
                + (["--est-fld"] if est_fld else []) + FILES,
                env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [f.read_text(errors="replace") for f in logs]
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            pytest.fail(f"rank {rank} exited {p.returncode} (killed past "
                        f"{RANK_TIMEOUT_S} s if negative):\n" + "\n".join(
                            f"--- rank {r}:\n{x[-3000:]}"
                            for r, x in enumerate(outs)))
    return outs, out


def _check(tmp_path, monkeypatch, est_fld, goal):
    from kallisto_tpu.common import Options as JOptions
    from kallisto_tpu.quant.pipeline import run_quant as jrun_quant
    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.index import build_index
    from kallisto_tpu_torch.quant.pipeline import run_quant

    outs, multi = _run_ranks(tmp_path, est_fld, goal)
    for rank, o in enumerate(outs):
        assert f"[rank {rank}] processed=3500" in o, o[-2000:]
    if goal is not None:
        monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", str(goal))
    index = build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)
    one = str(tmp_path / "single")
    res = run_quant(_options(FILES, one, est_fld, Options), index=index,
                    device="cpu")
    assert res.num_processed == 3500
    if est_fld:
        # the estimate sampled, and the cut falls inside rank 1's share
        assert 1500 < res.flens.sum() <= goal
    jax = str(tmp_path / "jax")
    jrun_quant(_options(FILES, jax, est_fld, JOptions), index=index)
    for name in COMPARED:
        with open(os.path.join(one, name)) as f:
            want = f.read()
        for d in (multi, jax):
            with open(os.path.join(d, name)) as f:
                assert f.read() == want, (name, d)


def test_two_process_quant_fixed_fld(tmp_path, monkeypatch):
    _check(tmp_path, monkeypatch, est_fld=False, goal=None)


def test_two_process_quant_estimated_fld(tmp_path, monkeypatch):
    _check(tmp_path, monkeypatch, est_fld=True, goal=2000)


@pytest.mark.cuda
def test_quant_one_rank_per_card(tmp_path, monkeypatch):
    """One rank per card (up to four), estimated FLD: abundance.tsv and
    counts.txt byte-equal to one process on cuda:0.  Needs two cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.index import build_index
    from kallisto_tpu_torch.quant.pipeline import run_quant

    world = min(torch.cuda.device_count(), 4)
    outs, multi = _run_ranks(tmp_path, True, 2000, world, cuda=True)
    for rank, o in enumerate(outs):
        assert f"[rank {rank}] processed=3500" in o, o[-2000:]
    monkeypatch.setenv("KALLISTO_TPU_FLEN_GOAL", "2000")
    one = str(tmp_path / "single")
    run_quant(_options(FILES, one, True, Options),
              index=build_index([os.path.join(DATA, "transcripts.fasta.gz")],
                                k=31), device="cuda:0")
    for name in COMPARED:
        with open(os.path.join(one, name)) as f, \
                open(os.path.join(multi, name)) as g:
            assert f.read() == g.read(), name


def _rank_main(argv):
    """One rank: join the group, quantify this rank's share (on the CPU,
    or with --cuda on cuda:<rank>)."""
    rank, world, addr, idx, out = (int(argv[0]), int(argv[1]), argv[2],
                                   argv[3], argv[4])
    files = argv[5:]
    cuda = files[:1] == ["--cuda"]
    files = files[1:] if cuda else files
    est_fld = files[:1] == ["--est-fld"]
    files = files[1:] if est_fld else files
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from kallisto_tpu_torch.common import Options
    from kallisto_tpu_torch.index import load_index
    from kallisto_tpu_torch.quant.pipeline import run_quant

    torch.set_num_threads(1)
    if cuda:
        # as a job on cards would: NCCL for the default group (the merge
        # makes a gloo group of its own)
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=addr,
                            world_size=world, rank=rank)
    try:
        res = run_quant(_options(files, out, est_fld, Options),
                        index=load_index(idx),
                        device=f"cuda:{rank}" if cuda else "cpu")
        print(f"[rank {rank}] processed={res.num_processed} "
              f"mapped={res.num_pseudoaligned}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
