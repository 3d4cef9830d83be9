"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything a cell needs is found by name: its entry in BENCHMARK.json,
benchmark/workloads/<cell>.json (traffic, entry, options, limits),
benchmark/configs/<config>.json (the deployment), the entry it drives,
benchmark/entries/<entry>.py, and one reader a metric,
benchmark/metrics/<metric>.py.
"""

import argparse
import ast
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from . import deploy, host, readers, trace, traffic

BENCH_DIR = deploy.BENCH_DIR
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "kallisto_tpu")
WINDOW_SPAN = "benchmark.window"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_start_wall() -> float:
    """The wall time at which this process started (its exec'd image keeps
    the start of the process), from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def cli_malloc_env(program_dir: str) -> dict:
    """The allocator settings `python -m kallisto_tpu_torch.cli` gives
    itself: every os.environ["MALLOC_..."] = "<value>" in its cli.py."""
    with open(os.path.join(program_dir, "cli.py")) as f:
        tree = ast.parse(f.read())
    env = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t, v = node.targets[0], node.value
        if (isinstance(t, ast.Subscript) and ast.unparse(t.value) == "os.environ"
                and isinstance(t.slice, ast.Constant)
                and str(t.slice.value).startswith("MALLOC_")
                and isinstance(v, ast.Constant)):
            env[t.slice.value] = str(v.value)
    return env


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def with_held(manifest: dict) -> dict:
    """The manifest with the rows of each cell held out of it
    (benchmark/held/<cell>.json: the rows that would put the cell back),
    for the tests and the calibration; a run takes BENCHMARK.json alone."""
    out = json.loads(json.dumps(manifest))
    held_dir = os.path.join(BENCH_DIR, "held")
    for fn in sorted(os.listdir(held_dir)) if os.path.isdir(held_dir) else ():
        held = load_json(os.path.join(held_dir, fn))
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            have = {r["name"] for r in out[key]}
            out[key] += [r for r in held[key] if r["name"] not in have]
    return out


class Cell:
    """A cell as the files name it."""

    def __init__(self, name: str, manifest: dict, wl=None, config=None):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
        self.name, self.entry_row = name, cells[name]
        self.chips = int(self.entry_row["chips"])
        self.wl = wl or load_json(
            os.path.join(BENCH_DIR, "workloads", f"{name}.json"))
        confs = {c["name"]: c for c in manifest["configs"]}
        self.config = config or load_json(os.path.join(
            ROOT, confs[self.entry_row["config"]]["file"]))
        self.entry = load_file(os.path.join(
            BENCH_DIR, "entries", self.wl["entry"] + ".py"),
            "benchmark_entry_").Entry(self.wl)
        self.manifest = manifest

    def metrics(self, trace_on: bool):
        """(name, unit, reader path) of each metric this cell reports."""
        rows = self.manifest["per_layer" if trace_on else "end_to_end"]
        e2e = {m["name"]: m for m in self.manifest["end_to_end"]}

        def mine(m):
            if "workloads" in m:
                return self.name in m["workloads"]
            if trace_on:  # reported wherever its end-to-end metric is
                return mine(e2e[m["moves"]])
            return True
        return [(m["name"], m["unit"],
                 os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))
                for m in rows if mine(m)]


def load_file(path: str, prefix: str):
    """The module of one file found by name (an entry, a metric's reader)."""
    if not os.path.exists(path):
        raise SystemExit(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        prefix + os.path.basename(path)[:-3].replace(".", "_").replace(
            "-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(path: str, rec: dict):
    return load_file(path, "benchmark_metric_").read(rec)


def card_info():
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return name, limit


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
             t_start: float, tmp: str) -> dict:
    """Set up, run the window, check and measure; returns the result."""
    import torch

    import kallisto_tpu_torch
    from kallisto_tpu_torch.ops import kernels

    program_dir = os.path.dirname(kallisto_tpu_torch.__file__)
    cfg, wl, entry = cell.config, cell.wl, cell.entry
    on_card = torch.device(device).type == "cuda"
    if on_card:
        built = kernels.build_all()
        log(f"kernels ready in {built:.1f} s")
    fasta, index, fill_s = deploy.program_index(cfg, program_dir, log)
    pool = deploy.read_pool(fasta)
    n = int(cfg["sample_size"])
    batch = int(wl.get("options", {}).get("batch_size", 1 << 18))
    # the warm-up runs a full batch per read (the FLD is learned there),
    # a full batch in the steady state and the samples' last partial batch
    n_warm = min(n, 2 * batch) + n % batch
    t0 = time.perf_counter()
    # the warm-up's reads and the two samples', each from its own stream
    # of the seed, made side by side (NumPy and zlib release the GIL)
    with ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(entry.traffic, cfg, pool, traffic.rng_for(seed, s),
                          size, tmp, tag)
                for s, size, tag in ((0, n_warm, "warmup"), (1, n, "sample1"),
                                     (2, n, "sample2"))]
        warm, *samples = [f.result() for f in futs]
    del pool
    log(f"traffic made in {time.perf_counter() - t0:.1f} s")
    entry.run(warm, os.path.join(tmp, "out_warmup"), index, device)
    shutil.rmtree(os.path.join(tmp, "out_warmup"), ignore_errors=True)
    gc.collect()  # set-up's garbage, not the window's
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # the window: a closed loop of samples, the next starting when the
    # last ends, until `seconds` have passed and both samples have run;
    # the one under way finishes
    runs = []
    prof_path = os.path.join(tmp, "trace.json")
    h0 = host.snapshot()
    w0 = time.perf_counter()
    # a checkout's first run also fills the deployment cache (the
    # transcriptome and the program's index): recorded apart, so that
    # setup_s is the same work in every run
    setup_s = time.time() - t_start - fill_s
    with trace.profiled(trace_on, prof_path):
        with trace.span(WINDOW_SPAN, trace_on):
            while True:
                i = len(runs)
                out = os.path.join(tmp, f"out{i}")
                p0 = host.process_times()
                with trace.span(f"sample.run_{wl['entry']}", trace_on):
                    frags, timings, kept = entry.run(samples[i % 2], out,
                                                     index, device)
                if on_card:
                    torch.cuda.synchronize()
                runs.append({"fragments": frags, "timings": timings,
                             "kept": kept, "sample": i % 2,
                             "end_s": time.perf_counter() - w0,
                             "process": host.process_delta(
                                 p0, host.process_times())})
                if time.perf_counter() - w0 >= seconds and i >= 1:
                    break
    window_s = time.perf_counter() - w0
    host_rec = dict(host.delta(h0, host.snapshot()), **host.placement())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr = trace.read_trace(prof_path, WINDOW_SPAN) if trace_on else None
    del index
    if on_card:
        torch.cuda.empty_cache()
    log(f"window {window_s:.2f} s, {len(runs)} samples; checking")

    # the check: every sample's output against the reference's answer to
    # its input, after the window, on the same device
    from reference import kmers, seqio

    t1 = time.perf_counter()
    names, seqs, lens = seqio.read_transcripts(fasta)
    ref = kmers.build_ref_index(names, seqs, lens, k=cfg["k"], device=device)
    answers = [entry.reference(ref, s) for s in samples]
    del ref
    checks = {}
    for r in runs:
        got = entry.compare(r.pop("kept"), answers[r["sample"]], n)
        for k, v in got.items():
            checks[k] = max(checks.get(k, v), v)
    log(f"reference and comparison in {time.perf_counter() - t1:.1f} s")
    limits = wl["limits"]
    correct = all(checks[k] <= limits[k] for k in limits) and \
        set(checks) == set(limits)

    rec = {
        "cell": cell.name, "entry": wl["entry"], "setup_s": setup_s,
        "window_s": window_s, "program_dir": program_dir,
        "samples": [dict(r, **{"distinct_kmers":
                               answers[r["sample"]].distinct_kmers,
                               "reads_bases": entry.bases(samples[r["sample"]])})
                    for r in runs],
        "fragments": sum(r["fragments"] for r in runs), "trace": tr,
    }
    metrics = {}
    for name, unit, path in cell.metrics(trace_on):
        v = read_metric(path, rec)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    kind, limit = card_info() if on_card else ("cpu", "none")
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                "count": cell.chips, "memory_peak_bytes": int(peak),
                "power_limit_w": limit}
    out = {"correct": bool(correct), "attempted": len(runs), "failed": 0,
           "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"], dev_info["window_s"] = tr["busy_s"], tr["window_s"]
        program = readers.program_kernels(program_dir)
        for op, sec in sorted(tr["device_ops"].items(), key=lambda x: -x[1]):
            kind = tr["kinds"][op]
            if kind == "kernel":
                kind = readers.classify(op, program)
            log(f"device op {sec:.6f} s {kind}: {op[:160]}")
        top = sorted(tr["device_ops"].items(), key=lambda x: -x[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                            "idle_gaps": tr["idle_gaps"]}
    # each sample's end in the window (s), to tell a slow sample from a
    # slow process
    out["sample_ends_s"] = [r["end_s"] for r in runs]
    # each sample's host phases and the process's CPU time, faults and
    # switches in it, to tell which phase of a slow run was slow, and why
    out["per_sample"] = [{"timings": r["timings"], "process": r["process"]}
                         for r in runs]
    # the host as the process found it, to tell a slow host from slow work
    out["host"] = host_rec
    if fill_s:
        out["cache_fill_s"] = fill_s
    out["checks"] = {k: {"value": checks.get(k), "limit": limits[k]}
                     for k in limits}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start_wall()
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(args.workload, manifest)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and has no "
            "CPU fallback")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    tmp = tempfile.mkdtemp(prefix="kbench-")
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t_start, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if found:
        log(f"refused: the run loaded {found}")
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
