"""A run of each cell on the CPU at a tiny size, through everything but
the look for a card: correct, every metric read; and with the timed path
broken underneath, correct comes out false."""

import ast
import os
import re
import time

import numpy as np
import pytest

import tiny
from kbench import calibrate, harness, traffic

MANIFEST = harness.with_held(
    harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")))
CELLS = tuple(w["name"] for w in MANIFEST["workloads"])


def _run(cell, tmp_path, trace_on=False):
    tmp = tmp_path / "run"
    tmp.mkdir(parents=True)
    return harness.run_cell(cell, 2**31 + 7, 0.5, trace_on, "cpu",
                            time.time(), str(tmp))


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_reports_its_metrics(name, tmp_path):
    cell = tiny.cell(name)
    out = _run(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    want = {m for m, _, _ in cell.metrics(False)}
    assert set(out["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell.wl["limits"])
    h = out["host"]
    assert h["proc_cpu_per_wall"] > 0 and h["kernel"]
    per = out["per_sample"]
    assert len(per) == out["attempted"]
    assert all(p["process"]["wall_s"] > 0 and p["timings"] for p in per)


def test_the_cache_fill_is_recorded_apart_from_setup(tmp_path, monkeypatch):
    """A checkout's first run builds the index into the cache and says how
    long that took; setup_s leaves it out, and the next run fills nothing.
    The cache is the test's own, so that no other test has filled it."""
    from kbench import deploy

    monkeypatch.setattr(deploy, "CACHE_DIR", str(tmp_path / "cache"))
    cell = tiny.cell("bulk-pe100")
    first = _run(cell, tmp_path / "a")
    assert first["cache_fill_s"] > 0
    assert first["metrics"]["setup_s"]["value"] > 0
    again = _run(cell, tmp_path / "b")
    assert "cache_fill_s" not in again


def test_entries_and_metrics_are_found_by_name(tmp_path):
    """A workload names its entry; a file of that name under entries/ is
    all the harness needs, and a name with no file is refused."""
    cell = tiny.cell("bulk-pe100")
    assert type(cell.entry).__module__ == "benchmark_entry_quant"
    wl = dict(cell.wl, entry="no_such_entry")
    with pytest.raises(SystemExit, match="entries/no_such_entry.py"):
        harness.Cell("bulk-pe100", cell.manifest, wl=wl, config=cell.config)


def test_a_held_cell_is_not_run_and_its_rows_put_it_back():
    """A cell under held/ is no cell of BENCHMARK.json, so no run takes it;
    its rows name files that are all there."""
    manifest = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    with pytest.raises(SystemExit, match="no cell 'sc-10xv2'"):
        harness.Cell("sc-10xv2", manifest)
    cell = harness.Cell("sc-10xv2", harness.with_held(manifest))
    for trace_on in (False, True):
        for _, _, path in cell.metrics(trace_on):
            assert os.path.exists(path), path
    assert {m for m, _, _ in cell.metrics(False)} == {"bus_reads_per_s",
                                                     "setup_s"}


def _keys_named(path):
    """The timings keys a reader's docstring names (timings["<key>"])."""
    with open(path) as f:
        doc = ast.get_docstring(ast.parse(f.read())) or ""
    return set(re.findall(r'timings\["(\w+)"\]', doc))


@pytest.mark.parametrize("name", CELLS)
def test_layer_metrics_read_from_the_records(name, tmp_path):
    """Each per-layer reader of host phases reads the timings keys its
    docstring names, and no other: every key has a value of its own, and a
    reading moves when a named key changes and only then. Those of the
    device trace read nothing without a trace."""
    cell = tiny.cell(name)
    source = {m["name"]: m["source"] for m in cell.manifest["per_layer"]}
    readers = {m: p for m, _, p in cell.metrics(True)}
    assert readers, "each cell has per-layer metrics"
    named = {m: _keys_named(p) for m, p in readers.items()
             if source[m] != "device_trace"}
    keys = sorted(set().union(*named.values()) | {"run_s", "unspanned_s"})
    timings = {k: float(2 ** i) for i, k in enumerate(keys, 1)}

    def rec_with(t):
        return {"entry": cell.wl["entry"], "fragments": 2_000_000,
                "trace": None, "samples": [{"timings": t}] * 2}

    for m, p in readers.items():
        v = harness.read_metric(p, rec_with(timings))
        if m not in named:
            assert v is None, m
            continue
        assert named[m], f"{m}'s reader names no timings key"
        if len(named[m]) == 1:  # a sum per sample or per million fragments
            assert v == timings[next(iter(named[m]))], m
        moved = {k for k in keys
                 if harness.read_metric(p, rec_with(
                     dict(timings, **{k: 3 * timings[k]}))) != v}
        assert moved == named[m], m


def _broken(monkeypatch, cell, fault):
    """Break the timed path underneath the harness: `stale` hands back the
    first sample's output every time (a step that returns its state
    unchanged), `altered` changes one answer where the program produced
    it."""
    run = cell.entry.run
    first = {}

    def broken(sample, out, index, device):
        frags, timings, kept = run(sample, out, index, device)
        if fault == "stale" and not out.endswith("out_warmup"):
            first.setdefault("kept", kept)
            return frags, timings, first["kept"]
        if fault == "altered":
            if "counts" in kept:
                kept["counts"] = np.array(kept["counts"]).copy()
                i = int(np.argmax(kept["counts"]))
                kept["counts"][i] -= 1
                kept["counts"][(i + 1) % len(kept["counts"])] += 1
            else:
                with open(os.path.join(out, "output.bus"), "r+b") as f:
                    data = f.read()
                    tlen = int.from_bytes(data[16:20], "little")
                    f.seek(20 + tlen)
                    f.write((int.from_bytes(data[20 + tlen:28 + tlen],
                                            "little") ^ 1).to_bytes(8, "little"))
        return frags, timings, kept

    monkeypatch.setattr(cell.entry, "run", broken)


def _half(monkeypatch, cell):
    """The program given the first half of each sample's reads (half of
    the batch left out)."""
    run = cell.entry.run

    def half(sample, out, index, device):
        m = sample.n // 2
        files = []
        for j, (p, r) in enumerate(zip(sample.files, sample.data)):
            q = p.replace(".fastq.gz", ".half.fastq.gz")
            traffic.write_fastq(q, r[:m], b"ab"[j:j + 1])
            files.append(q)
        return run(traffic.Sample(files, m, sample.data), out, index, device)

    monkeypatch.setattr(cell.entry, "run", half)


@pytest.mark.parametrize("fault", ("stale", "half", "altered"))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, tmp_path,
                                            monkeypatch):
    cell = tiny.cell(name)
    if fault == "half":
        _half(monkeypatch, cell)
    else:
        _broken(monkeypatch, cell, fault)
    out = _run(cell, tmp_path)
    assert not out["correct"], out["checks"]


# the control at the tests' tiny size, where it is not the cell's own: a
# 32-bit fingerprint makes no collision among a 40-gene index's k-mers, a
# 16-bit one does
TINY_CONTROL = {"fingerprint32": "fingerprint16"}


def _control(name):
    control = harness.load_json(os.path.join(
        harness.BENCH_DIR, "workloads", f"{name}.json"))["control"]
    return TINY_CONTROL.get(control, control)


@pytest.mark.parametrize("name,control", tuple((c, _control(c))
                                               for c in CELLS))
def test_the_control_is_not_correct(name, control, tmp_path):
    """The control (the reference one step below what the configuration
    states, in the program's place) fails a limit; the program passes on
    the same seeds."""
    cell = tiny.cell(name)
    cell.wl["control"] = control
    got = []
    calibrate.readings(cell, [11, 12], [11, 12, 13], "cpu", str(tmp_path),
                       got.append)
    limits = cell.wl["limits"]

    def passes(r):
        return all(r["checks"][k] <= limits[k] for k in limits)

    assert all(passes(r) for r in got if r["kind"] == "program")
    assert not any(passes(r) for r in got if r["kind"] == control)
