"""The span and counter helper (kallisto_tpu_torch/utils/spans.py): a run's
spans on the profiler's clock nest as the phases do and sum to the run's
timings, the resolver's key-cache counters count, `unspanned_s` is the rest
of the run, the outputs do not depend on the profiler, and outside a run
the helper does nothing."""

import json
import os
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kallisto_tpu_torch.common import Options
from kallisto_tpu_torch.index import build_index
from kallisto_tpu_torch.quant import pipeline as tpipe
from kallisto_tpu_torch.quant.pipeline import run_quant
from kallisto_tpu_torch.sc.bus import run_bus
from kallisto_tpu_torch.utils import spans

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
R1 = os.path.join(DATA, "reads_1.fastq.gz")
R2 = os.path.join(DATA, "reads_2.fastq.gz")
LR = os.path.join(DATA, "reads_lr.fastq.gz")
SC = [os.path.join(DATA, f) for f in ("sc_reads_1.fastq.gz",
                                      "sc_reads_2.fastq.gz")]

# span -> (its parent span, the timings key it adds to)
QUANT_SPANS = {
    "quant.run": (None, "run_s"),
    "quant.index_upload": ("quant.run", "index_upload_s"),
    "quant.index_upload.prep": ("quant.index_upload", "index_prep_s"),
    "quant.read_loop": ("quant.run", "pseudoalign_s"),
    "quant.read": ("quant.read_loop", "read_s"),
    "quant.dispatch": ("quant.read_loop", "dispatch_s"),
    "quant.probe": ("quant.dispatch", "probe_s"),
    "quant.fetch": ("quant.read_loop", "fetch_s"),
    "quant.resolve": ("quant.read_loop", "resolve_s"),
    "quant.resolve.per_read": ("quant.resolve", "resolve_per_read_s"),
    "quant.resolve.new_keys": ("quant.resolve", "resolve_new_s"),
    "quant.em_problem": ("quant.run", "em_problem_s"),
    "quant.bias_tables": ("quant.run", "bias_tables_s"),
    "quant.em": ("quant.run", "em_s"),
    "quant.bias_update": ("quant.em", "bias_update_s"),
    "quant.bootstrap": ("quant.run", "bootstrap_s"),
    "quant.write": ("quant.run", "write_s"),
}
BUS_SPANS = {
    "bus.run": (None, "run_s"),
    "bus.index_upload": ("bus.run", "index_upload_s"),
    "bus.index_upload.prep": ("bus.index_upload", "index_prep_s"),
    "bus.read": ("bus.run", "read_s"),
    "bus.extract": ("bus.run", "extract_s"),
    "bus.pseudoalign": ("bus.run", "pseudoalign_s"),
    "bus.resolve": ("bus.run", "resolve_s"),
    "bus.write": ("bus.run", "write_s"),
}
# the runs: options, environment, a small bias goal (None: as is), and the
# spans the run opens.  "steady": the per-read route while the FLD is
# learned, then the anchor route; "every": --bias per read up to its goal,
# then host wave 1 (its probe; hw1pb while the FLD is learned, then hw1),
# bootstraps and the writers
RUNS = {
    "steady": (dict(files=[R1, R2], batch_size=1024, plaintext=True),
               {"KALLISTO_TPU_HOST_WAVE1": "0",
                "KALLISTO_TPU_FLEN_GOAL": "1000"}, None,
               set(QUANT_SPANS) - {"quant.probe", "quant.bias_tables",
                                   "quant.bias_update", "quant.bootstrap"}),
    "every": (dict(files=[R1, R2], batch_size=1024, plaintext=True,
                   bias=True, bootstrap=2, seed=42),
              {"KALLISTO_TPU_HOST_WAVE1": "1",
               "KALLISTO_TPU_FLEN_GOAL": "1000"}, 3000, set(QUANT_SPANS)),
}


@pytest.fixture(scope="module")
def port_index():
    return build_index([os.path.join(DATA, "transcripts.fasta.gz")], k=31)


def _annotations(path):
    """name -> [(start, end)] of a Chrome trace's user_annotation ranges
    but the warm-up's, in seconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = defaultdict(list)
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e["name"] != "warm_up"):
            t = float(e["ts"]) / 1e6
            out[e["name"]].append((t, t + float(e["dur"]) / 1e6))
    return out


def _profiled(fn, path):
    """fn() under a CPU profiler: (its result, its ranges).  A process's
    first range sets up the profiler's op (~1 ms inside the range); the
    warm-up takes it, so that no span of fn() does."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm_up"):
            pass
        res = fn()
    prof.export_chrome_trace(path)
    return res, _annotations(path)


@pytest.fixture(scope="module")
def runs(port_index, tmp_path_factory):
    """Each RUNS entry without a profiler and under one: (plain result,
    profiled result, the profiled run's ranges, the two output dirs)."""
    got = {}
    for name, (kw, env, bias_goal, _) in RUNS.items():
        d = tmp_path_factory.mktemp(name)
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            if bias_goal is not None:
                mp.setattr(tpipe, "_BIAS_GOAL", bias_goal)

            def run(out):
                return run_quant(Options(output_dir=str(d / out), **kw),
                                 index=port_index, device="cpu")

            plain = run("plain")
            prof, ann = _profiled(lambda: run("prof"), str(d / "trace.json"))
        got[name] = (plain, prof, ann, d / "plain", d / "prof")
    return got


def _check_nesting(ann, table):
    for name, ivs in ann.items():
        if name not in table or table[name][0] is None:
            continue
        parents = ann[table[name][0]]
        for a, b in ivs:
            assert any(pa <= a + 1e-6 and b <= pb + 1e-6
                       for pa, pb in parents), (name, a, b)


def _check_sums(ann, table, timings):
    for name, ivs in ann.items():
        if name in table:
            key = table[name][1]
            total = sum(b - a for a, b in ivs)
            assert abs(total - timings[key]) <= 1e-3 * len(ivs), \
                (name, total, timings[key])


@pytest.mark.parametrize("case", sorted(RUNS))
def test_the_spans_are_the_table_s(runs, case):
    ann = runs[case][2]
    assert set(ann) == RUNS[case][3]
    assert len(ann["quant.run"]) == 1


@pytest.mark.parametrize("case", sorted(RUNS))
def test_each_span_lies_inside_its_parent(runs, case):
    _check_nesting(runs[case][2], QUANT_SPANS)


@pytest.mark.parametrize("case", sorted(RUNS))
def test_span_sums_equal_the_timings(runs, case):
    """Each key is the sum of its span's ranges; a key whose span never
    opened stays 0."""
    _, res, ann, _, _ = runs[case]
    _check_sums(ann, QUANT_SPANS, res.timings)
    for name, (_, key) in QUANT_SPANS.items():
        if name not in ann:
            assert res.timings[key] == 0.0, key


@pytest.mark.parametrize("case", sorted(RUNS))
def test_unspanned_is_the_rest_of_the_run(runs, case):
    """unspanned_s is run_s less the union of the phase spans (a probe
    inside a dispatch counted once), in both runs."""
    plain, res, ann, _, _ = runs[case]
    for t in (plain.timings, res.timings):
        assert 0 <= t["unspanned_s"] < t["run_s"]
    iv = sorted(x for n in tpipe._PHASES for x in ann.get(f"quant.{n}", []))
    covered, end = 0.0, -np.inf
    for a, b in iv:
        if b > end:
            covered += b - max(a, end)
            end = b
    run_a, run_b = ann["quant.run"][0]
    assert abs((run_b - run_a - covered) - res.timings["unspanned_s"]) \
        <= 1e-3 * (len(iv) + 1)


@pytest.mark.parametrize("case", sorted(RUNS))
def test_the_key_cache_counts(runs, case):
    """Both runs reach the compact routes: keys looked up in the
    resolver's cache and keys found there."""
    for res in runs[case][:2]:
        t = res.timings
        assert 0 < t["ec_cache_hits"] <= t["ec_cache_lookups"], t
        assert t["ec_cache_lookups"] >= t["n_uniq_sum"]


@pytest.mark.parametrize("case", sorted(RUNS))
def test_outputs_equal_with_the_profiler_on_and_off(runs, case):
    plain, prof, _, d_plain, d_prof = runs[case]
    names = sorted(os.listdir(d_plain))
    assert names == sorted(os.listdir(d_prof)) and "abundance.tsv" in names
    for f in names:
        if f != "run_info.json":  # it holds the start time
            with open(d_plain / f, "rb") as a, open(d_prof / f, "rb") as b:
                assert a.read() == b.read(), f
    np.testing.assert_array_equal(plain.counts, prof.counts)
    np.testing.assert_array_equal(plain.est_counts, prof.est_counts)
    np.testing.assert_array_equal(plain.flens, prof.flens)
    for k in ("ec_cache_lookups", "ec_cache_hits", "full", "turbo", "hw1",
              "hw1pb"):
        assert plain.timings[k] == prof.timings[k], k


def test_long_reads_fetch_into_fetch_s(port_index, tmp_path):
    """--long's kernel J + fetch is the fetch span (long_s is gone)."""
    res, ann = _profiled(
        lambda: run_quant(Options(files=[LR], single_end=True,
                                  long_read=True, platform="PacBio",
                                  plaintext=True), index=port_index,
                          device="cpu"), str(tmp_path / "trace.json"))
    t = res.timings
    assert "long_s" not in t and t["long"] > 0
    assert t["fetch_s"] > 0 and len(ann["quant.fetch"]) == t["long"]
    _check_nesting(ann, QUANT_SPANS)
    _check_sums(ann, QUANT_SPANS, t)


def test_bus_spans(port_index, tmp_path):
    """run_bus on the same helper: bus.* spans, nested and summing to its
    timings; emission is in bus.write (emit_s is gone); the resolver's
    counters are there (the per-read resolver looks up no compact key and
    resolves its first-seen keys by the native call)."""
    kw = dict(files=SC, technology="10xv2", batch_size=4000)
    res, ann = _profiled(
        lambda: run_bus(Options(output_dir=str(tmp_path / "o"), **kw),
                        index=port_index, device="cpu"),
        str(tmp_path / "trace.json"))
    t = res.timings
    assert set(ann) == set(BUS_SPANS)
    assert "emit_s" not in t
    assert len(ann["bus.write"]) > len(ann["bus.resolve"]) >= 3
    _check_nesting(ann, BUS_SPANS)
    _check_sums(ann, BUS_SPANS, t)
    assert 0 <= t["unspanned_s"] < t["run_s"]
    assert t["ec_cache_lookups"] == t["ec_cache_hits"] == 0
    assert t["ec_native_keys"] > 0
    plain = run_bus(Options(output_dir=str(tmp_path / "p"), **kw),
                    index=port_index, device="cpu")
    for f in ("output.bus", "matrix.ec"):
        with open(tmp_path / "o" / f, "rb") as a, \
                open(tmp_path / "p" / f, "rb") as b:
            assert a.read() == b.read(), f


class _Clock:
    """A perf_counter that reads what the test sets."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_unspanned_counts_a_nested_phase_once(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(spans, "time", clock)
    t = {}
    with spans.recording("x", t, ("a", "b")):
        clock.now = 1.0
        with spans.span("a", "a_s"):
            clock.now = 2.0
            with spans.span("b", "b_s"):  # a phase inside a phase
                clock.now = 4.0
            clock.now = 5.0
        with spans.span("c", "c_s"):  # no phase
            clock.now = 7.0
        with spans.span("b", "b_s"):
            clock.now = 8.0
        spans.count("n", 3)
        spans.count("n", 4)
        clock.now = 10.0
    assert t == {"run_s": 10.0, "a_s": 4.0, "b_s": 3.0, "c_s": 2.0, "n": 7,
                 "unspanned_s": 5.0}


def test_the_helper_does_nothing_outside_a_run(monkeypatch):
    """Outside a run neither call records, times or touches the profiler;
    a run that raises leaves none current."""
    def refuse(*a, **k):
        raise AssertionError("record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans._RUN.get() is None
    with spans.span("a", "a_s"):
        spans.count("n", 1)
    t = {}
    with pytest.raises(ValueError):
        with spans.recording("x", t, ()):
            raise ValueError
    assert spans._RUN.get() is None and "unspanned_s" not in t
    with spans.span("a", "a_s"):
        pass
    assert spans._RUN.get() is None
    # no profiler: a span in a run opens no range either
    with spans.recording("x", t, ("a",)):
        with spans.span("a", "a_s"):
            pass
    assert set(t) == {"run_s", "a_s", "unspanned_s"}


def test_a_profiler_sees_prefixed_ranges(tmp_path):
    t = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording("x", t, ("a",)):
            with spans.span("a.b", "b_s"):
                pass
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    ann = _annotations(str(tmp_path / "t.json"))
    assert set(ann) == {"x.run", "x.a.b"}
    assert t["unspanned_s"] == t["run_s"]
