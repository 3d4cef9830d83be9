"""The yardstick's arithmetic and the reading of a profiler trace."""

import json

import pytest

from kbench import readers, roofline, trace


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40)]
    assert roofline.union_s(iv) == pytest.approx(30e-6)
    assert roofline.gaps(iv, 0, 50) == [(20, 30), (40, 50)]
    assert roofline.gaps([], 3, 9) == [(3, 9)]


def test_bound_is_bytes_over_the_published_bandwidth():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)


def test_read_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "benchmark.window",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "sample.run_quant",
         "ts": 0, "dur": 550},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 90,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void read_keys_kernel<true>(x)",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "pseudoalign_anchor_kernel",
         "ts": 120, "dur": 80},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 500,
         "dur": 100},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = trace.read_trace(str(p), "benchmark.window")
    assert tr["busy_s"] == pytest.approx(200e-6)
    assert tr["window_s"] == pytest.approx(1000e-6)
    assert tr["idle_gaps"][0] == ["between samples after aten::copy_",
                                  pytest.approx(400e-6)]
    assert tr["idle_gaps"][1][0] == "sample.run_quant after aten::copy_"
    rec = {"entry": "quant", "trace": tr, "program_dir": _program_dir(),
           "samples": [{"reads_bases": (8, 800), "distinct_kmers": 10}]}
    assert readers.idle_pct(rec, "quant") == pytest.approx(80.0)
    assert readers.idle_pct(rec, "bus") is None
    nbytes = 800 / 4 + 16 * 10 + 4 * 8
    assert readers.pseudoalign_roofline(rec, "quant") == pytest.approx(
        100 * nbytes / 3.35e12 / 130e-6)


def _program_dir():
    import os

    from kbench import harness

    return os.path.join(harness.ROOT, "kallisto_tpu_torch")


def test_program_kernels_are_every_kernel_of_the_package():
    names = readers.program_kernels(_program_dir())
    assert {"pseudoalign_anchor_kernel", "read_keys_kernel", "ke_insert",
            "lookup_kmers_kernel", "gather_slim_kernel"} <= names
    assert readers.EM_KERNELS <= names


def test_a_kernel_in_a_new_file_is_still_counted(tmp_path):
    """A kernel moved into a file of its own, even one held in a Python
    string, is found; the EM's are kept apart."""
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "csrc" / "moved.cu").write_text(
        "__global__ void __launch_bounds__(256) probe_moved_kernel(int x) {}")
    (pkg / "ops.py").write_text(
        'SRC = r"""__global__ void inline_kernel(int* p) {}"""')
    names = readers.program_kernels(str(pkg))
    assert names == {"probe_moved_kernel", "inline_kernel"}
    assert readers.classify("void probe_moved_kernel(int)", names) == \
        "pseudoalign"
    assert readers.classify("em_pass2_kernel(EmArgs)",
                            names | readers.EM_KERNELS) == "em"


@pytest.mark.parametrize("op,kind", (
    ("void read_keys_kernel<true>(KeySide, int)", "pseudoalign"),
    ("pseudoalign_anchor_wave2_kernel", "pseudoalign"),
    ("em_stop_kernel(EmArgs)", "em"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<int>, at::detail::Array<char*, 1> >(int)",
     "library"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<x>(y)",
     "library"),
))
def test_classify(op, kind):
    assert readers.classify(op, readers.program_kernels(_program_dir())) == \
        kind


def test_a_kernel_nobody_knows_fails_the_reading(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "benchmark.window",
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": "pseudoalign_side_kernel",
           "ts": 10, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "mystery_probe(int)",
           "ts": 30, "dur": 10}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    rec = {"entry": "bus", "program_dir": _program_dir(),
           "trace": trace.read_trace(str(p), "benchmark.window"),
           "samples": [{"reads_bases": (8, 800), "distinct_kmers": 10}]}
    with pytest.raises(RuntimeError, match="mystery_probe"):
        readers.pseudoalign_roofline(rec, "bus")
    rec["trace"]["device_ops"] = {"Memcpy HtoD (Pageable -> Device)": 1.0}
    rec["trace"]["kinds"] = {"Memcpy HtoD (Pageable -> Device)":
                             "gpu_memcpy"}
    with pytest.raises(RuntimeError, match="no pseudoalignment kernel"):
        readers.pseudoalign_roofline(rec, "bus")
