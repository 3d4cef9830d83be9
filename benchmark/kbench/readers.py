"""What the metric readers (benchmark/metrics/<metric>.py) share."""

import os
import re

from .roofline import bound_s


def per_million(rec: dict, entry: str, key: str):
    """Host seconds of timings[key] summed over the window's samples, per
    million fragments (reads for bus)."""
    if rec["entry"] != entry or not rec["fragments"]:
        return None
    s = sum(r["timings"].get(key, 0.0) for r in rec["samples"])
    return s / (rec["fragments"] / 1e6)


def idle_pct(rec: dict, entry: str):
    """The card's idle share of the traced window."""
    tr = rec["trace"]
    if rec["entry"] != entry or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def program_kernels(program_dir: str) -> set:
    """Every kernel the program can launch: each __global__ function in its
    sources (CUDA and C++ files, and CUDA source held in Python strings)
    and each @triton.jit function, wherever in the package it lies."""
    glob_pat = re.compile(r"__global__\s+void\s+"
                          r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")
    jit_pat = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")
    names = set()
    for d, _, files in os.walk(program_dir):
        for f in files:
            if f.rsplit(".", 1)[-1] in ("cu", "cuh", "cpp", "cc", "h", "py"):
                with open(os.path.join(d, f), errors="replace") as fh:
                    text = fh.read()
                names.update(glob_pat.findall(text))
                names.update(jit_pat.findall(text))
    return names


# kernel G, the EM (csrc/em.cu): not pseudoalignment.  A kernel of the
# program that is not named here counts as pseudoalignment, so a renamed
# or new EM kernel can only lower the share, never raise it.
EM_KERNELS = frozenset({"em_pass1_kernel", "em_pass2_kernel",
                        "em_stop_kernel"})

# words that mark a kernel of a library (PyTorch, CUB, Thrust, cuBLAS)
LIBRARY_WORDS = frozenset({"at", "c10", "at_cuda_detail", "cub", "thrust",
                           "cutlass", "cublas", "cublasLt", "nvjet"})


def classify(op: str, program: set) -> str:
    """'pseudoalign', 'em' or 'library' for a kernel of the trace; raises
    for a kernel that is neither the program's nor a library's, since a
    kernel the yardstick cannot place would leave its time out."""
    words = set(re.findall(r"\w+", op))
    mine = words & program
    if mine:
        return "em" if mine <= EM_KERNELS else "pseudoalign"
    if words & LIBRARY_WORDS or re.search(r"gemm|xmma|cutlass", op):
        return "library"
    raise RuntimeError(f"the trace holds a kernel the benchmark cannot place "
                       f"(neither the program's nor a library's): {op!r}")


def pseudoalign_roofline(rec: dict, entry: str):
    """The byte bound of the window's pseudoalignment over the device time
    of the kernels that do it (every kernel of the program but the EM's).
    Bytes: each read's bases once at 2 bits, one 16-byte (k-mer, EC) entry
    per distinct indexed k-mer of each sample, and 4 bytes out per read.
    Raises where the trace holds a kernel it cannot place, or no
    pseudoalignment kernel at all (the cell always runs them)."""
    tr = rec["trace"]
    if rec["entry"] != entry or tr is None:
        return None
    program = program_kernels(rec["program_dir"])
    kinds = tr.get("kinds", {})
    t = sum(s for op, s in tr["device_ops"].items()
            if kinds.get(op, "kernel") == "kernel"
            and classify(op, program) == "pseudoalign")
    if t <= 0:
        raise RuntimeError("the traced window holds no pseudoalignment "
                           "kernel of the program")
    nbytes = sum(r["reads_bases"][1] / 4 + 16 * r["distinct_kmers"]
                 + 4 * r["reads_bases"][0] for r in rec["samples"])
    return 100.0 * bound_s(nbytes) / t
