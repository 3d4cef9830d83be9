"""The traced window: torch.profiler over the benchmark's own spans, and
what the harness reads from its trace."""

import bisect
import contextlib
import json
import os
from collections import defaultdict

from .roofline import gaps, union_s

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(enabled: bool, path: str):
    """Profile the CPU and the card inside the block when enabled, then
    write the Chrome trace to path."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        yield
        torch.cuda.synchronize()
    p.export_chrome_trace(path)


def span(name: str, enabled: bool):
    """A named span of the benchmark in the trace."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def read_trace(path: str, window_span: str) -> dict:
    """busy_s (union of kernels, copies and sets), window_s (the window
    span), seconds of each device operation by name and its kind (the
    trace's category: kernel, gpu_memcpy or gpu_memset), and the longest idle
    gaps, each labelled by the benchmark span open then and the program's
    last CPU operation before it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    win = [e for e in events if e.get("name") == window_span
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no span {window_span}")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
          for e in dev]
    by_name = defaultdict(float)
    kinds = {}
    for e in dev:
        by_name[e["name"]] += float(e.get("dur", 0)) / 1e6
        kinds[e["name"]] = e["cat"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] != window_span)
    ops = sorted((float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                 for e in events if e.get("cat") == "cpu_op")
    ends = [t for t, _ in ops]

    def label(a: float, b: float) -> str:
        mid = (a + b) / 2
        sp = [n for s, t, n in spans if s <= mid < t]
        name = sp[-1] if sp else "between samples"
        i = bisect.bisect_right(ends, a) - 1
        last = ops[i][1] if i >= 0 else "none"
        return f"{name} after {last}"

    idle = sorted(gaps(iv, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": union_s([(max(a, lo), min(b, hi)) for a, b in iv
                           if b > lo and a < hi]),
        "window_s": (hi - lo) / 1e6,
        "device_ops": dict(by_name),
        "kinds": kinds,
        "idle_gaps": [[label(a, b), (b - a) / 1e6] for a, b in idle],
    }
