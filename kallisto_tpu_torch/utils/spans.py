"""Named spans and counters of one run, on the profiler's clock.

`run_quant` and `run_bus` time their phases through this module and
nothing else.  A span adds its wall seconds to the run's `timings[key]`
and, while a torch.profiler runs, is also a `record_function` range named
`<run>.<name>` (`quant.resolve`, `bus.read`, ...) on the profiler's
timeline, beside the kernels and copies it caused.  With no profiler on it
calls no profiler code (`record_function` costs about a hundred times a
read of the profiler's flag even then).  A counter adds to `timings[key]`.

The run is ambient (a context variable that `recording` sets), so code
under the entry points (the device index's upload, the EC resolver)
records into the run that called it without a parameter; outside a run
both calls do nothing.  Spans stay in memory: `timings` is the run's
result, and the profiler's trace holds the ranges.

`recording` also writes `timings["run_s"]`, the seconds of the whole run,
and `timings["unspanned_s"]`, the part of them that no phase span covers.
The phases are the caller's list of span names; a phase span inside
another phase span (a probe inside a dispatch) covers nothing more.
"""

import contextlib
import contextvars
import time
from typing import Iterable, Optional

import torch

_RUN: contextvars.ContextVar = contextvars.ContextVar("kallisto_span_run",
                                                      default=None)
_profiling = torch.autograd._profiler_enabled


class _Run:
    """The recorder of one run: its timings, the prefix of its span names,
    its phases and the seconds its outermost open phase spans covered."""

    __slots__ = ("timings", "prefix", "phases", "open_phases", "covered")

    def __init__(self, timings: dict, prefix: str, phases: Iterable[str]):
        self.timings = timings
        self.prefix = prefix + "."
        self.phases = frozenset(phases)
        self.open_phases = 0
        self.covered = 0.0


class _Span:
    __slots__ = ("_run", "_name", "_key", "_phase", "_rf", "_t0")

    def __init__(self, run: Optional[_Run], name: str, key: str):
        self._run = run
        self._name = name
        self._key = key
        self._rf = None

    def __enter__(self):
        run = self._run
        if run is None:
            return self
        if _profiling():
            self._rf = torch.profiler.record_function(run.prefix + self._name)
            self._rf.__enter__()
        self._phase = self._name in run.phases
        run.open_phases += self._phase
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        run = self._run
        if run is None:
            return False
        dt = time.perf_counter() - self._t0
        run.timings[self._key] = run.timings.get(self._key, 0.0) + dt
        if self._phase:
            run.open_phases -= 1
            if not run.open_phases:
                run.covered += dt
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, key: str) -> _Span:
    """A context manager that adds the seconds of its block to the
    current run's timings[key] and, while a profiler runs, opens the
    range `<run>.<name>`; outside a run it does nothing."""
    return _Span(_RUN.get(), name, key)


def count(key: str, n: int) -> None:
    """Add n to the current run's timings[key] (nothing outside a run)."""
    run = _RUN.get()
    if run is not None:
        run.timings[key] = run.timings.get(key, 0) + n


@contextlib.contextmanager
def recording(prefix: str, timings: dict, phases: Iterable[str]):
    """Make the block a run whose spans and counters go to `timings`: its
    spans are named `<prefix>.<name>`, the block itself is the span
    `<prefix>.run` (timings["run_s"]), and timings["unspanned_s"] is what
    of it no span named in `phases` covers."""
    run = _Run(timings, prefix, phases)
    token = _RUN.set(run)
    try:
        with _Span(run, "run", "run_s"):
            yield
    finally:
        _RUN.reset(token)
    timings["unspanned_s"] = timings["run_s"] - run.covered
