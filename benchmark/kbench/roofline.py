"""The yardstick's arithmetic: the card's published peaks, a roofline bound,
and the busy time of a device trace (frozen from chip_smoke.py's bound and
_trace_busy)."""

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth at the full 700 W
# power limit
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float) -> float:
    """The least seconds the card could take to move nbytes (the work this
    yardstick bounds moves bytes and computes little)."""
    return nbytes / PEAK_BYTES


def union_s(intervals) -> float:
    """Seconds covered by the union of [start, end) intervals (in us)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def gaps(intervals, lo: float, hi: float):
    """[(start, end)] of the time in [lo, hi) that no interval covers (us)."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
