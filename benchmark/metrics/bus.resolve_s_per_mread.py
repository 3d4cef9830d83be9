"""Host seconds of EC resolution in run_bus (timings["resolve_s"]), per
million reads."""

from kbench.readers import per_million


def read(rec):
    return per_million(rec, "bus", "resolve_s")
