"""Host seconds of EC resolution and counting in run_quant
(timings["resolve_s"]), per million fragments."""

from kbench.readers import per_million


def read(rec):
    return per_million(rec, "quant", "resolve_s")
