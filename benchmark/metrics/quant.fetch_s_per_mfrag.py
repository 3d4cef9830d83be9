"""Host seconds of run_quant's device-to-host fetches, the wait for the
kernels included (timings["fetch_s"]), per million fragments."""

from kbench.readers import per_million


def read(rec):
    return per_million(rec, "quant", "fetch_s")
