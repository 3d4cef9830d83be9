"""Host seconds of run_bus's barcode, UMI and sequence extraction
(timings["extract_s"]), per million reads."""

from kbench.readers import per_million


def read(rec):
    return per_million(rec, "bus", "extract_s")
