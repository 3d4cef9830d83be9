"""Host seconds run_quant waits for the native FASTQ reader
(timings["read_s"]), per million fragments."""

from kbench.readers import per_million


def read(rec):
    return per_million(rec, "quant", "read_s")
