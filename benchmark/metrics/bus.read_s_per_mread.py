"""Host seconds run_bus spends in its Python FASTQ reader
(timings["read_s"]), per million reads."""

from kbench.readers import per_million


def read(rec):
    return per_million(rec, "bus", "read_s")
