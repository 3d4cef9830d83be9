"""The pseudoalignment kernels' share of their byte roofline over the
traced window (kbench/readers.py says what is counted)."""

from kbench.readers import pseudoalign_roofline


def read(rec):
    return pseudoalign_roofline(rec, "bus")
