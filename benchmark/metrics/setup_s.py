"""Seconds from the process's start to the window's: imports, the card,
kernels, the index, the traffic and the warm-up sample."""


def read(rec):
    return rec["setup_s"]
