"""The card's idle share of the traced window: 100 x (1 - the union of
kernel, copy and set intervals over the window)."""

from kbench.readers import idle_pct


def read(rec):
    return idle_pct(rec, "bus")
