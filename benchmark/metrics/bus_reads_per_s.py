"""Reads the bus library slices of the window processed, outputs written,
over the window: host clock from the first start to the last end."""


def read(rec):
    if rec["entry"] != "bus":
        return None
    return rec["fragments"] / rec["window_s"]
