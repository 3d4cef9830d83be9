"""Fragments (read pairs) the quant samples of the window processed, over
the window: host clock from the first sample's start to the last one's end."""


def read(rec):
    if rec["entry"] != "quant":
        return None
    return rec["fragments"] / rec["window_s"]
