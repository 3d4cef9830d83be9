"""Host seconds run_quant spends placing the index on the card
(timings["index_upload_s"]), mean per sample."""


def read(rec):
    if rec["entry"] != "quant" or not rec["samples"]:
        return None
    return (sum(r["timings"]["index_upload_s"] for r in rec["samples"])
            / len(rec["samples"]))
