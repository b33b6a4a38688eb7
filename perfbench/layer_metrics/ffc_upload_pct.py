"""Share of an XST scan call's time that the flat-field spends converting
the raw images to float32 and copying them, the flat and the dark to the
card (the two calls' ``normalize.LAST_RUN_PERF["upload_s"]`` summed, over
the call's host-clock time), over the traced run's calls outside the
profiled sub-windows."""


def read(record):
    calls = [c for c in record["calls"] if not c["profiled"] and c["counters"] and "upload_s" in c["counters"]]
    if not calls:
        record["log"]("ffc_upload_pct: no unprofiled call carried normalize.LAST_RUN_PERF")
        return None
    return 100.0 * sum(c["counters"]["upload_s"] for c in calls) / sum(c["seconds"] for c in calls)
