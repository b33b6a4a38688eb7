"""Share of an XST scan call's time that the flat-field spends reducing
the stacked flats and darks on the host (the two calls'
``normalize.LAST_RUN_PERF["calib_s"]`` summed, over the call's host-clock
time), over the traced run's calls outside the profiled sub-windows."""


def read(record):
    calls = [c for c in record["calls"] if not c["profiled"] and c["counters"] and "calib_s" in c["counters"]]
    if not calls:
        record["log"]("calib_host_pct: no unprofiled call carried normalize.LAST_RUN_PERF")
        return None
    return 100.0 * sum(c["counters"]["calib_s"] for c in calls) / sum(c["seconds"] for c in calls)
