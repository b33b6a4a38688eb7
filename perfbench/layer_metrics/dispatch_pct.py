"""Share of a Config D call's time that the chunk loop spends enqueuing the
metric and tracking steps and the result pull (``LAST_RUN_PERF["dispatch_s"]``
over the call's host-clock time), over the traced run's calls outside the
profiled sub-windows, whose profiler would add its own host cost."""


def read(record):
    calls = [c for c in record["calls"] if not c["profiled"] and c["counters"]
             and "dispatch_s" in c["counters"]]
    if not calls:
        record["log"]("dispatch_pct: no unprofiled call carried LAST_RUN_PERF")
        return None
    return 100.0 * sum(c["counters"]["dispatch_s"] for c in calls) / sum(c["seconds"] for c in calls)
