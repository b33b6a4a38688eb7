"""Share of a Config D call on a stack held on the card that the chunk loop
spends waiting for the card's results (``LAST_RUN_PERF["pull_wait_s"]``: the
waits for each chunk's pull and its unpacking, over the call's host-clock
time), over the traced run's calls outside the profiled sub-windows whose
chunks loaded frames from a tensor stack (``resident_frames`` nonzero). With
no upload beside it, the wait is set by the card's own work: work taken off
the card lowers it, work taken off the host raises it."""


def read(record):
    calls = [c for c in record["calls"] if not c["profiled"] and c["counters"]
             and c["counters"].get("resident_frames")]
    if not calls:
        record["log"]("card_wait_pct: no unprofiled call carried a nonzero LAST_RUN_PERF[\"resident_frames\"]")
        return None
    return 100.0 * sum(c["counters"]["pull_wait_s"] for c in calls) / sum(c["seconds"] for c in calls)
