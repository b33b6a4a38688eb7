"""Share of a Config D stack call's time that the entry spends sizing the
tracking grid from frame 0's grain on the host CPU
(``tracking_grid_from_frame0``, ``LAST_RUN_PERF["frame0_s"]``, over the
call's host-clock time), over the traced run's calls outside the profiled
sub-windows, whose profiler would add its own host cost."""


def read(record):
    calls = [c for c in record["calls"] if not c["profiled"] and c["counters"] and "frame0_s" in c["counters"]]
    if not calls:
        record["log"]("frame0_host_pct: no unprofiled call carried LAST_RUN_PERF[\"frame0_s\"]")
        return None
    return 100.0 * sum(c["counters"]["frame0_s"] for c in calls) / sum(c["seconds"] for c in calls)
