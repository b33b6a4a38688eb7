"""Kernel launch calls (runtime and driver) per frame in the plain
sub-window: the host's share of the metric step."""


def read(record):
    tr = record["plain"]
    if tr is None or not tr.frames or not tr.launches:
        record["log"]("launches_per_frame: no launch call in the plain sub-window")
        return None
    return len(tr.launches) / tr.frames
