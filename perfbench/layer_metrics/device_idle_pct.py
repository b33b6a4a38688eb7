"""Share of the plain sub-window's wall time in which no kernel, copy or
memset ran on the card."""


def read(record):
    tr = record["plain"]
    if tr is None or not tr.device or tr.wall_s <= 0:
        record["log"]("device_idle_pct: no device operation in the plain sub-window")
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
