"""Share of the attributed sub-window's wall time inside the program's
``config.upload`` (the pinning copy and the non-blocking copy of host
frames to the card), from the Python tracer's events."""

FUNCTIONS = (("barc4dip_tpu_torch/config.py", "upload"),)


def read(record):
    tr = record["attributed"]
    if tr is None or not tr.functions(FUNCTIONS):
        record["log"]("upload_pct: no config.upload event in the attributed sub-window")
        return None
    inside = sum(max(0.0, min(e, tr.hi) - max(s, tr.lo)) for s, e in tr.inside(FUNCTIONS))
    return 100.0 * inside / tr.wall_s
