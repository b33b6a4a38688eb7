"""Megapixels of every call made in the window over the window's whole
time, to the end of the last call."""


def read(window):
    return sum(c["pixels"] for c in window["calls"]) / window["window_s"] / 1e6
