"""Seconds from the start of the process to the start of the window: import,
CUDA context, kernels loaded (or built), inputs made, the cell's shapes
warmed up."""


def read(window):
    return window["setup_s"]
