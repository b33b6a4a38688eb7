"""The card's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start), in GiB."""


def read(window):
    return window["peak_bytes"] / 2**30
