"""Device: the kernels, copies and sets that ran on the card a frame."""

from codecbench.metrics import launches_per_frame


def read(run):
    return launches_per_frame(run, "decode")
