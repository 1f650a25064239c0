"""Decoder: the process's CPU time over the window (every thread), a
frame, in ms."""

from codecbench.metrics import cpu_ms_per_frame


def read(run):
    return cpu_ms_per_frame(run, "decode")
