"""Encoder orchestration outside every span: the frame walls less every
device span and every host span, a frame, in ms."""

from codecbench.metrics.host_passes import untraced_ms_per_frame


def read(run):
    return untraced_ms_per_frame(run, "encode")
