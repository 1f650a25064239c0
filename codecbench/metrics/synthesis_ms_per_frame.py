"""Synthesis (models/synthesis.py): the synthesize_frame span a frame,
in ms."""

from codecbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "synthesize_frame")
