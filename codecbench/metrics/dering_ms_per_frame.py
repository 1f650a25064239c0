"""Dering (models/restore.py): the dering_frame span a frame, in ms."""

from codecbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "dering_frame")
