"""Dering candidates (models/restore.py dering_candidates_device, the
analysis tier): the dering_candidates span a frame, in ms."""

from codecbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "dering_candidates")
