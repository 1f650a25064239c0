"""Analysis front end (models/keyframe.py): the analyze_* spans a frame,
in ms."""

from codecbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, prefix="analyze_")
