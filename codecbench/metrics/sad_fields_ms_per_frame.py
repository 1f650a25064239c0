"""SAD fields (models/mefield.py): the fullpel_sad_fields span a frame,
in ms."""

from codecbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "fullpel_sad_fields")
