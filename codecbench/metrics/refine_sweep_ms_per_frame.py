"""Motion refinement, sweep mode (codec/mvest.py, models/mesweep.py):
the refine_sweep span a frame, in ms."""

from codecbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "refine_sweep")
