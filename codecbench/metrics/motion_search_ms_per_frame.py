"""Native motion search (codec/encoder.py): the host spans
motion_search (BMA, mesh subdivision, greedy refinement),
mv_resolution and code_mvs a frame, in ms."""

from codecbench.metrics.host_passes import host_span_ms_per_frame


def read(run):
    return host_span_ms_per_frame(run, "encode", "motion_search",
                                  "mv_resolution", "code_mvs")
