"""Encoder orchestration and native passes: the frame walls less the
device layers' spans, a frame, in ms."""

from codecbench.metrics import per_frame, span_s


def read(run):
    if run.mode != "encode":
        return None
    return per_frame(run, 1e3 * (sum(run.frame_walls)
                                 - (span_s(run, prefix="") or 0.0)))
