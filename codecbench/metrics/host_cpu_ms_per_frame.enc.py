"""Encoder orchestration and native passes: the process's CPU time
over the window (every thread), a frame, in ms.  Beside the frame
wall it shows whether a slower frame cost the host more CPU time or
waited for the CPU."""

from codecbench.metrics import cpu_ms_per_frame


def read(run):
    return cpu_ms_per_frame(run, "encode")
