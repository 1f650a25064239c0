"""Block-size trial pass (codec/encoder.py, the native rdo_only pass
with its checkpoint and rollback): the host span trial_pass a frame,
in ms."""

from codecbench.metrics.host_passes import host_span_ms_per_frame


def read(run):
    return host_span_ms_per_frame(run, "encode", "trial_pass")
