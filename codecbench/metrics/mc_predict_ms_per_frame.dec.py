"""Host OBMC prediction in the decoder (codec/mc.py mc_predict_frame):
the host span mc_predict a frame, in ms."""

from codecbench.metrics.host_passes import host_span_ms_per_frame


def read(run):
    return host_span_ms_per_frame(run, "decode", "mc_predict")
