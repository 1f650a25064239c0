"""Native parse (codec/decoder.py: the MV unpack and fc_decode_frame):
the host spans decode_mvs and parse_frame a frame, in ms."""

from codecbench.metrics.host_passes import host_span_ms_per_frame


def read(run):
    return host_span_ms_per_frame(run, "decode", "decode_mvs",
                                  "parse_frame")
