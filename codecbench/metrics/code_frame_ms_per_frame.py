"""Final coding pass (codec/encoder.py, the native fc_encode_frame: PVQ
replay, entropy coding, postfilter, dering; and fc_encode_dering where
dering is deferred): the host spans code_frame and code_dering a frame,
in ms."""

from codecbench.metrics.host_passes import host_span_ms_per_frame


def read(run):
    return host_span_ms_per_frame(run, "encode", "code_frame",
                                  "code_dering")
