"""Decoder parse (codec/decoder.py, the native parse): the frame walls
less the synthesize_frame and dering_frame spans, a frame, in ms."""

from codecbench.metrics import per_frame, span_s


def read(run):
    if run.mode != "decode":
        return None
    device = span_s(run, "synthesize_frame", "dering_frame") or 0.0
    return per_frame(run, 1e3 * (sum(run.frame_walls) - device))
