"""Kernels: the device time of PyTorch's own kernels (not the port's
hand kernels, not copies) a frame, in ms."""

from codecbench.metrics import per_frame, traced


def read(run):
    t = traced(run, "encode")
    return None if t is None else per_frame(run, 1e3 * t.kernel_seconds(
        hand=False))
