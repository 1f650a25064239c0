"""Kernels (ops/cuda/*): the bounds of the hand kernels' calls summed,
over their device times summed, in % (codecbench/roofline.py)."""

from codecbench.metrics import hand_kernels_roofline


def read(run):
    return hand_kernels_roofline(run, "encode")
