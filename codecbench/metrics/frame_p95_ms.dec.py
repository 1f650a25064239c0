"""Decoder: the 95th percentile of the window's frame walls, in ms."""

import numpy as np


def read(run):
    if run.mode != "decode" or not run.frame_walls:
        return None
    return float(np.percentile(run.frame_walls, 95)) * 1e3
