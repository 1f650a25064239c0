"""Device-path counters: dispatches, host<->device bytes, fetch wall
time, kernel builds, kernel launches by kernel, and the host wall of
named spans.

The counterpart of daala_tpu/utils/devstats.py.  Every device front end
of the port (models/keyframe.py) reports its traffic here, and every
kernel wrapper (ops/cuda/*_kernels.py) adds one to its launch count
where it launches its kernel, and nowhere else.  Bytes count only what
crosses to or from a CUDA device; a CPU run counts dispatches and no
bytes.

The analysis entry points (`analyze_*`) each run in a span of their
name.  They end by fetching their planes to the host, which waits for
the device, so a span's wall covers the device work it launched.

Counters are process-global and cheap (two clock reads per span);
`reset()` + `snapshot()` bracket a measured region (chip_smoke.py and
utils/profile.py print them).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

_ZERO = dict(dispatches=0, h2d_bytes=0, d2h_bytes=0, fetch_wall_s=0.0)
STATS = dict(_ZERO)
LAUNCHES: dict = {}  # kernel name -> launches since reset()
BUILDS: dict = {}  # kernel name -> nvcc seconds (kept across reset())
SPANS: dict = {}  # span name -> host wall seconds since reset()


def reset():
    STATS.update(_ZERO)
    LAUNCHES.clear()
    SPANS.clear()


def snapshot():
    s = dict(STATS)
    s["launches"] = dict(LAUNCHES)
    s["builds_s"] = dict(BUILDS)
    s["spans_s"] = dict(SPANS)
    return s


@contextlib.contextmanager
def span(name):
    """Add the host wall time of the enclosed block to SPANS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SPANS[name] = SPANS.get(name, 0.0) + time.perf_counter() - t0


def launch(name):
    """Count one launch of kernel `name` (called by its wrapper)."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def built(name, seconds):
    BUILDS[name] = seconds


def upload(array, device):
    """torch.from_numpy(array) on `device`, counting the host->device
    bytes when the device is not the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cpu":
        STATS["h2d_bytes"] += t.numel() * t.element_size()
        t = t.to(device, non_blocking=False)
    return t


def dispatch():
    """Count one device dispatch (one analysis call on one plane, or one
    batch of OBMC leaves)."""
    STATS["dispatches"] += 1


def fetch(t, dtype=torch.int32):
    """The numpy copy of tensor t, as `dtype` (None keeps t's), counting
    device->host bytes and the wall time spent waiting for them."""
    t0 = time.perf_counter()
    a = t.detach().to("cpu", dtype or t.dtype).numpy()
    if t.device.type != "cpu":
        STATS["d2h_bytes"] += a.nbytes
        STATS["fetch_wall_s"] += time.perf_counter() - t0
    return a
