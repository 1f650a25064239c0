"""Device-path counters: dispatches, host<->device bytes, fetch wall
time, kernel builds, kernel launches by kernel, and the host wall of
named spans in two tables.

The counterpart of daala_tpu/utils/devstats.py.  Every device front end
of the port (models/keyframe.py) reports its traffic here, and every
kernel wrapper (ops/cuda/*_kernels.py) adds one to its launch count
where it launches its kernel, and nowhere else.  Bytes count only what
crosses to or from a CUDA device; a CPU run counts dispatches and no
bytes.

Two tables of spans, each the summed host wall of a block by name:

- SPANS (`span`): the blocks that cover device work.  The analysis
  entry points (`analyze_*`) each run in a span of their name, and so
  does the finish() they return, which fetches their planes to the
  host and so waits for the device: the span's wall covers the device
  work they launched.  So do the PVQ band search, the SAD fields, the
  sweep (`refine_sweep`), the dering candidates, synthesis and dering.
- HOST_SPANS (`host_span`): the host passes between them, placed at the
  native call sites of codec/encoder.py and codec/decoder.py (motion
  search, OBMC prediction, the trial pass, the coding pass, the parse,
  storing the reconstruction, ...).

Two placement rules: a host span encloses no device span and no other
host span, and a device span encloses no host span.  So a frame's wall
is its device spans, plus its host spans, plus what no span covers.

While a torch profiler records, each span of either table also opens a
profiler range "span:<name>" around its block, so the port's passes
and the device's kernels and copies lie on one clock, the profiler's,
and every idle gap of a trace can be put down to the pass that ran on
the host.  With no profiler recording, a span asks once whether one
records and builds no range: two clock reads, that question and one
locked dict update.

The PVQ band search (models/pvqsearch.py) adds the rows it searched
and the rows it marked invalid (searched on the host) under COUNTS;
`prefetch` starts device->host copies early, and their bytes count once.

Counters are process-global and cheap; `reset()` + `snapshot()`
bracket a measured region (chip_smoke.py and utils/profile.py print
them).  Every update holds one lock, so threads that encode at once
(parallel/mesh.py encode_clips_batched) lose no count.  A span sums the
host walls of every thread that entered it, so with threads a span can
exceed the wall clock.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

_ZERO = dict(dispatches=0, h2d_bytes=0, d2h_bytes=0, fetch_wall_s=0.0)
STATS = dict(_ZERO)
LAUNCHES: dict = {}  # kernel name -> launches since reset()
BUILDS: dict = {}  # kernel name -> nvcc seconds (kept across reset())
SPANS: dict = {}  # device span name -> host wall seconds since reset()
HOST_SPANS: dict = {}  # host span name -> host wall seconds since reset()
COUNTS: dict = {}  # counter name -> total since reset()
# device tensor -> (pinned host copy, event recorded after the copy)
_PREFETCHED = WeakIdKeyDictionary()
_LOCK = threading.Lock()  # held by every update of the above


def _add(d, key, value):
    with _LOCK:
        d[key] = d.get(key, 0) + value


def reset():
    with _LOCK:
        STATS.update(_ZERO)
        LAUNCHES.clear()
        SPANS.clear()
        HOST_SPANS.clear()
        COUNTS.clear()


def snapshot():
    with _LOCK:
        s = dict(STATS)
        s["launches"] = dict(LAUNCHES)
        s["builds_s"] = dict(BUILDS)
        s["spans_s"] = dict(SPANS)
        s["host_spans_s"] = dict(HOST_SPANS)
        s["counts"] = dict(COUNTS)
    return s


def count(name, value):
    """Add value to COUNTS[name]."""
    _add(COUNTS, name, value)


def _range(name):
    """The profiler range of span `name` while a torch profiler records,
    else None."""
    if not torch.autograd._profiler_enabled():
        return None
    return torch.profiler.record_function("span:" + name)


@contextlib.contextmanager
def _timed(table, name):
    rng = _range(name)
    t0 = time.perf_counter()
    try:
        if rng is None:
            yield
        else:
            with rng:
                yield
    finally:
        _add(table, name, time.perf_counter() - t0)


def span(name):
    """Add the host wall time of the enclosed block, which covers device
    work, to SPANS[name]."""
    return _timed(SPANS, name)


def host_span(name):
    """Add the host wall time of the enclosed host pass to
    HOST_SPANS[name]."""
    return _timed(HOST_SPANS, name)


def launch(name):
    """Count one launch of kernel `name` (called by its wrapper)."""
    _add(LAUNCHES, name, 1)


def built(name, seconds):
    with _LOCK:
        BUILDS[name] = seconds


def upload(array, device):
    """torch.from_numpy(array) on `device`, counting the host->device
    bytes when the device is not the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cpu":
        _add(STATS, "h2d_bytes", t.numel() * t.element_size())
        t = t.to(device, non_blocking=False)
    return t


def dispatch():
    """Count one device dispatch (one analysis call on one plane, or one
    batch of OBMC leaves)."""
    _add(STATS, "dispatches", 1)


def prefetch(*tensors):
    """Start non-blocking device->host copies of the CUDA tensors among
    `tensors` into pinned memory, counting their bytes now; a later
    fetch() of the same tensor waits for its copy and counts nothing
    more."""
    for t in tensors:
        if t.device.type == "cpu":
            continue
        with _LOCK:
            if t in _PREFETCHED:
                continue
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach(), non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        with _LOCK:
            STATS["d2h_bytes"] += host.numel() * host.element_size()
            _PREFETCHED[t] = (host, done)


def fetch(t, dtype=torch.int32):
    """The numpy copy of tensor t, as `dtype` (None keeps t's), counting
    device->host bytes (unless prefetch() counted them) and the wall
    time spent waiting for them."""
    t0 = time.perf_counter()
    hit = None
    if t.device.type != "cpu":
        with _LOCK:
            hit = _PREFETCHED.pop(t, None)
    if hit is not None:
        host, done = hit
        done.synchronize()
        a = host.to(dtype or t.dtype).numpy()
    else:
        a = t.detach().to("cpu", dtype or t.dtype).numpy()
        if t.device.type != "cpu":
            _add(STATS, "d2h_bytes", a.nbytes)
    if t.device.type != "cpu":
        _add(STATS, "fetch_wall_s", time.perf_counter() - t0)
    return a
