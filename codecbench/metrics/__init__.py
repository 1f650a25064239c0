"""The per-layer metrics: one reader a metric, codecbench/metrics/
<name>.py, found by the metric's name in BENCHMARK.json.

A reader's `read(run)` takes the traced run (codecbench/window.py Run:
its mode, frames, frame walls, the port's devstats snapshot over the
window and the trace's Summary) and returns the metric's value, or None
where the run holds nothing to read, and the metric is then left out
of the result's line.  The helpers below are the arithmetic that
several readers share.
"""

from __future__ import annotations

import importlib.util
import os


def read_metrics(root, name, run):
    """The value of metric `name` on `run`, by its reader under `root`."""
    path = os.path.join(root, "codecbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "codecbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def per_frame(run, total):
    return total / run.frames if run.frames else None


def span_s(run, *names, prefix=None):
    """Seconds of the port's devstats spans `names` (and of those whose
    name starts with `prefix`) over the window, or None where none ran."""
    spans = run.stats["spans_s"]
    keys = [k for k in spans
            if k in names or (prefix is not None and k.startswith(prefix))]
    return sum(spans[k] for k in keys) if keys else None


def span_ms_per_frame(run, *names, prefix=None):
    s = span_s(run, *names, prefix=prefix)
    return None if s is None else per_frame(run, 1e3 * s)


def traced(run, mode):
    """The run's trace Summary where the run is of `mode` and its trace
    saw the device work, else None."""
    if run.mode != mode or run.trace is None or run.trace.launches == 0:
        return None
    return run.trace


def idle_share(run, mode):
    t = traced(run, mode)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def launches_per_frame(run, mode):
    t = traced(run, mode)
    return None if t is None else per_frame(run, t.launches)


def hand_kernels_roofline(run, mode):
    """The hand kernels' bounds summed over their device times summed,
    over every call that codecbench/kernels/ counts, in %."""
    t = traced(run, mode)
    if t is None or not t.calls:
        return None
    return 100.0 * sum(b for _, _, b in t.calls) / sum(
        d for _, d, _ in t.calls)



def cpu_ms_per_frame(run, mode):
    """The process's CPU time over the window, a frame, in ms."""
    return per_frame(run, 1e3 * run.cpu_s) if run.mode == mode else None
