"""The arithmetic of the readers of the port's host spans (devstats
`host_spans_s`: the host passes between the device spans, placed at the
native call sites of codec/encoder.py and codec/decoder.py).  Not a
metric of its own.

A program that keeps no host spans leaves `host_spans_s` out of its
snapshot; its readers then give None, and the line leaves the metric
out."""

from codecbench.metrics import per_frame


def _host_spans(run, mode):
    """The run's host spans, or None where the run is of another mode or
    its program keeps none."""
    if run.mode != mode:
        return None
    return run.stats.get("host_spans_s") or None


def host_span_ms_per_frame(run, mode, *names):
    """Milliseconds of the host spans `names` a frame, or None where none
    of them ran."""
    spans = _host_spans(run, mode)
    keys = [k for k in names if spans and k in spans]
    if not keys:
        return None
    return per_frame(run, 1e3 * sum(spans[k] for k in keys))


def untraced_ms_per_frame(run, mode):
    """The frame walls less every span of both tables, a frame, in ms:
    what no span of the port covers."""
    spans = _host_spans(run, mode)
    if spans is None:
        return None
    covered = sum(run.stats["spans_s"].values()) + sum(spans.values())
    return per_frame(run, 1e3 * (sum(run.frame_walls) - covered))
