"""PVQ band search: the rows searched (devstats count pvq_rows) a frame."""

from codecbench.metrics import per_frame


def read(run):
    rows = run.stats["counts"].get("pvq_rows")
    return None if rows is None else per_frame(run, rows)
