"""Host-device traffic of the encoder: the port's devstats h2d and d2h
bytes a frame, in MB."""

from codecbench.metrics import per_frame


def read(run):
    if run.mode != "encode":
        return None
    return per_frame(run, (run.stats["h2d_bytes"]
                           + run.stats["d2h_bytes"]) / 1e6)
