"""Native motion search: the wall of its greedy refinement a frame, in
ms, from the port's devstats counter me_refine_us (the microseconds
between two steady_clock reads around each refine_mvs call of the native
engine, codec/mvest.py estimate_all_native).  None where the run is not
an encode or its program keeps no such counter; the line then leaves the
metric out."""

from codecbench.metrics import per_frame


def read(run):
    if run.mode != "encode":
        return None
    us = run.stats["counts"].get("me_refine_us")
    return None if us is None else per_frame(run, us / 1e3)
