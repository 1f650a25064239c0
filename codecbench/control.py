"""The control of the check: every compared number read from the sound
reference and from the reference one precision down, on a cell's own
window, for several seeds in one process.

    python -m codecbench.control --workload CELL --seeds 1,2,3 --seconds S

For each seed it runs the cell's window (as codecbench.run does, without
tracing), then prints one JSON line: the seed, the sound readings (the
numbers `check` compares, each against the port) and the control's
(codecbench/check.py `readings(control=True)`, each stage's one
precision down: int16 lifting and sums, the PVQ search on
bfloat16-rounded planes, the OBMC accumulator and the dering directions'
costs in int16, put in the port's place).
The control has to read above a limit on every seed; the sound readings
on a dozen seeds and more set the lower end (PERF.md).  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    from codecbench import check as C
    from codecbench import run as R
    from codecbench import window as W
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench, cell, config, mix = R.resolve_cell(".", args.workload)
    R.set_cache_dirs(".")
    try:
        dev = R.device_of(cell, None)
    except R.Unavailable as e:
        print("codecbench.control: %s" % e, file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        run = W.run_window(config, mix, seed, args.seconds, False, dev,
                           time.perf_counter())
        t0 = time.perf_counter()
        sound = C.readings(run, config, dev)
        t1 = time.perf_counter()
        low = C.readings(run, config, dev, control=True)
        print(json.dumps({"seed": seed, "frames": run.frames,
                          "sound": sound, "control": low,
                          "reference_s": t1 - t0,
                          "control_s": time.perf_counter() - t1}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
