"""One run of one cell of the benchmark of daala_tpu_torch.

    python -m codecbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with a CUDA card.  The cell
names a configuration (codecbench/configs/<name>.json: the Encoder's
keywords and the picture) and a traffic mix (codecbench/mixes/<name>
.json: the mode, the content and the clip), both found through
BENCHMARK.json.  The run makes its clip from the seed, builds and warms
the port, measures for S seconds, checks what the window produced
against the plain reference (codecbench/check.py), and prints one JSON
line last: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones, each read by
codecbench/metrics/<name>.py), `device`, with --trace 1 `breakdown`,
and last `check`, each number compared beside its limit.

It exits with 3, and prints no result, without a card (or with fewer
cards than the cell asks for), and with 4 when jax or the JAX package
is loaded in the process once the window has closed.
"""

import time

T_START = time.perf_counter()  # noqa: E402 (set-up is timed from here)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "daala_tpu")


class Unavailable(RuntimeError):
    """The machine lacks what the cell needs."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def resolve_cell(root, workload):
    """(bench, cell, config, mix) of `workload` under the checkout
    `root`: BENCHMARK.json's entry, the configuration's file and
    codecbench/mixes/<traffic>.json."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit("no workload %r in BENCHMARK.json (have %s)"
                         % (workload, ", ".join(sorted(cells))))
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    mix = load_json(os.path.join(root, "codecbench", "mixes",
                                 cell["traffic"] + ".json"))
    return bench, cell, config, mix


def cell_metrics(bench, workload, kind):
    """The metrics of kind "end_to_end" or "per_layer" that the cell
    reports: each lists it under `workloads`, or has no such key."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def set_cache_dirs(root):
    """Every build and kernel cache at a fixed place in the checkout."""
    cache = os.path.join(os.path.abspath(root), "build", "codecbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def leaked_modules():
    """The modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole: daala_tpu_torch is not daala_tpu."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def device_of(cell, device):
    """The torch device of the run; raises Unavailable without the cards
    the cell asks for."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise Unavailable("torch sees no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        raise Unavailable("the cell asks for %d cards, torch sees %d"
                          % (cell["chips"], torch.cuda.device_count()))
    return torch.device("cuda:0")


def run_cell(workload, seed, seconds, trace, root=".", device=None,
             t_start=None):
    """Run one cell; returns (result, check) where result is the dict of
    the last line (without `check`) and check maps each compared number
    to (value, limit).  `device` None runs on the card; a test passes
    "cpu", which skips the look for a card."""
    import torch
    from codecbench import check as C
    from codecbench import window as W
    from codecbench.metrics import read_metrics
    bench, cell, config, mix = resolve_cell(root, workload)
    set_cache_dirs(root)
    dev = device_of(cell, device)
    t0 = T_START if t_start is None else t_start
    run = W.run_window(config, mix, seed, seconds, trace, dev, t0, root)
    t_check = time.perf_counter()
    checked = C.check(run, config, dev)
    print("codecbench: %s seed %d: %d frames in %.3f s, check %.3f s%s"
          % (workload, seed, run.frames, run.window_s,
             time.perf_counter() - t_check,
             "" if run.trace is None else
             ", trace read in %.3f s" % run.trace.reduce_s), file=sys.stderr)
    print("codecbench: %.3f s of the process's CPU time in the window; "
          "torch threads %d, CPUs %d" % (run.cpu_s, torch.get_num_threads(),
                                        len(os.sched_getaffinity(0))),
          file=sys.stderr)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, kind):
        if kind == "end_to_end":
            if m["name"] not in run.e2e:
                raise RuntimeError("the cell reports %s, which a %s window "
                                   "does not give" % (m["name"], run.mode))
            value = run.e2e[m["name"]]
        else:
            value = read_metrics(root, m["name"], run)
            if value is None:
                continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in checked.values())
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": run.device_info()}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    return result, checked


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, checked = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace))
    except Unavailable as e:
        print("codecbench: %s" % e, file=sys.stderr)
        return 3
    leaked = leaked_modules()
    if leaked:
        print("codecbench: loaded in this process: %s" % ", ".join(leaked),
              file=sys.stderr)
        return 4
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checked.items()}
    for k, (v, lim) in checked.items():
        print("check %s %r limit %r%s" % (k, v, lim,
                                           "" if v <= lim else " FAILED"),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
