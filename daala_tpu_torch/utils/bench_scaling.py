"""Config 5's scaling on the port: N clips through the batched multi-clip
encoder, round robin against one host thread per clip.

Usage, from the repository root:

    python -m daala_tpu_torch.utils.bench_scaling [--clips 2]
        [--width 640] [--height 352] [--frames 4] [--quant 25]
        [--complexity 7] [--device cuda]

The counterpart of tools/bench_scaling.py's device leg.  It encodes
`--clips` clips (utils/sweep_quality.make_clip, seeds 10, 11, ...: the
port's copy of tests/content.py make_clip) with parallel/mesh.py
encode_clips_batched on make_mesh(dp=1) (every card; --device cpu
gives devices=["cpu"]), at the production trial-pass preset, under its
two schedules:

  serial    one host thread, the clips round robin per frame;
  threaded  one host thread (and CUDA stream) per clip, so that one
            clip's device work is issued while another's native entropy
            pass runs.

Both schedules are warmed once, then each is timed twice and its best
kept.  The packets are byte-identical across schedules and to serial
encodes (tests/test_torch_parallel.py); this measures only the wall.
It prints one JSON line with tools/bench_scaling.py's keys, every
run's wall (serial_walls_s, threaded_walls_s), the card's name and
power limit (`card`) and torch's intra-op threads (`torch_threads`),
after checking that neither jax nor daala_tpu was imported.

The host-only leg (--host there) has no counterpart: the port's
Encoder refuses to run with no device tier.  `python
tools/bench_scaling.py --host` gives it on the same machine without
JAX.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from daala_tpu_torch import bench
from daala_tpu_torch.parallel import mesh as PM
from daala_tpu_torch.utils.sweep_quality import card_line, make_clip

# tools/bench_scaling.py's preset (:43-44).
ENC_KW = dict(trial_rate_approx=True, trial_prune_boost=3.0,
              trial_prune_rate_gate=0.5)


def make_clips(n, w, h, nframes):
    return [make_clip(w, h, nframes, seed=10 + c) for c in range(n)]


def run(clips, w, h, mesh, threads, quant, complexity):
    """The wall of one encode_clips_batched call, started with the mesh's
    devices idle (its packets are host bytes when it returns)."""
    if mesh[0, 0].type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    PM.encode_clips_batched(
        clips, dict(pic_width=w, pic_height=h), mesh, quant=quant,
        complexity=complexity, enc_kwargs=ENC_KW, threads=threads)
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=352)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--quant", type=int, default=25)
    ap.add_argument("--complexity", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="cuda: every card (default); cpu: the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        mesh = PM.make_mesh(dp=1)
    else:
        mesh = PM.make_mesh(dp=1, devices=[args.device])
    clips = make_clips(args.clips, args.width, args.height, args.frames)
    walls = {}
    for threads in (False, True):
        run(clips, args.width, args.height, mesh, threads, args.quant,
            args.complexity)
    for threads in (False, True):
        walls[threads] = [run(clips, args.width, args.height, mesh, threads,
                              args.quant, args.complexity)
                          for _ in range(2)]
    t_serial, t_thread = min(walls[False]), min(walls[True])
    total = args.clips * args.frames
    bench.check_imports()
    print(json.dumps({
        "metric": "config5_batched_encode_scaling",
        "clips": args.clips, "w": args.width, "h": args.height,
        "frames_per_clip": args.frames,
        "device": True,
        "serial_s": t_serial,
        "threaded_s": t_thread,
        "serial_fps": total / t_serial,
        "threaded_fps": total / t_thread,
        "speedup": t_serial / t_thread,
        "serial_walls_s": walls[False],
        "threaded_walls_s": walls[True],
        "card": card_line(mesh[0, 0]),
        "torch_threads": torch.get_num_threads(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
