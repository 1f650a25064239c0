"""Where a frame's time goes when the port encodes on a CUDA card.

Usage, from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and g++:

    python -m daala_tpu_torch.utils.profile [--out DIR] [--sweep]

It encodes bench.py's 1920x1080 translation clip (4 frames, quant 25,
complexity 7, the production trial-pass preset, encoder check on)
through daala_tpu_torch's Encoder on the card (with --sweep, in
mv_refine_mode="sweep"), and prints:

1. the card's name and power limit (nvidia-smi);
2. per frame, after one warm-up encode of the clip, REPS times: the
   host wall of `encode_frame` and the devstats counters of that frame
   (the `analyze_*` and `refine_sweep` spans, fetch wall, host<->device
   bytes, kernel launches);
3. a torch.profiler trace of a fresh encoder's keyframe and first inter
   frame, written as Chrome traces into `--out` and read back: the
   frame's wall, the device's busy time (the union of its kernel and
   copy intervals) and its share of the wall, split into copies, the
   hand-written kernels (csrc/) and other kernels, with counts;
4. as the last line, one JSON object with all of the above.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from daala_tpu_torch.ops.cuda import dct_kernels, lap_kernels, obmc_kernels

W, H, NFRAMES = 1920, 1080, 4
# bench.py's production trial-pass preset (bench.py:87-90).
ENCODER_KW = dict(quant=25, complexity=7, trial_rate_approx=True,
                  trial_prune_boost=3.0, trial_prune_rate_gate=0.5)
# Name fragments of the kernels in csrc/ (their __global__ functions, as
# each wrapper module lists them).
HAND_KERNELS = (dct_kernels.KERNELS + lap_kernels.KERNELS
                + obmc_kernels.KERNELS)
REPS = 2  # timed encodes of the clip after the warm-up


def translation_clip(w=W, h=H, nframes=NFRAMES):
    """bench.py make_clip("translation"): a smooth pattern under global
    translation plus fixed noise, 4:2:0 8-bit; a list of [y, cb, cr]."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 50 * np.sin(xx / 17.0) + 35 * np.cos(yy / 23.0)
            + 20 * np.sin((xx + yy) / 9.0))
    noise = rng.normal(0, 5, (h, w))
    frames = []
    for t in range(nframes):
        y = (np.roll(base, (2 * t, 3 * t), (0, 1)) + noise) \
            .clip(0, 255).astype(np.uint8)
        cb = (128 + 25 * np.sin((xx[::2, ::2] + 5 * t) / 19.0)) \
            .clip(0, 255).astype(np.uint8)
        cr = (128 + 25 * np.cos((yy[::2, ::2] + 4 * t) / 21.0)) \
            .clip(0, 255).astype(np.uint8)
        frames.append([y, cb, cr])
    return frames


def device_summary(events, wall_s):
    """Device time of a Chrome trace's events (torch.profiler's export):
    busy ms (union of kernel/copy intervals), its share of wall_s, and
    ms and counts per class: copies, hand kernels, other kernels."""
    classes = {"copies": [0.0, 0], "hand_kernels": [0.0, 0],
               "other_kernels": [0.0, 0]}
    spans = []
    for e in events:
        cat = e.get("cat")
        if cat in ("gpu_memcpy", "gpu_memset"):
            key = "copies"
        elif cat == "kernel":
            key = ("hand_kernels"
                   if any(k in e["name"] for k in HAND_KERNELS)
                   else "other_kernels")
        else:
            continue
        classes[key][0] += e["dur"] / 1e3
        classes[key][1] += 1
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy_us, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 >= end:
            busy_us += t1 - t0
            end = t1
        elif t1 > end:
            busy_us += t1 - end
            end = t1
    out = {"wall_s": wall_s, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / 1e6 / wall_s if wall_s else None}
    for key, (ms, count) in classes.items():
        out[key + "_ms"] = ms
        out[key + "_count"] = count
    return out


def _encoder(device, sweep):
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.encoder import Encoder
    enc = Encoder(headers.Info(pic_width=W, pic_height=H), device=device,
                  mv_refine_mode="sweep" if sweep else "greedy",
                  **ENCODER_KW)
    enc.keyframe_rate = 256
    enc.enable_encoder_check = True
    return enc


def per_frame(frames, device, sweep):
    """Host wall and devstats counters of every frame, REPS encodes of
    the clip after a warm-up encode."""
    from daala_tpu_torch.utils import devstats
    warm = _encoder(device, sweep)
    for fr in frames:
        warm.encode_frame(fr)
    warm.flush()
    rows = []
    for rep in range(REPS):
        enc = _encoder(device, sweep)
        for i, fr in enumerate(frames):
            devstats.reset()
            t0 = time.perf_counter()
            enc.encode_frame(fr)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            snap = devstats.snapshot()
            row = {"rep": rep, "frame": i, "wall_s": wall,
                   "front_end_s": sum(v for k, v in snap["spans_s"].items()
                                      if k.startswith("analyze_")),
                   **snap}
            row["front_end_share"] = row["front_end_s"] / wall
            rows.append(row)
            print("rep %d frame %d wall %.4f s; front end %.4f s (%.2f%%); "
                  "spans %s; fetch %.4f s; d2h %d h2d %d; launches %s"
                  % (rep, i, wall, row["front_end_s"],
                     100 * row["front_end_share"],
                     {k: round(v, 4) for k, v in snap["spans_s"].items()},
                     snap["fetch_wall_s"], snap["d2h_bytes"],
                     snap["h2d_bytes"], snap["launches"]))
        enc.flush()
    return rows


def traced(frames, device, out_dir, sweep):
    """torch.profiler traces of a fresh encoder's keyframe and first
    inter frame; returns their device summaries."""
    from torch.profiler import ProfilerActivity, profile
    enc = _encoder(device, sweep)
    res = {}
    for label, fr in (("keyframe", frames[0]), ("inter", frames[1])):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enc.encode_frame(fr)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        path = os.path.join(out_dir, "trace_%s.json" % label)
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        events = (trace["traceEvents"] if isinstance(trace, dict)
                  else trace)
        res[label] = s = device_summary(events, wall)
        print("trace %s: wall %.4f s, device busy %.3f ms (%.3f%%); copies "
              "%.3f ms (%d), hand kernels %.3f ms (%d), other kernels "
              "%.3f ms (%d); %s"
              % (label, wall, s["device_busy_ms"],
                 100 * s["device_busy_share"], s["copies_ms"],
                 s["copies_count"], s["hand_kernels_ms"],
                 s["hand_kernels_count"], s["other_kernels_ms"],
                 s["other_kernels_count"], path))
    enc.flush()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "profile"),
                    help="directory for the Chrome traces")
    ap.add_argument("--sweep", action="store_true",
                    help='encode with mv_refine_mode="sweep"')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    from daala_tpu_torch.device import resolve
    device = resolve("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    os.makedirs(args.out, exist_ok=True)
    frames = translation_clip()
    rows = per_frame(frames, device, args.sweep)
    traces = traced(frames, device, args.out, args.sweep)
    print(json.dumps({"card": card, "sweep": args.sweep, "frames": rows,
                      "traces": traces}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
