"""Where a frame's time goes when the port encodes on a CUDA card.

Usage, from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and g++:

    python -m daala_tpu_torch.utils.profile [--out DIR] [--sweep] [--lean]

It encodes bench.py's 1920x1080 translation clip (4 frames, quant 25,
complexity 7, the production trial-pass preset, encoder check on)
through daala_tpu_torch's Encoder on the card: in the analysis tier by
default, with --lean in bench.py's `device` configuration (the lean
tier: use_device_analysis=False, use_device_pvq=True), with --sweep in
mv_refine_mode="sweep" (either tier).  It prints:

1. the card's name and power limit (nvidia-smi);
2. per frame, after one warm-up encode of the clip, REPS times: the
   host wall of `encode_frame` and the devstats counters of that frame
   (the `analyze_*`, `search_frame`, `fullpel_sad_fields` and
   `refine_sweep` spans, fetch wall, host<->device bytes, kernel
   launches, the PVQ rows searched and marked invalid);
3. a torch.profiler trace of a fresh encoder's keyframe and first inter
   frame, written as Chrome traces into `--out` and read back: the
   frame's wall, the device's busy time (the union of its kernel and
   copy intervals) and its share of the wall, split into copies, the
   hand-written kernels (csrc/) and other kernels, with counts; and per
   call of `band_search` and of the SAD fields (their
   record_function ranges), the launches made in it, the device time
   of the work they launched and the call's host wall;
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



def _lowpass(a, k):
    """Separable box low-pass of width k (reflected edges); a copy of
    tests/content.py's."""
    if k <= 1:
        return a
    kernel = np.ones(k) / k
    a = np.apply_along_axis(lambda r: np.convolve(r, kernel, "same"), 0, a)
    a = np.apply_along_axis(lambda r: np.convolve(r, kernel, "same"), 1, a)
    return a


def _octave_noise(shape, rng, octaves=((3, 60), (9, 45), (27, 35))):
    """Filtered noise octaves: the 1/f-ish spatial spectrum of natural
    texture (grass, fabric, foliage) instead of a pure sinusoid."""
    acc = np.zeros(shape)
    for k, sigma in octaves:
        acc += _lowpass(rng.normal(0, sigma, shape), k)
    return acc


def make_natural_clip(w, h, nframes, seed=0, fourcc="420", grain=3.0):
    """bench.py make_clip("natural") (with seed=3): a copy of
    tests/content.py make_natural_clip.  Natural-statistics clip:
    multi-octave textured background with depth layers, a slow
    non-integer pan (subpel matters), a foreground occluder with
    independent motion revealing background, luminance flicker, and
    per-frame film grain."""
    rng = np.random.default_rng(seed)
    pad = 96
    W, H = w + 2 * pad, h + 2 * pad
    yy, xx = np.mgrid[0:H, 0:W]
    # Background: smooth illumination + texture octaves.
    bg = (120 + 40 * np.sin(xx / 171.0) + 25 * np.cos(yy / 133.0)
          + _octave_noise((H, W), rng))
    # A second (nearer) layer with stronger texture, moving faster.
    fgtex = (140 + _octave_noise(
        (H, W), np.random.default_rng(seed + 1),
        octaves=((3, 80), (15, 50))))
    # Foreground occluder mask: a soft-edged blob.
    oy, ox = np.mgrid[0:h // 2, 0:w // 2]
    blob = (((oy - h / 4.0) / (h / 4.0)) ** 2
            + ((ox - w / 4.0) / (w / 4.0)) ** 2) < 0.8
    frames = []
    for t in range(nframes):
        # Non-integer pan rates; layers move at different speeds
        # (parallax) so occlusion boundaries shift every frame.
        bx = pad + int(round(1.7 * t))
        by = pad + int(round(0.9 * t))
        fx = pad + int(round(3.4 * t))
        fy = pad + int(round(1.2 * t))
        img = bg[by:by + h, bx:bx + w].copy()
        # Luminance flicker (rate-control stressor).
        img *= 1.0 + 0.02 * np.sin(t / 2.3)
        # Occluder placement drifts with its own motion.
        py = (h // 4 + int(round(2.6 * t))) % (h - h // 2)
        px = (w // 6 + int(round(4.1 * t))) % (w - w // 2)
        patch = fgtex[fy + py:fy + py + h // 2,
                      fx + px:fx + px + w // 2]
        region = img[py:py + h // 2, px:px + w // 2]
        img[py:py + h // 2, px:px + w // 2] = \
            np.where(blob, patch, region)
        # Film grain: white noise, fresh every frame.
        img = img + rng.normal(0, grain, (h, w))
        y = np.clip(img, 0, 255).astype(np.uint8)
        if fourcc == "444":
            cb = np.clip(128 + 0.25 * (img - 128), 0, 255) \
                .astype(np.uint8)
            cr = np.clip(128 - 0.18 * (img - 128), 0, 255) \
                .astype(np.uint8)
        else:
            sub = img[::2, ::2]
            cb = np.clip(128 + 0.25 * (sub - 128), 0, 255) \
                .astype(np.uint8)
            cr = np.clip(128 - 0.18 * (sub - 128), 0, 255) \
                .astype(np.uint8)
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


# The runtime calls that put work on the device.
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
             "cudaMemsetAsync")


def span_device_work(events, name):
    """Per range `name` of a Chrome trace (a torch.profiler
    record_function, category user_annotation), in order: the launches
    made inside it (kernel launches, async copies and memsets), the
    device time of the work they launched (by correlation id) and the
    range's host wall, in ms."""
    dev_us = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            c = e.get("args", {}).get("correlation")
            dev_us[c] = dev_us.get(c, 0.0) + e["dur"]
    launches = [(e["ts"], e.get("args", {}).get("correlation"))
                for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith(_LAUNCHES)]
    out = []
    for e in sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") == name), key=lambda e: e["ts"]):
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        inside = [c for ts, c in launches if t0 <= ts <= t1]
        out.append({"launches": len(inside),
                    "device_ms": sum(dev_us.get(c, 0.0)
                                     for c in inside) / 1e3,
                    "wall_ms": e["dur"] / 1e3})
    return out


def _encoder(device, sweep, lean=False):
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.encoder import Encoder
    enc = Encoder(headers.Info(pic_width=W, pic_height=H), device=device,
                  mv_refine_mode="sweep" if sweep else "greedy",
                  use_device_analysis=not lean, use_device_pvq=lean,
                  **ENCODER_KW)
    enc.keyframe_rate = 256
    enc.enable_encoder_check = True
    return enc


def per_frame(frames, device, sweep, lean=False):
    """Host wall and devstats counters of every frame, REPS encodes of
    the clip after a warm-up encode."""
    from daala_tpu_torch.utils import devstats
    warm = _encoder(device, sweep, lean)
    for fr in frames:
        warm.encode_frame(fr)
    warm.flush()
    rows = []
    for rep in range(REPS):
        enc = _encoder(device, sweep, lean)
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
                  "spans %s; fetch %.4f s; d2h %d h2d %d; launches %s; "
                  "counts %s"
                  % (rep, i, wall, row["front_end_s"],
                     100 * row["front_end_share"],
                     {k: round(v, 4) for k, v in snap["spans_s"].items()},
                     snap["fetch_wall_s"], snap["d2h_bytes"],
                     snap["h2d_bytes"], snap["launches"], snap["counts"]))
        enc.flush()
    return rows


def traced(frames, device, out_dir, sweep, lean=False):
    """torch.profiler traces of a fresh encoder's keyframe and first
    inter frame; returns their device summaries, with the device work of
    each band_search and SAD-field call."""
    from torch.profiler import ProfilerActivity, profile
    enc = _encoder(device, sweep, lean)
    res = {}
    for label, fr in (("keyframe", frames[0]), ("inter", frames[1])):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enc.encode_frame(fr)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        path = os.path.join(out_dir, "trace_%s%s.json"
                            % (label, "_lean" if lean else ""))
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        events = (trace["traceEvents"] if isinstance(trace, dict)
                  else trace)
        res[label] = s = device_summary(events, wall)
        for name in ("band_search", "fullpel_sad_fields"):
            s[name] = span_device_work(events, name)
        print("trace %s: wall %.4f s, device busy %.3f ms (%.3f%%); copies "
              "%.3f ms (%d), hand kernels %.3f ms (%d), other kernels "
              "%.3f ms (%d); %s"
              % (label, wall, s["device_busy_ms"],
                 100 * s["device_busy_share"], s["copies_ms"],
                 s["copies_count"], s["hand_kernels_ms"],
                 s["hand_kernels_count"], s["other_kernels_ms"],
                 s["other_kernels_count"], path))
        for name in ("band_search", "fullpel_sad_fields"):
            for k, c in enumerate(s[name]):
                print("trace %s: %s call %d: %d launches, device %.3f ms, "
                      "host wall %.3f ms" % (label, name, k, c["launches"],
                                             c["device_ms"], c["wall_ms"]))
    enc.flush()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "profile"),
                    help="directory for the Chrome traces")
    ap.add_argument("--sweep", action="store_true",
                    help='encode with mv_refine_mode="sweep"')
    ap.add_argument("--lean", action="store_true",
                    help="encode in the lean tier (use_device_analysis="
                    "False, use_device_pvq=True: bench.py's device "
                    "configuration)")
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
    rows = per_frame(frames, device, args.sweep, args.lean)
    traces = traced(frames, device, args.out, args.sweep, args.lean)
    print(json.dumps({"card": card, "sweep": args.sweep, "lean": args.lean,
                      "frames": rows, "traces": traces}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
