"""Quality evidence for the port's device configurations: BD-rate tables
with per-seed spread.

Usage, from the repository root (on a CUDA card unless --device cpu):

    python -m daala_tpu_torch.utils.sweep_quality \\
        [--configs device_pvq,mv_sweep] [--size 832x480] \\
        [--pvq-size 320x192] [--frames 6] [--quants 8,12,18,25,40,60] \\
        [--classes smooth,mixed,natural] [--seeds 0,1] [--out FILE] \\
        [--device cuda]

The counterpart of tools/sweep_quality.py for its two device
configurations, through the port's Encoder and Decoder on `device`.
Each sweeps a candidate against its anchor across the synthetic corpus
classes, the quantizers and the seeds, and prints one JSON line per
(class, seed) and a summary per class (mean / min / max BD-rate, the
candidate's encode time over the anchor's).

Configurations (--configs):
  device_pvq   the lean tier's whole-frame PVQ band search on the
               device (use_device_pvq, with the analysis tier as the
               JAX tool sets it) vs the host search; at --pvq-size
  mv_sweep     the colour-sweep MV refinement on the device
               (mv_refine_mode="sweep") vs the greedy host refinement
               loop, both at complexity 7; at --size

Both anchors run in the analysis tier (use_device_analysis=True), whose
packets are the host encoder's byte for byte: the port's Encoder
refuses to run with no device tier, so this is how it gives the JAX
tool's host anchors.  The tool's host-only configurations (fast_trial,
thorough_me, rc) are not here.  Counterpart of the reference's
tools/rd_collect.sh + tools/bd_rate.sh flow.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

from daala_tpu_torch.codec import headers as H
from daala_tpu_torch.codec.decoder import Decoder
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.device import resolve
from daala_tpu_torch.utils.metrics import bd_rate
from daala_tpu_torch.utils.profile import _lowpass, make_natural_clip


def make_smooth_clip(w, h, nframes, seed=0):
    """Smooth gradients + gentle pan (the easy class); a copy of
    tools/sweep_trial.py make_smooth_clip."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 50 * np.sin(xx / 17.0) + 35 * np.cos(yy / 23.0)
            + 20 * np.sin((xx + yy) / 9.0))
    # Light noise only: heavy static grain puts a PSNR floor under the
    # whole curve (quality stops varying with quantizer) and the BD fit
    # degenerates.
    noise = rng.normal(0, 1.5, (h, w))
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


def make_scene(w, h, seed=0):
    """A single 'natural-ish' luma scene: gradient base + two texture
    scales + hard-edged rectangles + glyph-like strokes; a copy of
    tests/content.py make_scene."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 96 + 64 * (xx / w) + 32 * np.sin(yy / 41.0)
    tex_fine = _lowpass(rng.normal(0, 30, (h, w)), 3)
    tex_coarse = _lowpass(rng.normal(0, 60, (h, w)), 15)
    img = base + 0.6 * tex_fine + 0.8 * tex_coarse
    # Hard-edged rectangles (synthetic foreground objects).
    for i in range(6):
        x0 = int(rng.integers(0, max(1, w - w // 5)))
        y0 = int(rng.integers(0, max(1, h - h // 5)))
        bw = int(rng.integers(w // 20, w // 5))
        bh = int(rng.integers(h // 20, h // 5))
        img[y0:y0 + bh, x0:x0 + bw] = rng.integers(30, 220)
    # Text-like strokes (thin high-contrast lines).
    for i in range(20):
        x0 = int(rng.integers(0, w - 30))
        y0 = int(rng.integers(0, h - 4))
        img[y0:y0 + 2, x0:x0 + int(rng.integers(8, 30))] = 235
    return img


def make_clip(w, h, nframes, seed=0, fourcc="420"):
    """Multi-scene clip (the mixed class): global pan + a moving object
    + a mid-clip scene cut; a copy of tests/content.py make_clip.
    Returns a list of [Y, Cb, Cr] uint8 plane lists."""
    pad = 64
    scenes = [make_scene(w + 2 * pad, h + 2 * pad, seed=seed + i)
              for i in range(2)]
    cut = nframes // 2
    frames = []
    for t in range(nframes):
        sc = scenes[0] if t < cut else scenes[1]
        tt = t if t < cut else t - cut
        # Global pan (non-integer rate so subpel matters).
        ox = pad + int(round(1.6 * tt))
        oy = pad + int(round(0.7 * tt))
        img = sc[oy:oy + h, ox:ox + w].copy()
        # A moving object with its own motion.
        obw, obh = w // 8, h // 8
        mx = (w // 4 + 3 * tt) % max(1, w - obw)
        my = (h // 3 + 2 * tt) % max(1, h - obh)
        img[my:my + obh, mx:mx + obw] = \
            img[my:my + obh, mx:mx + obw] * 0.3 + 180 * 0.7
        y = np.clip(img, 0, 255).astype(np.uint8)
        if fourcc == "444":
            cb = np.clip(128 + 0.3 * (img - 128), 0, 255).astype(np.uint8)
            cr = np.clip(128 - 0.2 * (img - 128), 0, 255).astype(np.uint8)
        else:
            sub = img[::2, ::2]
            cb = np.clip(128 + 0.3 * (sub - 128), 0, 255).astype(np.uint8)
            cr = np.clip(128 - 0.2 * (sub - 128), 0, 255).astype(np.uint8)
        frames.append([y, cb, cr])
    return frames


MAKERS = {"smooth": make_smooth_clip, "mixed": make_clip,
          "natural": make_natural_clip}

# name: (anchor's Encoder keywords, candidate's, anchor cx, candidate cx)
CONFIGS = {
    "mv_sweep": ({}, {"mv_refine_mode": "sweep"}, 7, 7),
    "device_pvq": ({"use_device_analysis": True},
                   {"use_device_analysis": True, "use_device_pvq": True},
                   7, 7),
}


def encode_clip(frames, w, h, quant, enc_kw, complexity=7, device="cuda"):
    """The data packets of `frames` through the port's Encoder on
    `device` with the keywords `enc_kw`, and the encode's wall (host
    clock; every frame's packets are on the host when it returns)."""
    info = H.Info(pic_width=w, pic_height=h)
    enc = Encoder(info, quant=quant, complexity=complexity, device=device,
                  **enc_kw)
    enc.keyframe_rate = 256
    pkts = list(enc.flush_headers())
    t0 = time.perf_counter()
    for fr in frames:
        pkts += enc.encode_frame(fr)
    pkts += enc.flush()
    dt = time.perf_counter() - t0
    return [bytes(p) for p in pkts[3:]], dt


def run_encode(frames, w, h, quant, enc_kw, complexity=7, device="cuda"):
    """Encode + decode (the port's Decoder on `device`); returns (bytes,
    luma PSNR, encode wall seconds)."""
    pkts, dt = encode_clip(frames, w, h, quant, enc_kw, complexity, device)
    dec = Decoder(H.Info(pic_width=w, pic_height=h), device=device)
    outs = [f for p in pkts for f in dec.decode_packet(p)]
    if len(outs) != len(frames):
        raise RuntimeError("decoded %d frames of %d" % (len(outs),
                                                       len(frames)))
    mse = np.mean([
        np.mean((np.asarray(a[0]).astype(np.float64)
                 - np.asarray(b[0]).astype(np.float64)) ** 2)
        for a, b in zip(frames, outs)])
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    return sum(map(len, pkts)), psnr, dt


def sweep_bd(name, classes, seeds, quants, w, h, nframes, device="cuda"):
    """One JSON line per (class, seed) and a summary row per class; returns
    the summary rows."""
    a_kw, c_kw, a_cx, c_cx = CONFIGS[name]
    device = str(resolve(device))
    rows = []
    for cls in classes:
        bds = []
        tratio = []
        for seed in seeds:
            frames = MAKERS[cls](w, h, nframes, seed=seed)
            anchor, cand = [], []
            ta = tc = 0.0
            for q in quants:
                nb, ps, dt = run_encode(frames, w, h, q, a_kw, a_cx, device)
                anchor.append((nb, ps))
                ta += dt
                nb, ps, dt = run_encode(frames, w, h, q, c_kw, c_cx, device)
                cand.append((nb, ps))
                tc += dt
            bd = bd_rate([r for r, _ in anchor], [d for _, d in anchor],
                         [r for r, _ in cand], [d for _, d in cand])
            bds.append(bd)
            tratio.append(tc / max(ta, 1e-9))
            print(json.dumps({
                "config": name, "class": cls, "seed": seed,
                "bd_rate_pct": round(bd, 3),
                "time_vs_anchor": round(tc / max(ta, 1e-9), 3),
                "anchor": anchor, "candidate": cand}), flush=True)
        rows.append({
            "config": name, "class": cls, "n_seeds": len(seeds),
            "quants": quants, "size": "%dx%d" % (w, h),
            "frames": nframes, "device": device,
            "bd_rate_mean_pct": round(float(np.mean(bds)), 3),
            "bd_rate_min_pct": round(float(np.min(bds)), 3),
            "bd_rate_max_pct": round(float(np.max(bds)), 3),
            "time_vs_anchor_mean": round(float(np.mean(tratio)), 3)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def card_line(device):
    """The card's name and power limit, as nvidia-smi gives them, for a
    CUDA device; the device's name otherwise."""
    if resolve(device).type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="device_pvq,mv_sweep")
    ap.add_argument("--size", default="832x480")
    ap.add_argument("--pvq-size", default="320x192",
                    help="smaller size for the device_pvq sweep")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--quants", default="8,12,18,25,40,60")
    ap.add_argument("--classes", default="smooth,mixed,natural")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--out", default=None, help="write summary JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoders' device tier and the "
                         "decoder's back end (default: cuda)")
    args = ap.parse_args(argv)
    names = args.configs.split(",")
    for name in names:
        if name not in CONFIGS:
            ap.error("unknown configuration %r (have %s)"
                     % (name, ", ".join(sorted(CONFIGS))))
    print("device: %s" % card_line(args.device), flush=True)
    w, h = map(int, args.size.split("x"))
    pw, ph = map(int, args.pvq_size.split("x"))
    quants = [int(q) for q in args.quants.split(",")]
    classes = args.classes.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = []
    for name in names:
        sw, sh = (pw, ph) if name == "device_pvq" else (w, h)
        summary += sweep_bd(name, classes, seeds, quants, sw, sh,
                            args.frames, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
        print("wrote %s" % args.out)


if __name__ == "__main__":
    main()
