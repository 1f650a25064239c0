"""End-to-end encode throughput of the port on a CUDA card: the
counterpart of bench.py's device legs.

Usage, from the repository root:

    python -m daala_tpu_torch.bench [--config NAME] [--device cuda]
        [--size 1920x1080] [--frames 4]

It times daala_tpu_torch's Encoder on bench.py's two clips (1920x1080,
4 frames: the global-translation clip and the natural-statistics clip
with seed 3), at quant 25, complexity 7, with bench.py's production
preset (the fast trial pass with the boosted, rate-gated prune;
keyframe_rate 256; encoder check off), in one of three configurations
(CONFIGS, each a set of Encoder keywords):

  analysis      the analysis tier (use_device_analysis), whose packets
                are the host encoder's byte for byte
  device        the lean tier (use_device_pvq): bench.py's `device`
  device+sweep  the lean tier with the colour-sweep MV refinement:
                bench.py's `device+sweep`

There is no host configuration: the port's Encoder refuses to run with
no device tier.  `python bench.py`, run unchanged on the same machine
without JAX, times the host encoder, the denominator.

Without --config it first probes every configuration, each in its own
process under a budget of 900 s (bench.py's probe): on the first 2
frames of the translation clip, a warm run and a measured run; the
measured run's Mpix/s, keyframe and inter walls and devstats, and the
warm run's kernel builds.  device+sweep is skipped where device failed.
The fastest configuration then times each clip in two runs, and its
best is the headline (`value`, Mpix/s over both clips); every run's
wall is printed beside it.  The reference C encoder runs between the
pairs where tests/codec_oracle.py can build it (`vs_baseline`, else
null).

The last line of its output is one JSON object with bench.py's keys
(metric, value, unit, vs_baseline, config.per_content, config.probe),
config.name (the configuration timed), each clip's bytes and walls_s,
the card's name and power limit (`card`, as nvidia-smi gives them) and
torch's intra-op threads (`torch_threads`).  A configuration whose
probe fails is reported as "error: ..."; if all fail, the script exits
with an error.  It runs on the card unless --device cpu is given, and
raises without one.

    python -m daala_tpu_torch.bench --probe-one NAME

prints the probe of configuration NAME as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from daala_tpu_torch.codec import headers
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.device import resolve
from daala_tpu_torch.utils import devstats
from daala_tpu_torch.utils.profile import make_natural_clip, translation_clip
from daala_tpu_torch.utils.sweep_quality import card_line

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, NFRAMES = 1920, 1080, 4
QUANT, COMPLEXITY = 25, 7
CONTENTS = ("translation", "natural")
PROBE_BUDGET_S = 900
# bench.py's production speed preset (bench.py:87-90).
PRESET = dict(trial_rate_approx=True, trial_prune_boost=3.0,
              trial_prune_rate_gate=0.5)
CONFIGS = {
    "analysis": dict(use_device_analysis=True),
    "device": dict(use_device_analysis=False, use_device_pvq=True),
    "device+sweep": dict(use_device_analysis=False, use_device_pvq=True,
                         mv_refine_mode="sweep"),
}


def make_clip(content="translation", nframes=NFRAMES, w=W, h=H):
    """bench.py make_clip(content, nframes), at w x h."""
    if content == "natural":
        return make_natural_clip(w, h, nframes, seed=3)
    return translation_clip(w, h, nframes)


def bench_ours(frames, config, device):
    """Encode `frames` with configuration `config` on `device`; returns
    (Mpix/s, data bytes, keyframe wall, total wall).  The clock starts
    with the device idle; every packet is host bytes when encode_frame
    returns, so the clock stops without a sync."""
    h, w = frames[0][0].shape
    enc = Encoder(headers.Info(pic_width=w, pic_height=h), quant=QUANT,
                  complexity=COMPLEXITY, device=device, **PRESET,
                  **CONFIGS[config])
    enc.keyframe_rate = 256
    if resolve(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = 0
    kf_wall = 0.0
    for i, fr in enumerate(frames):
        tf = time.perf_counter()
        for p in enc.encode_frame(fr):
            nbytes += len(p)
        if i == 0:
            kf_wall = time.perf_counter() - tf
    for p in enc.flush():
        nbytes += len(p)
    dt = time.perf_counter() - t0
    return len(frames) * w * h / dt / 1e6, nbytes, kf_wall, dt


def probe_one(name, device, w, h):
    """A warm run and a measured run of configuration `name` on the first
    2 frames of the translation clip, with devstats reset before each."""
    short = make_clip("translation", 2, w, h)
    devstats.reset()
    bench_ours(short, name, device)
    warm = devstats.snapshot()
    devstats.reset()
    v, _, kf_wall, dt = bench_ours(short, name, device)
    return {"config": name, "mpix_s": v, "kf_wall_s": kf_wall,
            "inter_wall_s": dt - kf_wall, "dev": devstats.snapshot(),
            "builds_s": warm["builds_s"]}


def probe_device_mode(device, w, h):
    """Probe every configuration, each in its own process under
    PROBE_BUDGET_S; returns (the fastest one's name, the probes).
    Raises when every probe failed."""
    results = {}
    for name in CONFIGS:
        if name == "device+sweep" and not isinstance(results.get("device"),
                                                     dict):
            results[name] = "skipped (device failed)"
            continue
        try:
            r = subprocess.run(
                [sys.executable, "-m", "daala_tpu_torch.bench",
                 "--probe-one", name, "--device", device,
                 "--size", "%dx%d" % (w, h)],
                capture_output=True, text=True, timeout=PROBE_BUDGET_S,
                cwd=ROOT)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("{")]
            if r.returncode == 0 and lines:
                results[name] = json.loads(lines[-1])
            else:
                results[name] = "error: rc=%d %s" % (
                    r.returncode, r.stderr.strip()[-120:])
        except subprocess.TimeoutExpired:
            results[name] = "error: timed out (%ds)" % PROBE_BUDGET_S
    timed = [(v["mpix_s"], n) for n, v in results.items()
             if isinstance(v, dict)]
    if not timed:
        raise RuntimeError("every configuration failed its probe: %s"
                           % json.dumps(results))
    return max(timed)[1], results


def bench_reference_c(frames):
    """The reference C encoder's Mpix/s on `frames` (bench.py's), or None
    where tests/codec_oracle.py cannot build it."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    try:
        import codec_oracle as co
        co.get_lib()
    except Exception:
        return None
    h, w = frames[0][0].shape
    enc = co.RefEncoder(w, h, quant=QUANT, complexity=COMPLEXITY,
                        keyframe_rate=256)
    enc.flush_headers()
    t0 = time.perf_counter()
    for i, fr in enumerate(frames):
        enc.encode_frame(fr, last=(i == len(frames) - 1))
    dt = time.perf_counter() - t0
    return len(frames) * w * h / dt / 1e6


def check_imports():
    """Raise if jax or daala_tpu was imported into this process."""
    leaked = sorted(m for m in sys.modules if m in ("jax", "daala_tpu")
                    or m.startswith(("jax.", "daala_tpu.")))
    if leaked:
        raise AssertionError("imported: %s" % leaked)


def bench(name, device, w, h, nframes):
    """Each clip in two runs of configuration `name`, alternating with
    the reference C encoder; returns (config.per_content, the headline
    Mpix/s over both clips, vs_baseline)."""
    per_content = {}
    tot_pix = tot_ours_s = tot_ref_s = 0.0
    have_ref = True
    for content in CONTENTS:
        frames = make_clip(content, nframes, w, h)
        devstats.reset()
        value, nbytes, kf_wall, dt = bench_ours(frames, name, device)
        stats = devstats.snapshot()
        baseline = bench_reference_c(frames)
        v2, nb2, _, dt2 = bench_ours(frames, name, device)
        b2 = bench_reference_c(frames)
        if nb2 != nbytes:
            raise AssertionError("%s: %d bytes, then %d" % (content, nbytes,
                                                            nb2))
        walls = [dt, dt2]
        value = max(value, v2)
        pix = len(frames) * w * h
        tot_pix += pix
        tot_ours_s += min(walls)
        entry = {"ours_mpix_s": value, "kf_wall_s": kf_wall,
                 "walls_s": walls, "bytes": nbytes, "dev": stats}
        if baseline and b2:
            baseline = max(baseline, b2)
            tot_ref_s += pix / (baseline * 1e6)
            entry["ref_mpix_s"] = baseline
            entry["ratio"] = value / baseline
        else:
            have_ref = False
        per_content[content] = entry
    vs = tot_ref_s / tot_ours_s if have_ref and tot_ref_s else None
    return per_content, tot_pix / tot_ours_s / 1e6, vs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe-one", metavar="NAME", choices=sorted(CONFIGS),
                    help="print the probe of one configuration and exit")
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    help="time this configuration without the probe")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoder's device tier "
                         "(default: cuda)")
    ap.add_argument("--size", default="%dx%d" % (W, H), help="WxH")
    ap.add_argument("--frames", type=int, default=NFRAMES)
    args = ap.parse_args(argv)
    w, h = map(int, args.size.split("x"))
    device = str(resolve(args.device))
    if args.probe_one:
        out = probe_one(args.probe_one, device, w, h)
        check_imports()
        print(json.dumps(out))
        return 0
    probe = None
    name = args.config
    if name is None:
        name, probe = probe_device_mode(device, w, h)
    per_content, value, vs = bench(name, device, w, h, args.frames)
    check_imports()
    print(json.dumps({
        "metric": "1080p_e2e_encode_throughput",
        "value": value,
        "unit": "Mpixels/s",
        "vs_baseline": vs,
        "config": {"name": name,
                   "device_analysis": name.startswith("device"),
                   "mv_sweep": name == "device+sweep",
                   "size": "%dx%d" % (w, h), "frames": args.frames,
                   "per_content": per_content,
                   "probe": probe},
        "card": card_line(device),
        "torch_threads": torch.get_num_threads(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
