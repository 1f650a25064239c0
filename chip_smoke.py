#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (daala_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card, the
CUDA toolkit (nvcc) and g++:

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits nonzero:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; builds the native host engine and the three CUDA
   sources (lap_frame, dct_frame, obmc_leaf; into build/, first use
   only, all nvcc runs at once) and prints each build's seconds.
2. Kernel vs plain PyTorch version, on the card, at the 1080p encoder's
   shapes: lap_frame forward and inverse on a (1088, 1920) luma plane
   (superblock 64) and a (544, 960) chroma plane (superblock 32);
   dct_frame forward and inverse at n = 4..64 on luma and n = 4..32 on
   chroma.  Inputs are int32 in +-2^14 from a seed.  Each kernel must
   equal its plain version bit for bit and inverse(forward(x)) == x.
   Times are CUDA-event medians over batches of launches.
2b. The OBMC kernels against their plain versions, on the padded 1080p
   luma plane (4, 1216, 2048) and a chroma plane (4, 608, 1024), with
   random leaves tiling the plane (random slots, MVs in +-256 1/8-pel,
   all 16 blend setups (oc, s)): obmc_blend at n = 8..64 on luma and
   n = 4..32 on chroma, 8-bit and 12-bit; obmc_leaf_cells at n = 8..64
   on luma against a 1920x1080 visible area (ragged below).  Bit for
   bit; times as in phase 2.
2c. Device OBMC prediction: models/obmc.py predict_frame_plane_device on
   the card against the host predictor (codec/mc.py mc_predict_frame)
   on a random 1080p mesh with every subdivision level, all three
   planes, 8-bit P-frame references and 12-bit full-precision B-frame
   references.  Equal planes; obmc_blend must have launched.
3. The encoder end to end: bench.py's 1920x1080 translation clip, 4
   frames, quant 25, complexity 7, the production trial-pass preset,
   encoded with daala_tpu_torch's Encoder(device="cuda") (encoder check
   on: every packet is decoded and its reconstruction compared) and
   with daala_tpu's host Encoder at the same settings.  The packets must
   be byte-identical, and both analysis kernels must have launched in
   the port's run (launch counts are reset just before it).
4. The colour-sweep encode (mv_refine_mode="sweep", encoder check on):
   (a) a textured 640x368 clip whose mesh subdivides, 4 frames, quant
   25, complexity 7, through the port's Encoder on "cuda" and on "cpu":
   byte-identical packets; (b) phase 3's 1080p clip and preset with the
   sweep on "cuda", its bytes, Mpix/s and devstats (the refine_sweep
   span) printed as information.  obmc_leaf_cells must have launched in
   both card runs.
5. A line of JSON with each kernel's route, source, launches (lap_frame
   and dct_frame from phase 3, obmc_blend from phase 2c,
   obmc_leaf_cells from phase 4b), error and times; then, as the last
   line, {"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": ...}}.

Without a CUDA device, or without the repository beside it, it exits
nonzero and prints no result.  tests/ imports its case generators
(random_leaves, random_grid, random_refs, textured_clip,
PaddedImage).
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 0
BATCH, REPEATS = 20, 5  # timing: REPEATS batches of BATCH launches
OD_BUFFER_PADDING = 64  # daala_tpu/codec/mc.py


def random_leaves(rng, log_x, log_y, plane_shape, pad, count=None):
    """Leaves of (1 << log_y, 1 << log_x) pixels for a padded (Hp, Wp)
    plane with `pad` pixels of padding: (pos, srcs, mvs, ocs, ss) as
    models/obmc.py build_leaf_lists gives them.  By default one leaf per
    position of the plane's tiling, in random order; random slots, MVs in
    +-256 1/8-pel clipped so that every corner window stays inside the
    plane, and the 16 blend setups (oc, s) in turn."""
    hp, wp = plane_shape
    nx, ny = 1 << log_x, 1 << log_y
    gy, gx = (hp - 2 * pad) // ny, (wp - 2 * pad) // nx
    cells = rng.permutation(gy * gx)[:count]
    n = len(cells)
    pos = np.stack([cells // gx * ny, cells % gx * nx], 1)
    srcs = rng.integers(0, 4, (n, 4))
    mvs = rng.integers(-256, 257, (n, 4, 2))
    for axis, size, span in ((0, hp, ny), (1, wp, nx)):
        org = pad + pos[:, axis:axis + 1] - 2  # window start at MV 0
        mvs[:, :, 1 - axis] = np.clip(mvs[:, :, 1 - axis], -8 * org,
                                      8 * (size - span - 5 - org) + 7)
    k = np.arange(n)
    return (pos.astype(np.int32), srcs.astype(np.int32),
            mvs.astype(np.int32), (k % 4).astype(np.int32),
            (k // 4 % 4).astype(np.int32))


def random_grid(info, rng, levels=3, bframe=False):
    """A random MV mesh with every subdivision level (a copy of
    tests/test_obmc_device.py _random_grid)."""
    from daala_tpu.codec import mc as MC
    nh = info.frame_width >> 3
    nv = info.frame_height >> 3
    g = MC.MVGrid(nh, nv)
    # Level-0 lattice always valid.
    for vy in range(0, nv + 1, 8):
        for vx in range(0, nh + 1, 8):
            g.valid[vy, vx] = 1
    # Random subdivisions: enabling the center vertex of blocks,
    # level by level (children require the parent split).
    for lvl in range(1, levels + 1):
        step = 8 >> lvl
        for vy in range(step, nv + 1 - step, 2 * step):
            for vx in range(step, nh + 1 - step, 2 * step):
                parent_ok = True
                if lvl >= 2:
                    pstep = step * 2
                    cy = (vy // (2 * pstep)) * 2 * pstep + pstep
                    cx = (vx // (2 * pstep)) * 2 * pstep + pstep
                    parent_ok = bool(g.valid[min(cy, nv), min(cx, nh)])
                if parent_ok and rng.random() < 0.5:
                    g.valid[vy, vx] = 1
    vmask = g.valid.astype(bool)
    n = int(vmask.sum())
    g.mv[vmask, 0] = rng.integers(-256, 257, n)
    g.mv[vmask, 1] = rng.integers(-256, 257, n)
    if bframe:
        g.ref[vmask] = rng.choice([1, 1, 2], n)
        g.mv1[vmask, 0] = rng.integers(-256, 257, n)
        g.mv1[vmask, 1] = rng.integers(-256, 257, n)
    else:
        g.ref[vmask] = rng.choice([0, 1], n)
    return g


def textured_clip(w, h, n, seed=5):
    """tests/test_mesweep.py's clip: a moving textured patch over a
    rolling smooth background, with noise; the mesh subdivides on it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 9.0) + 30 * np.cos(yy / 7.0)) \
        .astype(float)
    tex = rng.normal(0, 20, (32, 32))
    frames = []
    for t in range(n):
        y = np.roll(base, (t, 2 * t), (0, 1)).copy()
        oy, ox = 20 + 5 * t, 30 + 7 * t
        y[oy:oy + 32, ox:ox + 32] += tex
        y = (y + rng.normal(0, 3, (h, w))).clip(0, 255).astype(np.uint8)
        cb = (128 + 20 * np.sin((xx[::2, ::2] + t) / 13.0)) \
            .clip(0, 255).astype(np.uint8)
        frames.append([y, cb, cb.copy()])
    return frames


def batch_ms(torch, fn):
    """Median over REPEATS of (CUDA-event time of BATCH calls) / BATCH."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / BATCH)
    return statistics.median(out)


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print("env: python %s torch %s cuda %s device %s"
          % (sys.version.split()[0], torch.__version__, torch.version.cuda,
             torch.cuda.get_device_name(0)))
    from concurrent.futures import ThreadPoolExecutor
    from daala_tpu import native
    from daala_tpu_torch.ops.cuda import dct_kernels, lap_kernels, obmc_kernels
    from daala_tpu_torch.utils import devstats

    def native_lib():
        if native.get_lib() is None:
            raise RuntimeError("the native host engine did not build")

    # g++ and one nvcc per source, all at once; map() re-raises a failure.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(lambda f: f(), (native_lib, lap_kernels.build,
                                    dct_kernels.build, obmc_kernels.build)))
    print("build: native engine, %s.cu, %s.cu and %s.cu ready in %.1f s, in "
          "parallel; nvcc (sm_90a) seconds of the sources built now (none "
          "if build/ held them): %s"
          % (lap_kernels.NAME, dct_kernels.NAME, obmc_kernels.SOURCE,
             time.perf_counter() - t0,
             {k: round(v, 1) for k, v in devstats.BUILDS.items()}))


def record(torch, res, name, label, kern, plain):
    """Time kern and plain (CUDA events) and hold kern's output to
    plain's, bit for bit."""
    from daala_tpu_torch.ops.cuda.obmc_kernels import bits
    err = int((bits(kern()).long() - bits(plain()).long()).abs().max().item())
    k_ms, p_ms = batch_ms(torch, kern), batch_ms(torch, plain)
    r = res.setdefault(name, dict(max_abs_err=0, ms=0.0, plain_ms=0.0,
                                  variants=0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += k_ms
    r["plain_ms"] += p_ms
    r["variants"] += 1
    print("kernel: %-40s max_abs_err %d  kernel %.4f ms  plain %.4f ms"
          % (label, err, k_ms, p_ms))
    if err:
        raise AssertionError("%s differs from its plain version" % label)


def phase_kernels(torch, dev, res):
    """lap_frame and dct_frame against their plain versions."""
    from daala_tpu_torch.ops.cuda import dct_kernels as D, lap_kernels as LK
    g = torch.Generator().manual_seed(SEED)
    for (h, w, sb, sizes) in ((1088, 1920, 64, (4, 8, 16, 32, 64)),
                              (544, 960, 32, (4, 8, 16, 32))):
        x = torch.randint(-(1 << 14), 1 << 14, (h, w), generator=g,
                          dtype=torch.int32).to(dev)
        for fwd in (True, False):
            record(torch, res, LK.NAME, "lap %s %dx%d sb%d" % (
                "fwd" if fwd else "inv", h, w, sb),
                lambda: LK.lap_frame_cuda(x, sb, sb, fwd),
                lambda: LK.lap_frame_plain(x, sb, sb, fwd))
        if not torch.equal(LK.lap_frame_cuda(LK.lap_frame_cuda(
                x, sb, sb, True), sb, sb, False), x):
            raise AssertionError("lap_frame: post(pre(x)) != x")
        for n in sizes:
            for fwd in (True, False):
                record(torch, res, D.NAME, "dct %s n=%d %dx%d" % (
                    "fwd" if fwd else "inv", n, h, w),
                    lambda: D.dct_frame_cuda(x, n, fwd),
                    lambda: D.dct_frame_plain(x, n, fwd))
            if not torch.equal(D.dct_frame_cuda(D.dct_frame_cuda(
                    x, n, True), n, False), x):
                raise AssertionError("dct_frame n=%d: idct(fdct(x)) != x"
                                     % n)
    torch.cuda.synchronize()


def phase_obmc_kernels(torch, dev, res):
    """obmc_blend and obmc_leaf_cells against their plain versions on the
    padded 1080p planes, leaves tiling the plane."""
    from daala_tpu_torch.ops.cuda import obmc_kernels as OK
    rng = np.random.default_rng(SEED)
    for shape, pad, logs in (((1216, 2048), 64, (3, 4, 5, 6)),
                             ((608, 1024), 32, (2, 3, 4, 5))):
        for hi in (False, True):
            p4 = rng.integers(0, 4096 if hi else 256, (4,) + shape)
            p4 = torch.from_numpy(
                p4.astype(np.uint16 if hi else np.uint8)).to(dev)
            for log_n in logs:
                leaves = random_leaves(rng, log_n, log_n, shape, pad)
                scal = torch.from_numpy(OK.leaf_args(
                    *leaves, pad, log_n, log_n, shape)).to(dev)
                record(torch, res, OK.BLEND, "obmc_blend n=%d %s %d-bit, %d"
                       " leaves" % (1 << log_n, shape, 12 if hi else 8,
                                    len(leaves[0])),
                       lambda: OK.obmc_blend_cuda(p4, scal, log_n, log_n),
                       lambda: OK.obmc_blend_plain(p4, scal, log_n, log_n))
                if shape[0] == 1216 and not hi:
                    cur = torch.from_numpy(rng.integers(
                        0, 256, (1080, 1920)).astype(np.uint8)).to(dev)
                    record(torch, res, OK.CELLS, "obmc_leaf_cells n=%d, "
                           "visible 1920x1080, %d leaves"
                           % (1 << log_n, len(leaves[0])),
                           lambda: OK.obmc_leaf_cells_cuda(p4, cur, scal,
                                                           log_n),
                           lambda: OK.obmc_leaf_cells_plain(p4, cur, scal,
                                                            log_n))
    torch.cuda.synchronize()


class PaddedImage:
    """An image of `info`'s frame size whose planes carry the
    OD_BUFFER_PADDING >> xdec margins, filled by fill(shape); the host
    predictor writes through plane_view."""

    def __init__(self, info, fill):
        self.pads = [OD_BUFFER_PADDING >> info.plane_dec[p][0]
                     for p in range(info.nplanes)]
        self.planes = [fill(((info.frame_height >> info.plane_dec[p][1])
                             + 2 * pad,
                             (info.frame_width >> info.plane_dec[p][0])
                             + 2 * pad))
                       for p, pad in enumerate(self.pads)]

    def plane_view(self, pli):
        pad = self.pads[pli]
        return self.planes[pli][pad:-pad, pad:-pad]


def random_refs(info, rng, hi=False):
    """Two reference images of random 8-bit (or 12-bit) samples (the
    draws of tests/test_obmc_device.py _mk_refs)."""
    top, dt = (4096, np.uint16) if hi else (256, np.uint8)
    return [PaddedImage(info, lambda s: rng.integers(0, top, s, dtype=dt))
            for _ in range(2)]


def phase_obmc_frame(torch, dev):
    """predict_frame_plane_device on the card against the host predictor
    on random 1080p meshes; returns the launch counts of the run."""
    from daala_tpu.codec import headers
    from daala_tpu.codec import mc as MC
    from daala_tpu_torch.models import obmc as OB
    from daala_tpu_torch.utils import devstats
    cases = []
    for hi in (False, True):
        rng = np.random.default_rng(SEED + hi)
        info = headers.Info(pic_width=1920, pic_height=1080,
                            bitdepth_mode=2 if hi else 1,
                            full_precision_references=int(hi))
        dt = np.uint16 if hi else np.uint8
        refs = random_refs(info, rng, hi)
        ref_imgi = [0, 0, 1, 0] if hi else [0, 1, 1, 0]
        grid = random_grid(info, rng, bframe=hi)
        dst = PaddedImage(info, lambda s: np.zeros(s, dt))
        t0 = time.perf_counter()
        MC.mc_predict_frame(grid, refs, ref_imgi, info, dst)
        cases.append((hi, info, refs, ref_imgi, grid, dst,
                      time.perf_counter() - t0))
    devstats.reset()
    for hi, info, refs, ref_imgi, grid, dst, host_s in cases:
        t0 = time.perf_counter()
        for pli in range(info.nplanes):
            got = OB.predict_frame_plane_device(grid, refs, ref_imgi, info,
                                                pli, dev)
            if not np.array_equal(got, dst.plane_view(pli)):
                raise AssertionError("device OBMC plane %d (%d-bit) differs "
                                     "from the host's" % (pli,
                                                          12 if hi else 8))
        print("obmc frame: 1920x1080 %s, all planes equal to the host "
              "predictor; port %.3f s (with its mesh walks and fetches), "
              "host %.3f s (wall) [information only]"
              % ("12-bit FPR, B-frame refs" if hi else "8-bit, P-frame refs",
                 time.perf_counter() - t0, host_s))
    torch.cuda.synchronize()
    snap = devstats.snapshot()
    print("devstats: " + json.dumps(snap, sort_keys=True))
    if snap["launches"].get("obmc_blend", 0) <= 0:
        raise AssertionError("obmc_blend never launched")
    return snap["launches"]


def encode(enc, frames):
    enc.keyframe_rate = 256
    enc.enable_encoder_check = True
    t0 = time.perf_counter()
    pk = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
    pk += [bytes(p) for p in enc.flush()]
    return pk, time.perf_counter() - t0


def phase_encoder(torch, dev):
    from daala_tpu.codec import headers
    from daala_tpu.codec.encoder import Encoder as HostEncoder
    from daala_tpu_torch.codec.encoder import Encoder
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import (ENCODER_KW as kw, H,
                                               NFRAMES, W, translation_clip)
    frames = translation_clip()
    port = Encoder(headers.Info(pic_width=W, pic_height=H), device=dev,
                   **kw)
    devstats.reset()
    port_pk, port_s = encode(port, frames)
    torch.cuda.synchronize()
    snap = devstats.snapshot()
    host_pk, host_s = encode(
        HostEncoder(headers.Info(pic_width=W, pic_height=H), **kw), frames)
    mpix = NFRAMES * W * H / 1e6
    print("encode: %d packets, %d bytes; port %.3f Mpix/s (%.2f s), "
          "host %.3f Mpix/s (%.2f s) [information only]"
          % (len(port_pk), sum(map(len, port_pk)), mpix / port_s, port_s,
             mpix / host_s, host_s))
    print("devstats: " + json.dumps(snap, sort_keys=True))
    if port_pk != host_pk:
        bad = [i for i, (a, b) in enumerate(zip(port_pk, host_pk)) if a != b]
        raise AssertionError("port packets differ from the host's (%d vs %d "
                             "packets; first differing: %s)"
                             % (len(port_pk), len(host_pk), bad[:3]))
    print("encode: packets byte-identical to the host encoder's, encoder "
          "check passed")
    for name in ("lap_frame", "dct_frame"):
        if snap["launches"].get(name, 0) <= 0:
            raise AssertionError("%s never launched on the main path" % name)
    return snap["launches"]


def phase_sweep(torch, dev):
    """The colour-sweep encode: (a) card against CPU on a clip whose mesh
    subdivides, (b) the 1080p clip on the card; returns (b)'s launch
    counts."""
    from daala_tpu.codec import headers
    from daala_tpu_torch.codec.encoder import Encoder
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import (ENCODER_KW, H, NFRAMES, W,
                                               translation_clip)
    w, h = 640, 368
    frames = textured_clip(w, h, 4)
    pk = {}
    for d in (dev, "cpu"):
        enc = Encoder(headers.Info(pic_width=w, pic_height=h), device=d,
                      quant=25, complexity=7, mv_refine_mode="sweep")
        devstats.reset()
        pk[str(d)], secs = encode(enc, frames)
        snap = devstats.snapshot()
        print("sweep %dx%d on %s: %d bytes, %.2f s; devstats %s"
              % (w, h, d, sum(map(len, pk[str(d)])), secs,
                 json.dumps(snap, sort_keys=True)))
        if d is dev and snap["launches"].get("obmc_leaf_cells", 0) <= 0:
            raise AssertionError("obmc_leaf_cells never launched (a)")
    if pk[str(dev)] != pk["cpu"]:
        raise AssertionError("sweep packets differ between %s and cpu" % dev)
    print("sweep %dx%d: packets byte-identical between %s and cpu, encoder "
          "check passed" % (w, h, dev))
    enc = Encoder(headers.Info(pic_width=W, pic_height=H), device=dev,
                  mv_refine_mode="sweep", **ENCODER_KW)
    devstats.reset()
    pk, secs = encode(enc, translation_clip())
    torch.cuda.synchronize()
    snap = devstats.snapshot()
    print("sweep %dx%d on %s: %d packets, %d bytes, %.3f Mpix/s (%.2f s), "
          "encoder check passed [information only]"
          % (W, H, dev, len(pk), sum(map(len, pk)), NFRAMES * W * H / 1e6
             / secs, secs))
    print("devstats: " + json.dumps(snap, sort_keys=True))
    if snap["launches"].get("obmc_leaf_cells", 0) <= 0:
        raise AssertionError("obmc_leaf_cells never launched (b)")
    return snap["launches"]


def main():
    if not os.path.isdir(os.path.join(HERE, "daala_tpu_torch")):
        print("chip_smoke.py: daala_tpu_torch/ not found beside this script;"
              " run it from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch sees no CUDA device", file=sys.stderr)
        return 2
    from daala_tpu_torch.device import resolve
    dev = resolve("cuda:0")
    phase_environment(torch)
    kern = {}
    phase_kernels(torch, dev, kern)
    phase_obmc_kernels(torch, dev, kern)
    launches = phase_obmc_frame(torch, dev)
    launches.update({k: v for k, v in phase_encoder(torch, dev).items()
                     if k in ("lap_frame", "dct_frame")})
    launches["obmc_leaf_cells"] = phase_sweep(torch, dev)["obmc_leaf_cells"]
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    pallas = "daala_tpu/ops/pallas/"
    sources = {
        "lap_frame": ("lap_frame.cu", pallas + "lap_kernels.py:78"),
        "dct_frame": ("dct_frame.cu", pallas + "dct_kernels.py:83"),
        "obmc_blend": ("obmc_leaf.cu", pallas + "obmc_kernels.py:191"),
        "obmc_leaf_cells": ("obmc_leaf.cu", pallas + "obmc_kernels.py:208"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "daala_tpu_torch/csrc/" + src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"],
         # Sums over phase 2's and 2b's variants (each shape, size,
         # direction or bit depth once) of the per-call medians.
         "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
         "variants": kern[name]["variants"]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
