#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (daala_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card, the
CUDA toolkit (nvcc) and g++:

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT   # phases 1-2 only, parent vs this

With --ab, PARENT is another checkout (at least its daala_tpu_torch/
csrc/); phase 2 runs with its lap_frame.cu and dct_frame.cu and with
this tree's, in turns (parent, change, change, parent) in one process
on one card, and prints each case's device time per turn.

Phases, each printing its lines; any failure raises and exits nonzero:

1. Environment: the card's name and power limit (nvidia-smi), its
   maximum SM clock, torch and CUDA versions; builds the port's native
   host engine and the three CUDA sources (lap_frame, dct_frame, obmc_leaf;
   into build/, first use only, all nvcc runs at once) and prints each
   build's seconds and ptxas's registers, stack and spills of every
   kernel instantiation.
2. Kernel vs plain PyTorch version, on the card, at the 1080p encoder's
   shapes: lap_frame forward and inverse on a (1088, 1920) luma plane
   (superblock 64) and a (544, 960) chroma plane (superblock 32);
   dct_frame forward and inverse at n = 4..64 on luma and n = 4..32 on
   chroma.  Inputs are int32 in +-2^14 from a seed.  Each kernel must
   equal its plain version bit for bit and inverse(forward(x)) == x.
   Every timed call finds the 50 MB L2 cold (`flush_l2` before it), as
   the main path does: CUDA-event times of calls through the wrapper
   ("kernel"), the kernels' own device time from a torch.profiler trace
   ("device") and the bound (see `bound`).  Beside them, as information,
   a clone() of each plane: what a launch that reads and writes the
   plane's bytes takes on this card.
2b. The OBMC kernels against their plain versions, on the padded 1080p
   luma plane (4, 1216, 2048) and a chroma plane (4, 608, 1024), with
   random leaves tiling the plane (random slots, MVs in +-256 1/8-pel,
   all 16 blend setups (oc, s)): obmc_blend at n = 8..64 on luma and
   n = 4..32 on chroma, 8-bit and 12-bit; obmc_leaf_cells at n = 8..64
   on luma against a 1920x1080 visible area (ragged below); both kernels
   on a sweep-shaped batch (`sweep_leaves`: the 510 n = 64 leaves tiling
   the luma plane, each repeated 8 times with one corner's MV moved by
   up to +-16 1/8-pel, 4,080 rows).  Bit for bit; times as in phase 2.
   Then, checked and not timed: obmc_blend at all 25 (n_x, n_y) pairs
   and both depths; L = 1 and a ragged L at every square size; leaves
   whose windows touch the planes' four edges; the planes of a 177x115
   frame (320 and 160 bytes wide: rows 16-byte but not 64-byte
   aligned); obmc_leaf_cells likewise; and a misaligned plane, which
   the wrappers refuse.
2c. Device OBMC prediction: models/obmc.py predict_frame_plane_device on
   the card against the host predictor (the port's numpy copy of it,
   codec/mc.py mc_predict_frame) on a random 1080p mesh with every subdivision level, all three
   planes, 8-bit P-frame references and 12-bit full-precision B-frame
   references.  Equal planes; obmc_blend must have launched.
3. The encoder end to end: bench.py's 1920x1080 translation clip, 4
   frames, quant 25, complexity 7, the production trial-pass preset,
   encoded with daala_tpu_torch's Encoder on "cuda" (encoder check on:
   every packet is decoded and its reconstruction compared) and on
   "cpu", where the kernels' plain versions run (the CPU tests hold that
   run's packets to daala_tpu's host encoder).  The dering RDO's
   candidates (models/restore.py dering_candidates_device) are filtered
   on the device tier in both runs.  The packets must be byte-identical,
   and both analysis kernels must have launched in the card's run
   (launch counts are reset just before it); prints the
   dering_candidates span of both runs.
3c. The lean tier (bench.py's `device` configuration:
   use_device_analysis=False, use_device_pvq=True) on phase 3's clip
   and preset on "cuda", encoder check on: decoded by the port's
   Decoder, its luma PSNR within 0.3 dB of phase 3's (the host
   search, byte-identical to daala_tpu's host encoder) and its bytes
   within -10% / +5% of phase 3's (on this clip the lean search, like
   JAX's, codes the inter frames about 6% smaller than the host
   search); lap_frame and dct_frame launched; every band_search call
   ran on the card; under half of phase 3's device->host bytes.  Prints
   its devstats, Mpix/s, the search_frame and SAD-field spans, the rows
   the search marked invalid (searched on the host), and, from
   utils/profile.py's torch.profiler trace of a fresh encoder's
   keyframe and first inter frame, the launches, device time and rows
   of every band_search call.
3d. The full-pel SAD fields (models/mefield.py) of one 1080p frame pair
   on the card and on the CPU: equal.
3e. The dering candidates of one 1080p frame (its luma lifted to the
   coefficient domain, 17 x 30 superblocks x 5 gains) at quant 25's
   quantizer, with a random skip map holding all-skip superblocks (a
   corner one and an interior one) and the edge superblocks, on the
   card and on the CPU: equal candidates and directions.  Prints the
   card's call wall (with its upload and fetch).
4. The colour-sweep encode (mv_refine_mode="sweep", encoder check on):
   (a) a textured 640x368 clip whose mesh subdivides, 4 frames, quant
   25, complexity 7, through the port's Encoder on "cuda" and on "cpu":
   byte-identical packets; (b) phase 3's 1080p clip and preset with the
   sweep on "cuda", its bytes, Mpix/s and devstats (the refine_sweep
   span) printed as information.  obmc_leaf_cells must have launched in
   both card runs.
4c. (a)'s clip in the lean tier on "cuda" and on "cpu", each with the
   encoder check on.  At every search_frame call of the card's run the
   CPU searches the same planes too: the two decision tables must agree
   on at least 99% of rows in every frame (the float32 RDO may flip
   near-ties between the devices; the rows that differ are printed).
   Then the same in the lean tier with the sweep (bench.py's
   device+sweep configuration), where obmc_leaf_cells must launch, and,
   as information, phase 3's 1080p clip and preset in it on the card
   (bytes, Mpix/s, devstats).
6. The decoder: phase 3's card packets decoded by the port's Decoder
   with its device back end on the card (Decoder(info, device=...,
   use_device_synthesis=True): the native parse, then
   models/synthesis.py and the batched dering of models/restore.py),
   by its host Decoder, and with the device back end on the CPU.  All
   three give equal planes in every frame; lap_frame and dct_frame must
   have launched in the card's decode (counts reset just before it).
   Prints the decode wall per frame on the card and on the host, the
   synthesize_frame and dering_frame spans, the launches and the
   host<->device bytes.
7a. The uniform-quantizer pipeline (models/analysis.py encode_step)
   over a (4, 1088, 1920) uint8 batch from the seed, bs = 1, quant
   3840, through parallel/mesh.py batch_encode_step on make_mesh() (the
   card) and on the CPU: rec bit for bit, sse and nz (int32, wrapped)
   equal; lap_frame and dct_frame launched 8 times each, forward and
   inverse.  Prints the wall.
7b. parallel/mesh.py encode_clips_batched of bench.py's two 1080p clips
   (translation: phase 3's frames; natural: profile.make_natural_clip
   with seed 3), 4 frames each, phase 3's preset, on make_mesh(), in
   the round-robin schedule and with one thread (and CUDA stream) per
   clip.  Each clip's packets are byte-identical in both schedules and
   to a serial card encode (the translation clip's is phase 3's); the
   natural clip's card packets equal its CPU packets; lap_frame and
   dct_frame launched as often in both schedules.  Prints each
   schedule's wall, Mpix/s (all clips' pixels over the wall) and their
   ratio, as information.
7c. parallel/mesh.py encode_clip_parallel of textured_clip at 320x192,
   32 frames, in 16-frame segments on 2 spawned workers on the card:
   the packets of serial card encodes of each segment, decoded by the
   port's host Decoder (32 frames; luma PSNR printed).
5. A line of JSON with each kernel's route, source, launches (lap_frame
   and dct_frame from phase 3, obmc_blend from phase 2c,
   obmc_leaf_cells from phase 4b) and, beside them, its launches in
   phase 6's decode ("decode_launches") and in phases 7a-7b (both
   schedules; "batch_launches"), error, times and bound; then, as the
   last line, {"ok": true, "device": {"platform": "gpu", "kind": ...,
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
BUILD = os.path.join(HERE, "build", "daala_tpu_torch")

SEED = 0
BATCH, REPEATS = 20, 5  # timing: REPEATS batches of BATCH launches


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
    mvs = clip_mvs(rng.integers(-256, 257, (n, 4, 2)), pos, log_x, log_y,
                   plane_shape, pad)
    k = np.arange(n)
    return (pos.astype(np.int32), srcs.astype(np.int32),
            mvs.astype(np.int32), (k % 4).astype(np.int32),
            (k // 4 % 4).astype(np.int32))


def clip_mvs(mvs, pos, log_x, log_y, plane_shape, pad):
    """mvs (L, 4, 2) [mvx, mvy] clipped so that every corner window of
    the leaves at pos (L, 2) stays inside a padded (Hp, Wp) plane."""
    mvs = np.array(mvs, np.int64)
    for axis, size, span in ((0, plane_shape[0], 1 << log_y),
                             (1, plane_shape[1], 1 << log_x)):
        org = pad + pos[:, axis:axis + 1] - 2  # window start at MV 0
        mvs[:, :, 1 - axis] = np.clip(mvs[:, :, 1 - axis], -8 * org,
                                      8 * (size - span - 5 - org) + 7)
    return mvs


def edge_leaves(rng, log_x, log_y, plane_shape, pad):
    """Leaves at the four corner tiles of the plane whose corner windows
    lie at the extremes: corner k's window touches the right edge when
    k & 1 and the left one otherwise, the bottom edge when k & 2 and the
    top one otherwise (MVs with random subpel phases)."""
    hp, wp = plane_shape
    nx, ny = 1 << log_x, 1 << log_y
    ys, xs = (0, hp - 2 * pad - ny), (0, wp - 2 * pad - nx)
    pos = np.array([(y, x) for y in ys for x in xs], np.int64)
    k = np.arange(4)
    mvs = np.empty((4, 4, 2), np.int64)
    mvs[:, :, 0] = np.where(k & 1, 1 << 20, -(1 << 20))
    mvs[:, :, 1] = np.where(k & 2, 1 << 20, -(1 << 20))
    mvs = clip_mvs(mvs, pos, log_x, log_y, plane_shape, pad)
    # The window is placed by mv >> 3; any subpel phase keeps it there.
    mvs = mvs & ~7 | rng.integers(0, 8, mvs.shape)
    return (pos.astype(np.int32), rng.integers(0, 4, (4, 4)).astype(np.int32),
            mvs.astype(np.int32), k.astype(np.int32),
            rng.integers(0, 4, 4).astype(np.int32))


def sweep_leaves(rng, plane_shape, pad, copies=8, reach=16):
    """A batch shaped like one of refine_sweep's (codec/mvest.py builds
    it with np.repeat): the n = 64 leaves tiling the plane, each
    repeated `copies` times in a row, each copy with one corner's MV
    (in turn) moved by up to +-reach 1/8-pel."""
    leaves = random_leaves(rng, 6, 6, plane_shape, pad)
    pos, srcs, mvs, ocs, ss = (np.repeat(a, copies, 0) for a in leaves)
    rows = np.arange(len(pos))
    mvs = mvs.astype(np.int64)
    mvs[rows, rows % 4] += rng.integers(-reach, reach + 1, (len(pos), 2))
    mvs = clip_mvs(mvs, pos, 6, 6, plane_shape, pad)
    return pos, srcs, mvs.astype(np.int32), ocs, ss


def random_grid(info, rng, levels=3, bframe=False):
    """A random MV mesh with every subdivision level (a copy of
    tests/test_obmc_device.py _random_grid)."""
    from daala_tpu_torch.codec import mc as MC
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
    rolling smooth background, with noise; the mesh subdivides on it.
    The patch wraps around the frame where it would leave it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 9.0) + 30 * np.cos(yy / 7.0)) \
        .astype(float)
    tex = rng.normal(0, 20, (32, 32))
    frames = []
    for t in range(n):
        y = np.roll(base, (t, 2 * t), (0, 1)).copy()
        oy, ox = (20 + 5 * t) % (h - 31), (30 + 7 * t) % (w - 31)
        y[oy:oy + 32, ox:ox + 32] += tex
        y = (y + rng.normal(0, 3, (h, w))).clip(0, 255).astype(np.uint8)
        cb = (128 + 20 * np.sin((xx[::2, ::2] + t) / 13.0)) \
            .clip(0, 255).astype(np.uint8)
        frames.append([y, cb, cb.copy()])
    return frames


_L2_FLUSH = []


def flush_l2(torch):
    """Overwrite the card's 50 MB L2 with a 128 MB fill, so that the next
    call reads its inputs from HBM and its writes evict dirty lines, as
    on the main path, where each call's planes arrive fresh."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 << 20, dtype=torch.uint8,
                                     device="cuda"))
    _L2_FLUSH[0].fill_(1)


def batch_ms(torch, fn):
    """Median over REPEATS of the mean CUDA-event time of BATCH calls,
    each timed alone after flush_l2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPEATS):
        events = []
        for _ in range(BATCH):
            flush_l2(torch)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        out.append(sum(a.elapsed_time(b) for a, b in events) / BATCH)
    return statistics.median(out)


def trace_ms(torch, fn, names, calls=10, tries=3, cats=("kernel",)):
    """Device time per call of fn from a torch.profiler trace of `calls`
    calls, each after flush_l2: for each device event of a category in
    `cats` whose name holds one of `names`, its mean duration times its
    launches per call.  Returns (ms, events seen, calls); a trace that
    shows none of them is taken again, up to `tries` times, and then ms
    is None."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, "kernel_trace.json")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush_l2(torch)
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        durs = {}
        for e in events:
            name = e.get("name", "")
            if e.get("cat") in cats and any(n in name for n in names):
                durs.setdefault(name, []).append(e["dur"])
        if durs:
            ms = sum(statistics.mean(d) / 1e3 * max(1, round(len(d) / calls))
                     for d in durs.values())
            return ms, sum(map(len, durs.values())), calls
    return None, 0, calls


# The bound of a call: the larger of its bytes over the card's memory
# rate and its int32 operations over 132 SMs x 64 int32 lanes x the
# maximum SM clock that nvidia-smi reads (phase 1 sets "ops_per_s").
# Input bytes count once and output bytes once; operations are counted
# from the code (the functions below).
RATES = {"bytes_per_s": 3.35e12, "ops_per_s": None}
SM_INT32_LANES = 132 * 64


def bound(nbytes, ops):
    """(ms, "bytes" or "operations") of a call that moves nbytes and
    does ops int32 operations."""
    b_ms = nbytes / RATES["bytes_per_s"] * 1e3
    o_ms = ops / RATES["ops_per_s"] * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def lifting_ops(name):
    """Operations of one lifting network of daala_tpu_torch/ops/
    _lifting.py: each operator once, each dct_rshift or c_div call as 4
    (its add, sign, mask and shift)."""
    import ast
    with open(os.path.join(HERE, "daala_tpu_torch", "ops",
                           "_lifting.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return sum(1 if isinstance(n, (ast.BinOp, ast.UnaryOp)) else 4
               for n in ast.walk(fn)
               if isinstance(n, (ast.BinOp, ast.UnaryOp, ast.Call)))


def dct_work(h, w, n, forward):
    """(bytes, ops) of dct_frame on an (h, w) int32 plane: the plane read
    and written once; 2n one-dimensional networks per n x n block."""
    net = lifting_ops(("fdct%d" if forward else "idct%d") % n)
    return 8 * h * w, h * w // (n * n) * 2 * n * net


def lap_work(h, w, sb, forward):
    """(bytes, ops) of lap_frame on an (h, w) int32 plane: the plane read
    and written once; one 4-point network per column across every inner
    superblock row edge and per row across every column edge."""
    net = lifting_ops("pre_filter4" if forward else "post_filter4")
    return 8 * h * w, ((h // sb - 1) * w + (w // sb - 1) * h) * net


def covered(shape, starts, sizes):
    """Pixels of an array of `shape` (leading dims, h, w) covered by the
    union of the boxes [y, y + hy) x [x, x + wx), clipped to the array,
    at starts (N, ndim)."""
    cov = np.zeros(tuple(shape[:-2]) + (shape[-2] + 1, shape[-1] + 1),
                   np.int32)
    lead = tuple(starts[:, i] for i in range(len(shape) - 2))
    y0, x0 = starts[:, -2], starts[:, -1]
    y1 = np.minimum(y0 + sizes[0], shape[-2])
    x1 = np.minimum(x0 + sizes[1], shape[-1])
    keep = (y0 < shape[-2]) & (x0 < shape[-1])
    for y, x, v in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        np.add.at(cov, tuple(a[keep] for a in lead + (y, x)), v)
    return int((cov.cumsum(-2).cumsum(-1)[..., :-1, :-1] > 0).sum())


def obmc_work(scal, log_x, log_y, plane_shape, itemsize, cur_shape=None):
    """(bytes, ops) of obmc_blend (cur_shape None) or obmc_leaf_cells on
    the leaves packed in scal (numpy (L, 16)).

    Bytes: the plane pixels that the corner windows cover (each once),
    the leaf arguments, and the blocks written, or for the cells the
    visible current pixels the leaves cover and the cell sums written.

    Operations are int32-lane instructions of the least sequence for
    the types: a multiply-add of an 8-bit sample by an 8-bit tap counts
    1/4 (dp4a does 4), of a 16-bit value by an 8-bit tap 1/2 (dp2a), of
    two 32-bit values 1.  Per leaf and corner: every horizontal sample
    ((ny + 5) x nx of them) 6 multiply-adds and the offset, plus the
    int16 wrap at 8 bits (3.5; 4 at 12 bits); every pixel 6 vertical
    multiply-adds of the 16-bit (8-bit input) or 32-bit (12-bit)
    samples, the rounding, the shift and 2 clips (7; 10).  Then per
    pixel 9 for the blend (4 weight steps and products, the shift), and
    for the cells 3 more on each visible pixel (difference, magnitude,
    sum)."""
    L = scal.shape[0]
    nx, ny = 1 << log_x, 1 << log_y
    wins = np.stack([scal[:, 0:4], scal[:, 4:8], scal[:, 8:12]],
                    -1).reshape(-1, 3)
    nbytes = covered((4,) + tuple(plane_shape), wins,
                     (ny + 5, nx + 5)) * itemsize + 64 * L
    h_ops, v_ops = (3.5, 7) if itemsize == 1 else (4, 10)
    ops = int(L * (4 * (h_ops * (ny + 5) * nx + v_ops * nx * ny)
                   + 9 * nx * ny))
    if cur_shape is None:
        return nbytes + L * nx * ny * itemsize, ops
    vh, vw = cur_shape
    vis = (np.clip(vh - scal[:, 13], 0, ny).astype(np.int64)
           * np.clip(vw - scal[:, 14], 0, nx))
    nbytes += covered(cur_shape, scal[:, 13:15], (ny, nx))
    return nbytes + L * (nx >> 3) * (ny >> 3) * 4, ops + 3 * int(vis.sum())


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    RATES["ops_per_s"] = SM_INT32_LANES * mhz * 1e6
    print("env: python %s torch %s cuda %s device %s; max SM clock %.0f MHz:"
          " bound rates %.4g int32 op/s, %.4g B/s"
          % (sys.version.split()[0], torch.__version__, torch.version.cuda,
             torch.cuda.get_device_name(0), mhz, RATES["ops_per_s"],
             RATES["bytes_per_s"]))
    from concurrent.futures import ThreadPoolExecutor
    from daala_tpu_torch import native
    from daala_tpu_torch.ops.cuda import (_build, dct_kernels, lap_kernels,
                                          obmc_kernels)
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
    for src, text in sorted(_build.PTXAS.items()):
        for fn, regs, stack, st, ld in _build.ptxas_report(text):
            print("ptxas: %s: %d registers, %d bytes stack, spills %d/%d "
                  "bytes (store/load): %s" % (src, regs, stack, st, ld, fn))
    for hi, cells, pairs in (
            (False, True, [(n, n) for n in range(3, 7)]),
            (False, False, [(x, y) for x in range(2, 7) for y in range(2, 7)]),
            (True, False, [(x, y) for x in range(2, 7) for y in range(2, 7)])):
        print("plan: %s: %s" % (
            "obmc_leaf_cells" if cells else "obmc_blend %d-bit"
            % (12 if hi else 8), "; ".join(
                "%dx%d %s" % (1 << x, 1 << y, " ".join(
                    str(v) for v in obmc_kernels.plan_info(x, y, hi,
                                                           cells).values()))
                for x, y in pairs)))
    print("plan: (nx x ny: threads, leaves per block, copy bytes, shared "
          "bytes, blocks per SM, rows per thread)")


CASES = []  # (label, kernel ms, device ms, plain ms, bound ms) of record
TIME_PLAIN = True  # False: record checks plain but does not time it


def record(torch, res, name, label, kern, plain, work, trace_names):
    """Time kern (CUDA events through the wrapper, and its kernels'
    device time in a profiler trace) and plain (CUDA events), each call
    with a cold L2, hold kern's output to plain's bit for bit, and add
    the bound of `work` (bytes, ops)."""
    from daala_tpu_torch.ops.cuda.obmc_kernels import bits
    err = int((bits(kern()).long() - bits(plain()).long()).abs().max().item())
    k_ms = batch_ms(torch, kern)
    p_ms = batch_ms(torch, plain) if TIME_PLAIN else float("nan")
    d_ms, seen, calls = trace_ms(torch, kern, trace_names)
    b_ms, by = bound(*work)
    r = res.setdefault(name, dict(max_abs_err=0, ms=0.0, plain_ms=0.0,
                                  device_ms=0.0, bound_ms=0.0,
                                  bound_by={}, variants=0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += k_ms
    r["plain_ms"] += p_ms
    r["device_ms"] = (None if d_ms is None or r["device_ms"] is None
                      else r["device_ms"] + d_ms)
    r["bound_ms"] += b_ms
    r["bound_by"][by] = r["bound_by"].get(by, 0.0) + b_ms
    r["variants"] += 1
    CASES.append((label, k_ms, d_ms, p_ms, b_ms))
    print("kernel: %-44s max_abs_err %d  kernel %.4f ms  device %s ms "
          "(%d events, %d calls)  plain %.4f ms  bound %.4f ms (%s; %d B, "
          "%d ops)"
          % (label, err, k_ms, "%.4f" % d_ms if d_ms is not None else "none",
             seen, calls, p_ms, b_ms, by, work[0], work[1]))
    if err:
        raise AssertionError("%s differs from its plain version" % label)


def clone_floor(torch, x):
    """A same-size clone() of the plane x, each call with a cold L2: its
    CUDA-event time and its device time in a trace.  Information only: it
    computes another function, but tells what a launch that reads and
    writes these bytes costs on this card."""
    c_ms = batch_ms(torch, x.clone)
    d_ms, seen, calls = trace_ms(torch, x.clone, ("Memcpy DtoD", "copy"),
                                 cats=("kernel", "gpu_memcpy"))
    print("clone: %dx%d int32  %.4f ms  device %s ms (%d events, %d calls) "
          "[information only]" % (tuple(x.shape) + (
              c_ms, "%.4f" % d_ms if d_ms is not None else "none", seen,
              calls)))
    CASES.append(("clone %dx%d" % tuple(x.shape), c_ms, d_ms, float("nan"),
                  float("nan")))


def phase_kernels(torch, dev, res, names=None):
    """lap_frame and dct_frame against their plain versions, and the
    clone() floor of each plane.  names: {source: the trace names of its
    kernels}, by default each wrapper module's KERNELS."""
    from daala_tpu_torch.ops.cuda import dct_kernels as D, lap_kernels as LK
    names = names or {LK.NAME: LK.KERNELS, D.NAME: D.KERNELS}
    g = torch.Generator().manual_seed(SEED)
    for (h, w, sb, sizes) in ((1088, 1920, 64, (4, 8, 16, 32, 64)),
                              (544, 960, 32, (4, 8, 16, 32))):
        x = torch.randint(-(1 << 14), 1 << 14, (h, w), generator=g,
                          dtype=torch.int32).to(dev)
        clone_floor(torch, x)
        for fwd in (True, False):
            record(torch, res, LK.NAME, "lap %s %dx%d sb%d" % (
                "fwd" if fwd else "inv", h, w, sb),
                lambda: LK.lap_frame_cuda(x, sb, sb, fwd),
                lambda: LK.lap_frame_plain(x, sb, sb, fwd),
                lap_work(h, w, sb, fwd), names[LK.NAME])
        if not torch.equal(LK.lap_frame_cuda(LK.lap_frame_cuda(
                x, sb, sb, True), sb, sb, False), x):
            raise AssertionError("lap_frame: post(pre(x)) != x")
        for n in sizes:
            for fwd in (True, False):
                record(torch, res, D.NAME, "dct %s n=%d %dx%d" % (
                    "fwd" if fwd else "inv", n, h, w),
                    lambda: D.dct_frame_cuda(x, n, fwd),
                    lambda: D.dct_frame_plain(x, n, fwd),
                    dct_work(h, w, n, fwd), names[D.NAME])
            if not torch.equal(D.dct_frame_cuda(D.dct_frame_cuda(
                    x, n, True), n, False), x):
                raise AssertionError("dct_frame n=%d: idct(fdct(x)) != x"
                                     % n)
    torch.cuda.synchronize()


def global_names(path):
    """The __global__ functions of a CUDA source."""
    import re
    with open(path) as f:
        return tuple(sorted(set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            f.read()))))


def build_other(root, tag):
    """Build lap_frame.cu and dct_frame.cu of another checkout at `root`
    (the same nvcc flags, in parallel) and load them; returns {source:
    (library, its kernels' names)}."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from daala_tpu_torch.ops.cuda import _build, dct_kernels, lap_kernels
    csrc = os.path.join(os.path.abspath(root), "daala_tpu_torch", "csrc")
    os.makedirs(BUILD, exist_ok=True)

    def one(mod):
        src = os.path.join(csrc, mod.NAME + ".cu")
        so = os.path.join(BUILD, "%s-%s.so" % (tag, mod.NAME))
        r = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS
                           + ["-I", csrc, "-o", so, src],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (src, r.stderr))
        for fn, regs, stack, st, ld in _build.ptxas_report(r.stderr):
            print("ptxas (%s): %s: %d registers, %d bytes stack, spills "
                  "%d/%d bytes (store/load): %s"
                  % (tag, mod.NAME, regs, stack, st, ld, fn))
        lib = ctypes.CDLL(so)
        fn = getattr(lib, mod.NAME)
        fn.argtypes, fn.restype = mod._ARGTYPES, ctypes.c_int
        return mod.NAME, (lib, global_names(src))

    with ThreadPoolExecutor(2) as ex:
        return dict(ex.map(one, (lap_kernels, dct_kernels)))


def phase_ab(torch, dev, parent):
    """Phase 2 with the lap_frame.cu and dct_frame.cu of the checkout at
    `parent` and of this tree, in turns (parent, change, change, parent)
    in one process on one card, every call with a cold L2; prints each
    case's device time per turn and, as a line of JSON, all of them."""
    global TIME_PLAIN
    from daala_tpu_torch.ops.cuda import _build
    other = build_other(parent, "parent")
    mine = {name: (_build.load(name, {}), tuple(
        global_names(os.path.join(_build.CSRC, name + ".cu"))))
        for name in other}
    TIME_PLAIN = False
    turns = []
    for tag, libs in (("parent", other), ("change", mine),
                      ("change", mine), ("parent", other)):
        for name, (lib, _) in libs.items():
            _build._LIBS[name] = lib
        del CASES[:]
        print("ab: turn %d, %s" % (len(turns) + 1, tag))
        phase_kernels(torch, dev, {},
                      {name: kn for name, (_, kn) in libs.items()})
        turns.append((tag, list(CASES)))
    for name, (lib, _) in mine.items():
        _build._LIBS[name] = lib
    rows = []
    for i, case in enumerate(turns[0][1]):
        dev_us = [t[1][i][2] * 1e3 if t[1][i][2] is not None else None
                  for t in turns]
        ms = [t[1][i][1] for t in turns]
        bound_us = None if case[4] != case[4] else case[4] * 1e3  # NaN
        rows.append({"case": case[0], "bound_us": bound_us,
                     "device_us": dev_us, "ms": ms})
        print("ab: %-28s bound %s us  device us parent %s / change %s  "
              "wrapper ms %s" % (
                  case[0], "%7.3f" % bound_us if bound_us else "   none",
                  ", ".join("%.3f" % v if v is not None else "none"
                            for v in (dev_us[0], dev_us[3])),
                  ", ".join("%.3f" % v if v is not None else "none"
                            for v in (dev_us[1], dev_us[2])),
                  " ".join("%.4f" % v for v in ms)))
    print("ab: " + json.dumps({"turns": [t[0] for t in turns],
                               "cases": rows}))


LUMA, CHROMA = (1216, 2048), (608, 1024)  # the padded 1080p planes
SMALL = ((256, 320), (128, 160))  # the padded planes of a 177x115 frame


def _planes(torch, dev, rng, shape, hi):
    p4 = rng.integers(0, 4096 if hi else 256, (4,) + shape)
    return torch.from_numpy(p4.astype(np.uint16 if hi else np.uint8)).to(dev)


def phase_obmc_kernels(torch, dev, res):
    """obmc_blend and obmc_leaf_cells against their plain versions on the
    padded 1080p planes (leaves tiling the plane, and a sweep-shaped
    batch), timed; then the checked cases."""
    from daala_tpu_torch.ops.cuda import obmc_kernels as OK
    rng = np.random.default_rng(SEED)
    cur = torch.from_numpy(rng.integers(0, 256, (1080, 1920))
                           .astype(np.uint8)).to(dev)

    def timed(p4, leaves, log_x, log_y, pad, label, cells):
        shape = tuple(p4.shape[1:])
        scal_np = OK.leaf_args(*leaves, pad, log_x, log_y, shape)
        scal = torch.from_numpy(scal_np).to(dev)
        hi = p4.dtype == torch.uint16
        record(torch, res, OK.BLEND, "obmc_blend %s %d-bit, %d leaves"
               % (label, 12 if hi else 8, len(scal_np)),
               lambda: OK.obmc_blend_cuda(p4, scal, log_x, log_y),
               lambda: OK.obmc_blend_plain(p4, scal, log_x, log_y),
               obmc_work(scal_np, log_x, log_y, shape, 2 if hi else 1),
               (OK.KERNELS[0],))
        if cells:
            record(torch, res, OK.CELLS, "obmc_leaf_cells %s, visible "
                   "1920x1080, %d leaves" % (label, len(scal_np)),
                   lambda: OK.obmc_leaf_cells_cuda(p4, cur, scal, log_x),
                   lambda: OK.obmc_leaf_cells_plain(p4, cur, scal, log_x),
                   obmc_work(scal_np, log_x, log_y, shape, 1,
                             tuple(cur.shape)),
                   (OK.KERNELS[1],))

    for shape, pad, logs in ((LUMA, 64, (3, 4, 5, 6)),
                             (CHROMA, 32, (2, 3, 4, 5))):
        for hi in (False, True):
            p4 = _planes(torch, dev, rng, shape, hi)
            for log_n in logs:
                timed(p4, random_leaves(rng, log_n, log_n, shape, pad),
                      log_n, log_n, pad, "n=%d %s" % (1 << log_n, shape),
                      shape == LUMA and not hi)
    p4 = _planes(torch, dev, rng, LUMA, False)
    timed(p4, sweep_leaves(rng, LUMA, 64), 6, 6, 64,
          "n=64 sweep-shaped batch", True)
    torch.cuda.synchronize()
    print("obmc checked cases: %d, every one equal to the plain version"
          % obmc_checked_cases(torch, dev, rng))


def obmc_checked_cases(torch, dev, rng):
    """The untimed OBMC cases of phase 2b (see the module docstring);
    returns how many were checked.  Raises on the first difference."""
    from daala_tpu_torch.ops.cuda import obmc_kernels as OK
    count = 0

    def check(p4, leaves, pad, log_x, log_y, cur=None, label=""):
        nonlocal count
        shape = tuple(p4.shape[1:])
        scal = torch.from_numpy(OK.leaf_args(*leaves, pad, log_x, log_y,
                                             shape)).to(dev)
        if cur is None:
            got = OK.bits(OK.obmc_blend_cuda(p4, scal, log_x, log_y))
            want = OK.bits(OK.obmc_blend_plain(p4, scal, log_x, log_y))
        else:
            got = OK.obmc_leaf_cells_cuda(p4, cur, scal, log_x)
            want = OK.obmc_leaf_cells_plain(p4, cur, scal, log_x)
        if not torch.equal(got, want):
            bad = (got != want).nonzero()
            raise AssertionError(
                "%s %dx%d (%d leaves, %s) differs from its plain version at "
                "%d values, first at %s (leaf arguments %s)" % (
                    "obmc_blend" if cur is None else "obmc_leaf_cells",
                    1 << log_x, 1 << log_y, scal.shape[0], label, len(bad),
                    bad[0].tolist(), scal[bad[0, 0]].tolist()))
        count += 1

    for hi in (False, True):
        for shape, pad in ((LUMA, 64),) + tuple(zip(SMALL, (64, 32))):
            p4 = _planes(torch, dev, rng, shape, hi)
            for log_x in range(2, 7):
                for log_y in range(2, 7):
                    if shape == LUMA:
                        check(p4, random_leaves(rng, log_x, log_y, shape,
                                                pad, 600), pad, log_x, log_y,
                              label="random")
                    check(p4, edge_leaves(rng, log_x, log_y, shape, pad),
                          pad, log_x, log_y, label="edges %s" % (shape,))
                    if shape != LUMA and log_x == log_y:
                        check(p4, random_leaves(rng, log_x, log_y, shape,
                                                pad), pad, log_x, log_y,
                              label="tiling %s" % (shape,))
                    if shape == LUMA and log_x == log_y:
                        for n in (1, 37):
                            check(p4, random_leaves(rng, log_x, log_y, shape,
                                                    pad, n), pad, log_x,
                                  log_y, label="L=%d" % n)
    # obmc_leaf_cells: L = 1, a ragged L, the edges, the small frame.
    for shape, cur_shape in ((LUMA, (1080, 1900)), (SMALL[0], (115, 177))):
        p4 = _planes(torch, dev, rng, shape, False)
        cur = torch.from_numpy(rng.integers(0, 256, cur_shape)
                               .astype(np.uint8)).to(dev)
        for log_n in range(3, 7):
            cases = [random_leaves(rng, log_n, log_n, shape, 64),
                     edge_leaves(rng, log_n, log_n, shape, 64)]
            if shape == LUMA:
                cases += [random_leaves(rng, log_n, log_n, shape, 64, n)
                          for n in (1, 37)]
            for leaves in cases:
                check(p4, leaves, 64, log_n, log_n, cur,
                      label="cells %s, %d leaves" % (shape, len(leaves[0])))
    # A plane whose rows or base are not 16-byte aligned is refused.
    for shape, offset in (((4, 64, 100), 0), ((4, 64, 128), 1)):
        flat = torch.zeros(int(np.prod(shape)) + offset, dtype=torch.uint8,
                           device=dev)
        bad = flat[offset:].view(shape)
        scal = torch.from_numpy(OK.leaf_args(*random_leaves(
            rng, 3, 3, shape[1:], 16, 4), 16, 3, 3, shape[1:])).to(dev)
        try:
            OK.obmc_blend_cuda(bad, scal, 3, 3)
        except ValueError:
            count += 1
        else:
            raise AssertionError("obmc_blend took a misaligned plane %s, "
                                 "offset %d" % (shape, offset))
    torch.cuda.synchronize()
    return count


class PaddedImage:
    """An image of `info`'s frame size whose planes carry the
    OD_BUFFER_PADDING >> xdec margins, filled by fill(shape); the host
    predictor writes through plane_view."""

    def __init__(self, info, fill):
        from daala_tpu_torch.codec.mc import OD_BUFFER_PADDING
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
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec import mc as MC
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


def luma_psnr(frames, packets, info):
    """Mean over frames of the luma PSNR of the port's Decoder's output
    of `packets` against `frames`."""
    from daala_tpu_torch.codec.decoder import Decoder
    dec = Decoder(info, use_device_synthesis=False)
    outs = [o for p in packets for o in dec.decode_packet(p)]
    if len(outs) != len(frames):
        raise AssertionError("decoded %d frames of %d" % (len(outs),
                                                         len(frames)))
    out = []
    for fr, o in zip(frames, outs):
        err = fr[0].astype(np.float64) - np.asarray(o[0], np.float64)
        out.append(10 * np.log10(255.0 ** 2 / max(np.mean(err ** 2),
                                                   1e-12)))
    return float(np.mean(out))


def phase_encoder(torch, dev):
    """Phase 3; returns its card run's launches, packets, device->host
    bytes and luma PSNR."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.encoder import Encoder
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import (ENCODER_KW as kw, H,
                                               NFRAMES, W, translation_clip)
    frames = translation_clip()
    card = Encoder(headers.Info(pic_width=W, pic_height=H), device=dev,
                   **kw)
    devstats.reset()
    card_pk, card_s = encode(card, frames)
    torch.cuda.synchronize()
    snap = devstats.snapshot()
    devstats.reset()
    cpu_pk, cpu_s = encode(
        Encoder(headers.Info(pic_width=W, pic_height=H), device="cpu", **kw),
        frames)
    cpu_spans = devstats.snapshot()["spans_s"]
    mpix = NFRAMES * W * H / 1e6
    print("encode: %d packets, %d bytes; %s %.3f Mpix/s (%.2f s), "
          "cpu %.3f Mpix/s (%.2f s) [information only]"
          % (len(card_pk), sum(map(len, card_pk)), dev, mpix / card_s,
             card_s, mpix / cpu_s, cpu_s))
    print("devstats: " + json.dumps(snap, sort_keys=True))
    if card_pk != cpu_pk:
        bad = [i for i, (a, b) in enumerate(zip(card_pk, cpu_pk)) if a != b]
        raise AssertionError("card packets differ from the cpu run's (%d vs "
                             "%d packets; first differing: %s)"
                             % (len(card_pk), len(cpu_pk), bad[:3]))
    print("encode: packets byte-identical between %s and cpu, encoder "
          "check passed" % dev)
    if "dering_candidates" not in snap["spans_s"]:
        raise AssertionError("the dering candidates did not run on %s" % dev)
    print("encode: dering_candidates span %s %.4f s, cpu %.4f s (%d frames)"
          % (dev, snap["spans_s"]["dering_candidates"],
             cpu_spans["dering_candidates"], NFRAMES))
    for name in ("lap_frame", "dct_frame"):
        if snap["launches"].get(name, 0) <= 0:
            raise AssertionError("%s never launched on the main path" % name)
    psnr = luma_psnr(frames, card_pk, headers.Info(pic_width=W, pic_height=H))
    print("encode: luma PSNR %.4f dB (port Decoder)" % psnr)
    return dict(launches=snap["launches"], packets=card_pk,
                d2h_bytes=snap["d2h_bytes"], psnr=psnr)


def _watch_band_search(calls):
    """Replace pvqsearch.band_search by a wrapper that appends (n, rows,
    input device, output device) of every call to `calls`; returns the
    function that restores it."""
    from daala_tpu_torch.models import pvqsearch as PS
    real = PS.band_search

    def watched(*args, **kw):
        out = real(*args, **kw)
        calls.append((args[9], int(args[2].shape[0]), args[0].device.type,
                      out[0].device.type))
        return out
    PS.band_search = watched

    def restore():
        PS.band_search = real
    return restore


def lean_encoder(info, device, **kw):
    from daala_tpu_torch.codec.encoder import Encoder
    return Encoder(info, device=device, use_device_analysis=False,
                   use_device_pvq=True, **kw)


def phase_lean(torch, dev, ref):
    """Phase 3c against phase 3's results `ref`; returns the launches per
    band_search call of the traced frames."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import (ENCODER_KW as kw, H,
                                               NFRAMES, W, traced,
                                               translation_clip)
    frames = translation_clip()
    info = headers.Info(pic_width=W, pic_height=H)
    calls = []
    restore = _watch_band_search(calls)
    try:
        enc = lean_encoder(info, dev, **kw)
        devstats.reset()
        pk, secs = encode(enc, frames)
        torch.cuda.synchronize()
        snap = devstats.snapshot()
        if {(c[2], c[3]) for c in calls} != {(dev.type, dev.type)}:
            raise AssertionError("band_search ran off the card: %s"
                                 % sorted({c[2:] for c in calls}))
        nbytes = sum(map(len, pk))
        ref_bytes = sum(map(len, ref["packets"]))
        psnr = luma_psnr(frames, pk, info)
        print("lean: %d packets, %d bytes (analysis tier %d, %+.3f%%); luma "
              "PSNR %.4f dB (analysis tier %.4f, %+.4f dB); %.3f Mpix/s "
              "(%.2f s); encoder check passed, decoded by the port's "
              "Decoder" % (len(pk), nbytes, ref_bytes,
                           100.0 * (nbytes - ref_bytes) / ref_bytes, psnr,
                           ref["psnr"], psnr - ref["psnr"],
                           NFRAMES * W * H / 1e6 / secs, secs))
        print("lean: spans %s; band_search calls %d, rows searched %d, rows "
              "marked invalid (searched on the host) %d; d2h %d bytes "
              "(analysis tier %d, %.4f of it)" % (
                  {k: round(v, 4) for k, v in snap["spans_s"].items()},
                  len(calls), snap["counts"].get("pvq_rows", 0),
                  snap["counts"].get("pvq_invalid_rows", 0),
                  snap["d2h_bytes"], ref["d2h_bytes"],
                  snap["d2h_bytes"] / ref["d2h_bytes"]))
        print("devstats: " + json.dumps(snap, sort_keys=True))
        # The lean search (as JAX's, whose tables it equals on the same
        # planes) codes this clip's inter frames about 6% smaller than
        # the host search, so the lower bound is -10%.
        if not 0.90 * ref_bytes < nbytes < 1.05 * ref_bytes:
            raise AssertionError("lean bytes %d not within -10%% / +5%% of "
                                 "%d" % (nbytes, ref_bytes))
        if abs(psnr - ref["psnr"]) >= 0.3:
            raise AssertionError("lean PSNR %.4f not within 0.3 dB of %.4f"
                                 % (psnr, ref["psnr"]))
        for name in ("lap_frame", "dct_frame"):
            if snap["launches"].get(name, 0) <= 0:
                raise AssertionError("%s never launched in the lean tier"
                                     % name)
        if not snap["d2h_bytes"] < 0.5 * ref["d2h_bytes"]:
            raise AssertionError("lean d2h %d bytes not under half of %d"
                                 % (snap["d2h_bytes"], ref["d2h_bytes"]))
        # Launches per band_search call, from utils/profile.py's trace
        # of a fresh encoder's keyframe and first inter frame (it prints
        # each call's launches and device time); here each call gets its
        # band length and rows.
        del calls[:]
        os.makedirs(BUILD, exist_ok=True)
        res = traced(frames, dev, BUILD, False, lean=True)
        work = [dict(frame=label, **w) for label in ("keyframe", "inter")
                for w in res[label]["band_search"]]
        if len(work) != len(calls):
            print("lean trace: %d band_search ranges for %d calls; "
                  "launches per call not read" % (len(work), len(calls)))
            work = []
        per_call = []
        for (n, rows, _, _), w in zip(calls, work):
            per_call.append(dict(n=n, rows=rows, **w))
            print("lean trace %s: band_search n=%d, %d rows: %d launches, "
                  "device %.3f ms, host wall %.3f ms"
                  % (w["frame"], n, rows, w["launches"], w["device_ms"],
                     w["wall_ms"]))
    finally:
        restore()
    return per_call


def phase_fields(torch, dev):
    """Phase 3d: the SAD fields of one 1080p frame pair, card and CPU."""
    from daala_tpu_torch.codec.mc import OD_BUFFER_PADDING as pad
    from daala_tpu_torch.models import mefield as MF
    from daala_tpu_torch.utils.profile import H, W, translation_clip
    frames = translation_clip(nframes=2)
    cur = frames[1][0]
    ref = np.pad(frames[0][0], pad, mode="edge")
    nv, nh = ((H + 31) // 32 * 32) >> 3, ((W + 31) // 32 * 32) >> 3
    out = {}
    for d in (dev, "cpu"):
        MF.fullpel_sad_fields(cur[:64, :64], [ref[:64 + 2 * pad,
                                                  :64 + 2 * pad]],
                              pad, (64, 64), 8, 8, device=d)  # warm-up
        t0 = time.perf_counter()
        out[str(d)] = MF.fullpel_sad_fields(cur, [ref], pad, (H, W), nv, nh,
                                            device=d)[0]
        out[str(d) + "_s"] = time.perf_counter() - t0
    if not np.array_equal(out[str(dev)], out["cpu"]):
        raise AssertionError("SAD fields differ between %s and cpu" % dev)
    print("fields: 1920x1080, r=16, %s fields equal between %s (%.4f s, "
          "with the upload and fetch) and cpu (%.4f s)"
          % (out["cpu"].shape, dev, out[str(dev) + "_s"], out["cpu_s"]))


def phase_dering_candidates(torch, dev):
    """Phase 3e: one 1080p frame's dering candidates, card and CPU."""
    from daala_tpu_torch.codec import quantizer as Q
    from daala_tpu_torch.models import restore as R
    from daala_tpu_torch.utils.profile import H, W, translation_clip
    rng = np.random.default_rng(SEED)
    y = translation_clip(nframes=1)[0][0]
    nvdr, nhdr = (H + 63) // 64, W // 64
    luma = np.pad((y.astype(np.int16) - 128) << 4,
                  ((0, nvdr * 64 - H), (0, 0)), mode="edge")
    bskip = (rng.random((nvdr * 16, nhdr * 16)) < 0.5).astype(np.uint8)
    bskip[:17, :17] = 1  # the corner superblock and its window
    bskip[79:97, 159:177] = 1  # superblock (5, 10) and its window
    q = Q.quality_to_quantizer((25 << 4) - 8)
    args = (luma, bskip, q, nvdr, nhdr)
    R.dering_candidates_device(*args, device=dev)  # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        cands, dirs = R.dering_candidates_device(*args, device=dev)
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    want_c, want_d = R.dering_candidates_device(*args, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not (np.array_equal(cands, want_c) and np.array_equal(dirs, want_d)):
        raise AssertionError("dering candidates differ between %s and cpu"
                             % dev)
    for sb, (y0, x0) in ((0, (0, 0)), (5 * nhdr + 10, (320, 640))):
        if not (cands[sb] == luma[y0:y0 + 64, x0:x0 + 64]).all():
            raise AssertionError("all-skip superblock %d was filtered" % sb)
    print("dering candidates: 1920x1080 luma, quantizer %d, %s candidates "
          "equal between %s and cpu; %s call wall %.4f s (median of 3, with "
          "the upload and fetch), cpu %.4f s"
          % (q, cands.shape, dev, dev, statistics.median(walls), cpu_s))


def phase_sweep(torch, dev):
    """The colour-sweep encode: (a) card against CPU on a clip whose mesh
    subdivides, (b) the 1080p clip on the card; returns (b)'s launch
    counts."""
    from daala_tpu_torch.codec import headers
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


def phase_decoder(torch, dev, ref):
    """Phase 6 on phase 3's card packets; returns the card decode's launch
    counts."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.decoder import Decoder
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import H, W
    info = headers.Info(pic_width=W, pic_height=H)

    def decode(dec):
        outs, walls = [], []
        for p in ref["packets"]:
            t0 = time.perf_counter()
            outs.extend(dec.decode_packet(p))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return outs, walls

    devstats.reset()
    card, card_w = decode(Decoder(info, device=dev,
                                  use_device_synthesis=True))
    snap = devstats.snapshot()
    host, host_w = decode(Decoder(info, use_device_synthesis=False))
    cpu, cpu_w = decode(Decoder(info, device="cpu",
                                use_device_synthesis=True))
    if not len(card) == len(host) == len(cpu) == len(ref["packets"]):
        raise AssertionError("decoded %d / %d / %d frames of %d" % (
            len(card), len(host), len(cpu), len(ref["packets"])))
    for i, (a, b, c) in enumerate(zip(card, host, cpu)):
        for pli in range(3):
            if not (np.array_equal(a[pli], b[pli])
                    and np.array_equal(c[pli], b[pli])):
                raise AssertionError("decoded frame %d plane %d differs "
                                     "between %s, host and cpu" % (i, pli,
                                                                    dev))
    print("decode: %d frames, planes equal between the %s back end, the "
          "host decoder and the cpu back end" % (len(card), dev))
    print("decode: wall per frame %s %s s, host %s s, cpu back end %s s"
          % (dev, ["%.4f" % v for v in card_w], ["%.4f" % v for v in host_w],
             ["%.4f" % v for v in cpu_w]))
    print("decode: %s spans %s; launches %s; h2d %d bytes, d2h %d bytes; "
          "dispatches %d" % (dev, {k: round(v, 4) for k, v in
                                   snap["spans_s"].items()},
                             snap["launches"], snap["h2d_bytes"],
                             snap["d2h_bytes"], snap["dispatches"]))
    print("devstats: " + json.dumps(snap, sort_keys=True))
    for name in ("lap_frame", "dct_frame"):
        if snap["launches"].get(name, 0) <= 0:
            raise AssertionError("%s never launched in the decode" % name)
    return snap["launches"]


def table_rows(table):
    """{(pli, bs, by4, bx4, band): (noref, qg, itheta, ts, k, valid, y)}
    of a DevicePVQTable."""
    out = {}
    for g in table.groups:
        for band, r in g["bands"].items():
            for i in range(len(g["by4"])):
                out[(g["pli"], g["bs"], int(g["by4"][i]), int(g["bx4"][i]),
                     band)] = tuple(int(r[k][i]) for k in (
                         "noref", "qg", "itheta", "ts", "k", "valid")) \
                    + (tuple(int(v) for v in r["y"][i]),)
    return out


def phase_lean_small(torch, dev, sweep=False):
    """Phase 4c; with sweep, its lean+sweep half (bench.py's device+sweep
    configuration), in which obmc_leaf_cells must launch."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.models import pvqsearch as PS
    from daala_tpu_torch.utils import devstats
    w, h = 640, 368
    frames = textured_clip(w, h, 4)
    info = headers.Info(pic_width=w, pic_height=h)
    mode = dict(mv_refine_mode="sweep") if sweep else {}
    label = "lean%s %dx%d" % ("+sweep" if sweep else "", w, h)
    real = PS.search_frame
    agree = []

    def both(st, info, quantizer, d_planes, md_planes, lam,
             is_keyframe=False, use_masking=True):
        cpu = real(st, info, quantizer, [p.cpu() for p in d_planes],
                   None if md_planes is None
                   else [p.cpu() for p in md_planes], lam,
                   is_keyframe=is_keyframe, use_masking=use_masking)()
        finish = real(st, info, quantizer, d_planes, md_planes, lam,
                      is_keyframe=is_keyframe, use_masking=use_masking)

        def done():
            got = finish()
            a, b = table_rows(got), table_rows(cpu)
            if a.keys() != b.keys():
                raise AssertionError("card and cpu tables hold other rows")
            diff = sorted(k for k in a if a[k] != b[k])
            agree.append((len(a) - len(diff), len(a)))
            print("%s frame %d (%s): card and cpu tables agree on %d of %d "
                  "rows" % (label, len(agree) - 1,
                            "keyframe" if is_keyframe else "inter",
                            len(a) - len(diff), len(a)))
            for k in diff[:8]:
                print("  differs at (pli, bs, by4, bx4, band) %s: card %s, "
                      "cpu %s" % (k, a[k][:6], b[k][:6]))
            return got
        return done

    PS.search_frame = both
    try:
        devstats.reset()
        card_pk, card_s = encode(lean_encoder(info, dev, quant=25,
                                              complexity=7, **mode), frames)
        torch.cuda.synchronize()
        snap = devstats.snapshot()
    finally:
        PS.search_frame = real
    cpu_pk, cpu_s = encode(lean_encoder(info, "cpu", quant=25,
                                        complexity=7, **mode), frames)
    print("%s: %s %d bytes (%.2f s), cpu %d bytes (%.2f s), packets %s; "
          "encoder check passed on both; %s launches %s" % (
              label, dev, sum(map(len, card_pk)), card_s,
              sum(map(len, cpu_pk)), cpu_s,
              "identical" if card_pk == cpu_pk else "differ", dev,
              snap["launches"]))
    if len(agree) != len(frames):
        raise AssertionError("%d searched frames of %d" % (len(agree),
                                                            len(frames)))
    for same, total in agree:
        if same < 0.99 * total:
            raise AssertionError("card and cpu tables agree on %d of %d rows"
                                 % (same, total))
    if sweep and snap["launches"].get("obmc_leaf_cells", 0) <= 0:
        raise AssertionError("obmc_leaf_cells never launched (%s)" % label)


def phase_lean_sweep_1080p(torch, dev):
    """Phase 4c, information: phase 3's clip and preset in the lean tier
    with the sweep on the card, encoder check on."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import (ENCODER_KW, H, NFRAMES, W,
                                               translation_clip)
    enc = lean_encoder(headers.Info(pic_width=W, pic_height=H), dev,
                       mv_refine_mode="sweep", **ENCODER_KW)
    devstats.reset()
    pk, secs = encode(enc, translation_clip())
    torch.cuda.synchronize()
    snap = devstats.snapshot()
    print("lean+sweep %dx%d on %s: %d packets, %d bytes, %.3f Mpix/s (%.2f "
          "s), encoder check passed [information only]"
          % (W, H, dev, len(pk), sum(map(len, pk)),
             NFRAMES * W * H / 1e6 / secs, secs))
    print("devstats: " + json.dumps(snap, sort_keys=True))


def _watch_directions(calls):
    """Replace lap_frame_cuda and dct_frame_cuda by wrappers that append
    (kernel name, forward) of every call to `calls`; returns the function
    that restores them."""
    from daala_tpu_torch.ops.cuda import dct_kernels as D, lap_kernels as LK
    real_lap, real_dct = LK.lap_frame_cuda, D.dct_frame_cuda

    def lap(frame, sb_x=64, sb_y=64, forward=True):
        calls.append((LK.NAME, bool(forward)))
        return real_lap(frame, sb_x, sb_y, forward)

    def dct(frame, n, forward=True):
        calls.append((D.NAME, bool(forward)))
        return real_dct(frame, n, forward)
    LK.lap_frame_cuda, D.dct_frame_cuda = lap, dct

    def restore():
        LK.lap_frame_cuda, D.dct_frame_cuda = real_lap, real_dct
    return restore


def phase_batch_step(torch, dev):
    """Phase 7a: mesh.batch_encode_step on a (4, 1088, 1920) uint8 batch
    (bs = 1, quant = 3840) on make_mesh() and on the CPU: equal rec, sse
    and nz; both kernels launched in both directions.  Returns the
    launches."""
    from daala_tpu_torch.parallel import mesh as PM
    from daala_tpu_torch.utils import devstats
    frames = np.random.default_rng(SEED).integers(0, 256, (4, 1088, 1920),
                                                  np.uint8)
    mesh = PM.make_mesh()
    shards = PM.shard_batch(frames, mesh)
    PM.batch_encode_step([s[:1] for s in shards])  # warm-up
    torch.cuda.synchronize()
    calls = []
    restore = _watch_directions(calls)
    try:
        devstats.reset()
        t0 = time.perf_counter()
        rec, sse, nz = PM.batch_encode_step(shards)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        snap = devstats.snapshot()
    finally:
        restore()
    t0 = time.perf_counter()
    want = PM.batch_encode_step([torch.from_numpy(frames)])
    cpu_s = time.perf_counter() - t0
    got = torch.cat([r.cpu() for r in rec])
    if not (torch.equal(got, want[0][0]) and (sse, nz) == want[1:]):
        raise AssertionError("batch_encode_step differs between %s and cpu "
                             "(sse %d / %d, nz %d / %d)"
                             % (dev, sse, want[1], nz, want[2]))
    directions = sorted(set(calls))
    print("batch step: (4, 1088, 1920) uint8, bs 1, quant 3840 on a %s mesh "
          "of %s: rec, sse %d and nz %d equal to cpu; %s wall %.4f s "
          "(%.3f Mpix/s), cpu %.4f s; launches %s; (kernel, forward) %s"
          % (mesh.shape, [str(d) for d in mesh.ravel()], sse, nz, dev, card_s,
             4 * 1088 * 1920 / 1e6 / card_s, cpu_s, snap["launches"],
             directions))
    for name in ("lap_frame", "dct_frame"):
        if {(name, True), (name, False)} - set(calls):
            raise AssertionError("%s did not launch in both directions"
                                 % name)
        if snap["launches"].get(name, 0) != 2 * len(frames):
            raise AssertionError("%s launched %s times, not %d" % (
                name, snap["launches"].get(name), 2 * len(frames)))
    return snap["launches"]


def phase_clips_batched(torch, dev, ref):
    """Phase 7b: encode_clips_batched of bench.py's two 1080p clips
    (translation: phase 3's frames; natural) on make_mesh(), in both
    schedules; returns the launches of both runs together."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.encoder import Encoder
    from daala_tpu_torch.parallel import mesh as PM
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import (ENCODER_KW, H, NFRAMES, W,
                                               make_natural_clip,
                                               translation_clip)
    t0 = time.perf_counter()
    clips = [translation_clip(), make_natural_clip(W, H, NFRAMES, seed=3)]
    print("clips batched: natural clip made in %.2f s"
          % (time.perf_counter() - t0))
    info = headers.Info(pic_width=W, pic_height=H)
    kw = {k: v for k, v in ENCODER_KW.items()
          if k not in ("quant", "complexity")}
    mesh = PM.make_mesh()
    runs, total = {}, {}
    for threads in (False, True):
        devstats.reset()
        t0 = time.perf_counter()
        outs = PM.encode_clips_batched(
            clips, dict(pic_width=W, pic_height=H), mesh,
            quant=ENCODER_KW["quant"], complexity=ENCODER_KW["complexity"],
            enc_kwargs=kw, threads=threads)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        snap = devstats.snapshot()
        runs[threads] = ([[bytes(p) for p in o] for o in outs], secs,
                         snap["launches"])
        for k, v in snap["launches"].items():
            total[k] = total.get(k, 0) + v
        print("clips batched, %s: %d clips x %d frames at %dx%d, %.2f s, "
              "%.3f Mpix/s; launches %s; spans %s" % (
                  "threads" if threads else "round-robin", len(clips),
                  NFRAMES, W, H, secs,
                  len(clips) * NFRAMES * W * H / 1e6 / secs,
                  snap["launches"],
                  {k: round(v, 4) for k, v in snap["spans_s"].items()}))
    serial_card, _ = encode(Encoder(info, device=dev, **ENCODER_KW),
                            clips[1])
    cpu_nat, cpu_s = encode(Encoder(info, device="cpu", **ENCODER_KW),
                            clips[1])
    serial = [ref["packets"], serial_card]
    for threads, (outs, _, _) in runs.items():
        for ci, name in enumerate(("translation", "natural")):
            if outs[ci] != serial[ci]:
                raise AssertionError(
                    "batched %s clip (threads=%s) differs from its serial "
                    "card encode" % (name, threads))
    if serial_card != cpu_nat:
        raise AssertionError("natural clip: card packets differ from the "
                             "cpu run's")
    for name in ("lap_frame", "dct_frame"):
        a, b = runs[False][2].get(name, 0), runs[True][2].get(name, 0)
        if not a == b > 0:
            raise AssertionError("%s launches differ between the schedules "
                                 "(%d round-robin, %d threads)" % (name, a, b))
    rr, th = runs[False][1], runs[True][1]
    print("clips batched: both clips byte-identical across schedules and to "
          "serial card encodes (translation %d bytes = phase 3's, natural "
          "%d bytes); natural clip card == cpu (cpu %.2f s), encoder check "
          "passed on both; walls round-robin %.2f s, threads %.2f s, ratio "
          "%.3f (round-robin / threads) [information only]"
          % (sum(map(len, serial[0])), sum(map(len, serial[1])), cpu_s, rr,
             th, rr / th))
    return total


def phase_segments(torch, dev):
    """Phase 7c: encode_clip_parallel of a 320x192, 32-frame clip in 16-
    frame segments on 2 spawned workers on the card: decodable, and the
    packets of serial card encodes of each segment by a fresh Encoder
    with a keyframe every 16 frames.  One encoder over the whole clip
    differs from frame 20 on: its golden frames (every 10th keyframe or
    P frame it codes, codec/encoder.py `ip_frame_count`) run across the
    keyframe at frame 16 (printed as information)."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.encoder import Encoder
    from daala_tpu_torch.parallel import mesh as PM
    w, h, n, seg = 320, 192, 32, 16
    frames = textured_clip(w, h, n)
    info_kwargs = dict(pic_width=w, pic_height=h)
    kw = dict(quant=25, complexity=7, device=str(dev))
    t0 = time.perf_counter()
    pkts = [bytes(p) for p in PM.encode_clip_parallel(
        frames, info_kwargs, kw, segment_len=seg, workers=2)]
    par_s = time.perf_counter() - t0
    info = headers.Info(keyframe_rate=seg, **info_kwargs)

    def serial(clip):
        enc = Encoder(info, **kw)
        return ([bytes(p) for fr in clip for p in enc.encode_frame(fr)]
                + [bytes(p) for p in enc.flush()])
    t0 = time.perf_counter()
    want = [p for i in range(0, n, seg) for p in serial(frames[i:i + seg])]
    ser_s = time.perf_counter() - t0
    if pkts != want:
        raise AssertionError("segment-parallel packets differ from the "
                             "serial encodes of the segments")
    whole = serial(frames)
    psnr = luma_psnr(frames, pkts, info)
    print("segments: %dx%d, %d frames in %d-frame segments on 2 spawned "
          "workers on %s (%.2f s, with their start-up) = serial encodes of "
          "the segments (%.2f s), %d bytes; decoded by the port's host "
          "Decoder, %d frames, luma PSNR %.4f dB; one encoder over the "
          "clip: %d bytes, other packets at frames %s [information only]"
          % (w, h, n, seg, dev, par_s, ser_s, sum(map(len, pkts)), n, psnr,
             sum(map(len, whole)),
             [i for i, (a, b) in enumerate(zip(whole, pkts)) if a != b]))


def kernel_line(kern, launches, decode_launches, batch_launches):
    """The kernels line: each kernel's launches on the encoder's path, in
    the decode and in the batched phases 7a-7b, and its numbers summed
    over phase 2's and 2b's timed
    variants (each shape, size, direction or bit depth once):
    per-call medians through the wrapper ("ms"), the kernels' device time
    per call in the trace ("device_ms"), the plain version's, and the
    bounds; "bound_by" names what bounds the larger part of bound_ms.
    No single PyTorch call computes any of these functions, so
    library_ms is null."""
    pallas = "daala_tpu/ops/pallas/"
    sources = {
        "lap_frame": ("lap_frame.cu", pallas + "lap_kernels.py:78"),
        "dct_frame": ("dct_frame.cu", pallas + "dct_kernels.py:83"),
        "obmc_blend": ("obmc_leaf.cu", pallas + "obmc_kernels.py:191"),
        "obmc_leaf_cells": ("obmc_leaf.cu", pallas + "obmc_kernels.py:208"),
    }
    rows = []
    for name, (src, rep) in sources.items():
        if name not in kern:
            continue
        k = kern[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "daala_tpu_torch/csrc/" + src, "replaces": rep,
            "launches": launches.get(name),
            "decode_launches": decode_launches.get(name, 0),
            "batch_launches": batch_launches.get(name, 0),
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "device_ms": k["device_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": max(k["bound_by"], key=k["bound_by"].get),
            "library_ms": None, "variants": k["variants"]})
    return {"kernels": rows}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="PARENT",
                    help="only phases 1 and 2, with the lap_frame.cu and "
                    "dct_frame.cu of the checkout PARENT and of this tree "
                    "in turns (parent, change, change, parent)")
    args = ap.parse_args(argv)
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
    if args.ab:
        phase_ab(torch, dev, args.ab)
        return 0
    t_start = time.perf_counter()

    def run(name, fn, *a, **kw):
        """fn(*a, **kw), printing the phase's wall (the run's time budget
        is kept with these)."""
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        print("time: phase %s %.1f s (run %.1f s)" % (
            name, time.perf_counter() - t0, time.perf_counter() - t_start))
        return out

    kern = {}
    run("2", phase_kernels, torch, dev, kern)
    run("2b", phase_obmc_kernels, torch, dev, kern)
    launches = run("2c", phase_obmc_frame, torch, dev)
    ref = run("3", phase_encoder, torch, dev)
    launches.update({k: v for k, v in ref["launches"].items()
                     if k in ("lap_frame", "dct_frame")})
    run("3c", phase_lean, torch, dev, ref)
    run("3d", phase_fields, torch, dev)
    run("3e", phase_dering_candidates, torch, dev)
    launches["obmc_leaf_cells"] = run(
        "4", phase_sweep, torch, dev)["obmc_leaf_cells"]
    run("4c", phase_lean_small, torch, dev)
    run("4c sweep", phase_lean_small, torch, dev, sweep=True)
    run("4c sweep 1080p", phase_lean_sweep_1080p, torch, dev)
    decode_launches = run("6", phase_decoder, torch, dev, ref)
    batch_launches = run("7a", phase_batch_step, torch, dev)
    for k, v in run("7b", phase_clips_batched, torch, dev, ref).items():
        batch_launches[k] = batch_launches.get(k, 0) + v
    run("7c", phase_segments, torch, dev)
    leaked = sorted(m for m in sys.modules if m in ("jax", "daala_tpu")
                    or m.startswith(("jax.", "daala_tpu.")))
    if leaked:
        raise AssertionError("imported: %s" % leaked)
    print(json.dumps(kernel_line(kern, launches, decode_launches,
                                 batch_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
