#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (daala_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card, the
CUDA toolkit (nvcc) and g++:

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT [--rounds R]  # phases 1-2, band cases

With --ab, PARENT is another checkout (at least its daala_tpu_torch/
csrc/); phase 2, and phase 2d's sad_fields, band_prologue and
band_epilogue cases, run with its lap_frame.cu, dct_frame.cu,
sad_fields.cu and band_search.cu (where it has them) and with this
tree's, in R rounds (default 1) of turns (parent, change, change,
parent) in one process on one card, and print each case's device time
per turn and each side's median and range; the band cases take the
calls of phase 3c's traced frames, captured first with this tree, and
print each epilogue call's share of ok candidates.  Beside them, both
trees' band kernels' blocks an SM.

Phases, each printing its lines; any failure raises and exits nonzero:

1. Environment: the card's name and power limit (nvidia-smi), its
   maximum SM clock, torch and CUDA versions; builds the port's native
   host engine and the six CUDA sources (lap_frame, dct_frame,
   obmc_leaf, pulse_search, band_search, sad_fields; into build/, first
   use only,
   all nvcc runs at once) and prints each build's seconds and ptxas's
   registers, stack and spills of every kernel instantiation, the band
   kernels' blocks an SM (the occupancy API), and, as information, the
   card's vabsdiff4 issue rate (a probe kernel of independent __vsadu4
   chains): what bounds sad_fields in practice.
2. Kernel vs plain PyTorch version, on the card, at the 1080p encoder's
   shapes: lap_frame forward and inverse on a (1088, 1920) luma plane
   (superblock 64) and a (544, 960) chroma plane (superblock 32);
   dct_frame forward and inverse at n = 4..64 on luma and n = 4..32 on
   chroma.  Inputs are int32 in +-2^14 from a seed.  Each kernel must
   equal its plain version bit for bit and inverse(forward(x)) == x.
   Every timed call finds the 50 MB L2 cold (`flush_l2` before it), as
   the main path does: CUDA-event times of calls through the wrapper
   ("kernel"), the kernels' own device time from a torch.profiler trace
   ("device") and the bound (see `bound`); the plain versions over
   fewer calls (PLAIN_REPS).  Beside them, as information,
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
2d. (Run after phase 3c, whose inputs it takes.)  The PVQ search's
   kernels against their plain versions on the card, bit for bit, timed
   as in phase 2: pulse_search (csrc/pulse_search.cu, the whole of
   models/pvqsearch.py _pulse_search) against the whole plain search on
   the arguments of every band_search call of phase 3c's traced keyframe
   and first inter frame (each band length; each call's longest trip
   count printed beside its time), band_prologue and band_epilogue
   (csrc/band_search.cu, the rest of band_search before and after its
   pulse search) against band_prologue_plain and band_epilogue_plain on
   the same calls' arguments (their bound by band_work, the nodes that
   code counted from each call's pulses, and beside it the first
   design's count), and sad_fields (csrc/sad_fields.cu,
   the SAD fields of models/mefield.py) on the 1080p translation pair
   at r = 16, as one tile and as the 2 x 2 tiles of phase 9's mesh.
   Untimed: the prologue's arccos (csrc/band_row.cuh br::acos_xla,
   glibc's atan2f written out; band_kernels.acos_xla_cuda) against
   acos_xla on the card on every float32 c in [-1, 1], 2,130,706,434
   values, bit for bit; and, for information, the c where CUDA's own
   atan2f, which the kernels do not take, and theta_q part from it.
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
   and both analysis kernels and sad_fields must have launched in the
   card's run (launch counts are reset just before it); prints the
   dering_candidates span of both runs.
3c. The lean tier (bench.py's `device` configuration:
   use_device_analysis=False, use_device_pvq=True) on phase 3's clip
   and preset on "cuda", encoder check on: decoded by the port's
   Decoder, its luma PSNR within 0.3 dB of phase 3's (the host
   search, byte-identical to daala_tpu's host encoder) and its bytes
   within -10% / +5% of phase 3's (on this clip the lean search, like
   JAX's, codes the inter frames about 6% smaller than the host
   search); lap_frame, dct_frame, pulse_search, band_prologue,
   band_epilogue and sad_fields launched; every band_search call ran on
   the card and launched band_prologue, pulse_search and band_epilogue
   once each (devstats, printed); under half of phase 3's
   device->host bytes.  Prints
   its devstats, Mpix/s, the search_frame and SAD-field spans, the rows
   the search marked invalid (searched on the host), and, from
   utils/profile.py's torch.profiler trace of a fresh encoder's
   keyframe and first inter frame, the launches, device time and rows
   of every band_search call.  Every band_search call of that trace is
   replayed on the CPU, where the plain versions run: every row's ints,
   pulses and skip_diff bits (NaN equal to NaN) must equal the card's.
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
8a. train/zigzag.py measure_mags over bench.py's two 1080p clips (phase
   3's translation frames and make_natural_clip with seed 3), luma
   only, 4 frames each, cropped to 1024x1920, for n = 4, 8, 16, 32, 64,
   on the card and on the CPU: the mags equal bit for bit and
   gen_zigzag's tables equal; lap_frame and dct_frame launched once per
   frame and n (40 each; counts reset just before the card's run).
   Prints both walls.
8b. train/vq.py on 2^20 unit vectors of 16 dims (512 clusters with
   noise, from the seed), 256 entries: one k-means step on the card
   against _step_np on the same float32 inputs (assignments equal on
   >= 99.99% of rows, rms within 1e-5 relative, codebook within 1e-4),
   then 20 iterations of train() on the card, twice: rms falls and the
   two runs are identical.  Prints the rms history, the walls and the
   device time of a step from a torch.profiler trace.
8c. train/gain.py search, (n 4, filt 4) and (n 8, filt 8), 400 Adam
   steps, on the card and on the CPU: equal polished integer
   parameters, float_cg within 1e-4 dB; both walls printed.
8d. utils/sweep_quality.py's device_pvq on the natural class, seed 0,
   quants 12, 25, 40, 60, at 320x192 with 2 frames on the card (BD-rate
   and time ratio printed); the candidate's packets at quant 25 equal
   on the card and on the CPU.
9. The mesh's sp axis (parallel/sharding.py) on a 2 x 2 mesh of the
   one card, make_mesh(devices=["cuda:0"] * 4, dp=2): (a) phase 3's
   clip, keyframe + 1 P frame, phase 3's preset, encoder check on, with
   the analysis tier sharded ("dp", "sp") (the encoder's device_put_fn:
   each plane in 4 tiles cut on superblocks, 9 + 8 rows by 15 + 15
   columns at 1080p), byte-identical to the same two frames unsharded on
   the card (and to phase 3's first two packets); (b) those packets
   decoded with the synthesis sharded likewise: the host decoder's
   frames; (c) every tile of a 1080p luma and chroma plane: lap_frame
   forward and inverse from the tile's origin against its plain version
   on the same tile and against the plane's kernel, dct_frame at every
   size on the tile's interior against its plain version, bit for bit
   (the first tile's lap times with a halo of 2 and of 4 beside
   their bounds printed); (d) encode_clips_batched
   of phase 7b's two clips (2 frames each) on the (2, 2) mesh, each
   clip's planes over its row's 2 columns, in both schedules: the
   serial card encodes; (e) batch_encode_step of phase 7a's batch over
   the (2, 2) mesh: phase 7a's rec, sse and nz; (f) only where torch
   sees 2 or more cards, (a) over distinct cards; otherwise a line says
   that it did not run.  Prints the sharded and unsharded walls per
   frame, the halo bytes per frame and the launches, as information.
10. The encoder's Python coefficient path: phase 4c's clip (640x368,
   3 frames, a keyframe every 2, so a mid-stream keyframe) in the lean
   tier with the sweep, quant 25, complexity 7, encoded by a fresh
   encoder with use_native_frame = False and by one with the native
   frame pass, the encoder check on in both: byte-identical packets,
   valid table entries handed to the Python path's forced-band replay
   (devstats "forced_bands" > 0), and lap_frame, dct_frame and
   obmc_leaf_cells launched in the Python run.  Prints both walls and
   the bytes.
11. The benchmark harnesses, each in its own process as bench.py's
   probes are: `python -m daala_tpu_torch.bench` (the three
   configurations probed, then the fastest on bench.py's two 1080p
   clips, two runs each) and `python -m
   daala_tpu_torch.utils.bench_scaling` at its defaults.  Every probe
   is a measurement, not an error, with lap_frame, dct_frame and
   sad_fields launched in it (pulse_search, band_prologue and
   band_epilogue in the lean tier's two,
   obmc_leaf_cells in device+sweep's); the headline
   is above 0 with both clips; the translation clip's bytes equal the
   checked encode of the chosen configuration (phase 3, 3c or 4c's
   1080p run); both scaling walls are above 0.  Prints both JSON lines.
12. The command-line tools (daala_tpu_torch/tools/encode.py and
   decode.py, their main() in this process, files under build/cli/,
   removed after): (a) phase 3's 1920x1080 clip written as y4m and
   encoded on the card with phase 3's settings (-v 25 -z 7 --check, the
   fast trial pass and its boost by default): its video packets equal
   phase 3's card packets, lap_frame and dct_frame launched (counts
   reset before); (b) that .ogv decoded on the card: phase 6's host
   decoder frames, both kernels launched.  Prints the walls, the
   encode's Mpix/s beside phase 3's API wall, and the host I/O alone
   (reading the y4m, muxing phase 3's packets) as a share of the
   encode wall.  (c) At 320x192 (textured_clip), every mode of the
   CLI (CLI_MODES: -b 2 --check, --bitrate, two-pass, lossless, 10-bit,
   4:2:2 input, 4:4:4, mono, --limit, -z 3, a -k 4 stream decoded also
   with --seek, --config device and device+sweep, --workers 2 on 32
   frames in 16-frame segments) on the card and with --device cpu: the
   .ogv files (two-pass: both runs and the statistics) and the decoded
   y4m files byte-identical; lossless launches no kernel and decodes to
   the input; every other mode launches lap_frame and dct_frame in its
   card decode and (but --workers, whose spawned workers count their
   own) its card encode; device+sweep launches obmc_leaf_cells; the
   --seek decode is the full decode from frame 6 on.  Prints each
   mode's walls.
5. A line of JSON with each kernel's route, source, launches (lap_frame,
   dct_frame and sad_fields from phase 3, pulse_search, band_prologue
   and band_epilogue from phase 3c,
   obmc_blend from phase 2c, obmc_leaf_cells from phase 4b) and, beside
   them, its launches in phase 3 ("analysis_launches"), 3c
   ("lean_launches"), 4b ("sweep_launches"), in
   phase 6's decode ("decode_launches"), in phases 7a-7b (both
   schedules; "batch_launches"), in phase 8a ("train_launches"), in
   phase 9's sharded paths ("shard_launches"), in phase 10's Python
   run ("python_path_launches"), in phase 11's probe runs
   ("bench_launches") and in phase 12's card runs ("cli_launches"),
   error, times and bound; then, as the
   last line, {"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": ...}}.

Without a CUDA device, or without the repository beside it, it exits
nonzero and prints no result.  tests/ imports its case generators
(random_leaves, random_grid, random_refs, textured_clip,
PaddedImage).
"""

import json
import math
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
# The plain versions, which take milliseconds to a tenth of a second a
# call, are timed over fewer: (batch, repeats, warm-up calls).
PLAIN_REPS = (2, 2, 1)


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


def batch_ms(torch, fn, batch=BATCH, repeats=REPEATS, warm=3):
    """Median over `repeats` of the mean CUDA-event time of `batch` calls,
    each timed alone after flush_l2, after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        events = []
        for _ in range(batch):
            flush_l2(torch)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        out.append(sum(a.elapsed_time(b) for a, b in events) / batch)
    return statistics.median(out)


def trace_ms(torch, fn, names, calls=10, tries=3, cats=("kernel",),
             flush=True, detail=None):
    """Device time per call of fn from a torch.profiler trace of `calls`
    calls, each after flush_l2 (unless flush is False): for each device
    event of a category in `cats` whose name holds one of `names`, its
    mean duration times its launches per call.  Returns (ms, events
    seen, calls); a trace that shows none of them is taken again, up to
    `tries` times, and then ms is None.  A dict `detail` receives each
    event name's share of ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, "kernel_trace.json")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush:
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
            per = {k: statistics.mean(d) / 1e3 * max(1, round(len(d) / calls))
                   for k, d in durs.items()}
            if detail is not None:
                detail.update(per)
            return sum(per.values()), sum(map(len, durs.values())), calls
    return None, 0, calls


# The bound of a call: the larger of its bytes over the card's memory
# rate and its operations over the card's peak rate for their type:
# int32 operations over 132 SMs x 64 int32 lanes x the maximum SM clock
# that nvidia-smi reads (phase 1 sets "ops_per_s"), float32 operations
# over the published 67 TFLOP/s outside the tensor cores
# ("flops_per_s", at the 700 W limit).  Input bytes count once and
# output bytes once; operations are counted from the code (the
# functions below).
RATES = {"bytes_per_s": 3.35e12, "ops_per_s": None, "flops_per_s": 67e12}
SM_INT32_LANES = 132 * 64


def bound(nbytes, ops, rate="ops_per_s"):
    """(ms, "bytes" or "operations") of a call that moves nbytes and
    does ops operations of the type that RATES[rate] counts, or, where
    ops is a dict {rate: operations}, operations of several types, which
    the card runs on separate lanes (the least time is the largest)."""
    b_ms = nbytes / RATES["bytes_per_s"] * 1e3
    ops = ops if isinstance(ops, dict) else {rate: ops}
    o_ms = max(v / RATES[k] * 1e3 for k, v in ops.items())
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
    from daala_tpu_torch.ops.cuda import (_build, band_kernels, dct_kernels,
                                          lap_kernels, obmc_kernels,
                                          pulse_kernels, sad_kernels)
    from daala_tpu_torch.utils import devstats

    def native_lib():
        if native.get_lib() is None:
            raise RuntimeError("the native host engine did not build")

    # g++ and one nvcc per source, all at once; map() re-raises a failure.
    t0 = time.perf_counter()
    builds = (native_lib, lap_kernels.build, dct_kernels.build,
              obmc_kernels.build, pulse_kernels.build, band_kernels.build,
              sad_kernels.build)
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda f: f(), builds))
    print("build: native engine, %s.cu, %s.cu, %s.cu, %s.cu, %s.cu and %s.cu "
          "ready in %.1f s, in parallel; nvcc (sm_90a) seconds of the "
          "sources built now (none if build/ held them): %s"
          % (lap_kernels.NAME, dct_kernels.NAME, obmc_kernels.SOURCE,
             pulse_kernels.NAME, band_kernels.NAME, sad_kernels.NAME,
             time.perf_counter() - t0,
             {k: round(v, 1) for k, v in devstats.BUILDS.items()}))
    for src, text in sorted(_build.PTXAS.items()):
        for fn, regs, stack, st, ld in _build.ptxas_report(text):
            print("ptxas: %s: %d registers, %d bytes stack, spills %d/%d "
                  "bytes (store/load): %s" % (src, regs, stack, st, ld, fn))
    print("occupancy: %s blocks an SM (the occupancy API, at each launch's "
          "block size and shared memory): %s"
          % (band_kernels.NAME, band_kernels.occupancy()))
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
    vabsdiff4_rate(torch)


# One launch of 132 x 16 blocks of 256 threads, each thread 16
# independent chains of `iters` __vsadu4 (a vabsdiff4 with its sum, the
# SAD fields' operation).
_RATE_PROBE = r"""
#include <stdint.h>
__global__ void vsad_chains(uint32_t *out, int iters) {
  uint32_t x[16];
  for (int k = 0; k < 16; k++) x[k] = 2654435761u * (threadIdx.x + 7 * k + 1);
  for (int it = 0; it < iters; it++)
#pragma unroll
    for (int k = 0; k < 16; k++) x[k] = __vsadu4(x[k], 0x9e3779b9u * k);
  uint32_t s = 0;
  for (int k = 0; k < 16; k++) s += x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int vsad_probe(void *out, int blocks, int iters) {
  vsad_chains<<<blocks, 256>>>((uint32_t *)out, iters);
  return (int)cudaGetLastError();
}
"""


def vabsdiff4_rate(torch):
    """The card's vabsdiff4 issue rate, lanes a clock per SM at the
    maximum SM clock (median of 3 launches, CUDA events): what bounds
    sad_fields in practice, against the int32 rate of `bound`.
    Information only."""
    import ctypes
    from daala_tpu_torch.ops.cuda import _build
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "vsad_probe.cu")
    so = os.path.join(BUILD, "vsad_probe.so")
    with open(src, "w") as f:
        f.write(_RATE_PROBE)
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + ["-o", so, src],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(so).vsad_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    blocks, iters = 132 * 16, 4000
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    ms = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _build.check(fn(out.data_ptr(), blocks, iters), "vsad_probe")
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    t = statistics.median(ms[1:])
    lanes = blocks * 256 * iters * 16 / (t * 1e-3) / 132 / (
        RATES["ops_per_s"] / SM_INT32_LANES)
    print("rate: vabsdiff4 %.2f lanes a clock per SM (%.4f ms for %d; the "
          "bound counts 64 int32 lanes) [information only]"
          % (lanes, t, blocks * 256 * iters * 16))


CASES = []  # (label, kernel ms, device ms, plain ms, bound ms) of record
TIME_PLAIN = True  # False: record checks plain but does not time it


def output_err(torch, got, want):
    """(max |got - want|, bit for bit equal) over the outputs, a tensor
    or a tuple of tensors."""
    from daala_tpu_torch.ops.cuda.obmc_kernels import bits
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err, same = 0, len(got) == len(want)
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), False
        if g.numel() == 0:
            continue
        if g.is_floating_point():
            # NaN against NaN is no error; against a number, an infinite one.
            d = (g.double() - w.double()).abs()
            d = torch.where(g.isnan() & w.isnan(), 0.0, d)
            err = max(err, float(torch.nan_to_num(d, nan=math.inf).max()))
            same &= torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            d = int((bits(g).long() - bits(w).long()).abs().max().item())
            err, same = max(err, d), same and d == 0
    return err, same


def record(torch, res, name, label, kern, plain, work, trace_names,
           plain_reps=PLAIN_REPS):
    """Time kern (CUDA events through the wrapper, and its kernels'
    device time in a profiler trace) and plain (CUDA events; plain_reps:
    batch_ms's batch, repeats and warm-up calls), each call with a cold
    L2, hold kern's output to plain's bit for bit, and add the bound of
    `work` (bytes, ops[, the RATES key of the ops' type])."""
    err, same = output_err(torch, kern(), plain())
    k_ms = batch_ms(torch, kern)
    p_ms = (batch_ms(torch, plain, *plain_reps) if TIME_PLAIN
            else float("nan"))
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
    ops = work[1] if isinstance(work[1], dict) else {
        work[2] if len(work) > 2 else "ops_per_s": work[1]}
    print("kernel: %-44s max_abs_err %g  kernel %.4f ms  device %s ms "
          "(%d events, %d calls)  plain %.4f ms  bound %.4f ms (%s; %d B, "
          "%s)"
          % (label, err, k_ms, "%.4f" % d_ms if d_ms is not None else "none",
             seen, calls, p_ms, b_ms, by, work[0], ", ".join(
                 "%d %s" % (v, "float32 ops" if k == "flops_per_s" else
                            "int32 ops") for k, v in ops.items())))
    if err or not same:
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
    """Build lap_frame.cu, dct_frame.cu, sad_fields.cu and band_search.cu
    of the checkout at `root` (the same nvcc flags, in parallel) and load
    them with this tree's entries; returns {source: (library, its kernels'
    names)}."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from daala_tpu_torch.ops.cuda import (_build, band_kernels, dct_kernels,
                                          lap_kernels, sad_kernels)
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
        entries = getattr(mod, "ENTRIES", None) or {mod.NAME: mod._ARGTYPES}
        for name, argtypes in entries.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        return mod.NAME, (lib, global_names(src))

    mods = (lap_kernels, dct_kernels, sad_kernels, band_kernels)
    with ThreadPoolExecutor(len(mods)) as ex:
        return dict(ex.map(one, mods))


def capture_band_calls(torch, dev):
    """The arguments of every band_prologue and band_epilogue call of a
    fresh lean encoder's keyframe and first inter frame of phase 3c's
    clip and preset (the frames that phase 3c traces): [(frame, name,
    args)]."""
    from daala_tpu_torch.utils.profile import _encoder, translation_clip
    frames = translation_clip(nframes=2)
    calls, out = [], []
    stop = watch_band_kernels(calls)
    try:
        enc = _encoder(dev, False, lean=True)
        for label, fr in (("keyframe", frames[0]), ("inter", frames[1])):
            k = len(calls)
            enc.encode_frame(fr)
            out += [(label,) + c for c in calls[k:]]
        torch.cuda.synchronize()
    finally:
        stop()
    return out


def phase_ab(torch, dev, parent, rounds=1):
    """Phase 2, phase 2d's sad_fields cases and its band_prologue and
    band_epilogue cases, with the lap_frame.cu, dct_frame.cu,
    sad_fields.cu and band_search.cu of the checkout at `parent` and of
    this tree, in `rounds` rounds of turns (parent, change, change,
    parent) in one process on one card, every call with a cold L2;
    prints each case's device time per turn, each side's median and
    range, and, as a line of JSON, all of them.  The band cases take the
    calls of phase 3c's traced frames, captured once with this tree
    (capture_band_calls), with each epilogue call's ok candidates; each
    turn holds each kernel to its plain version bit for bit.  Beside
    them: both trees' band kernels' blocks an SM (the occupancy API).
    The parent's sources must take this tree's entries (its
    band_search.cu exports band_occupancy).  (pulse_search.cu
    took another interface before it held the whole search, so it has no
    turn here.)"""
    import ctypes
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    from daala_tpu_torch.ops.cuda import sad_kernels as SK
    global TIME_PLAIN
    from daala_tpu_torch.ops.cuda import _build
    other = build_other(parent, "parent")
    mine = {name: (_build.load(name, {}), tuple(
        global_names(os.path.join(_build.CSRC, name + ".cu"))))
        for name in other}
    band_calls = capture_band_calls(torch, dev)
    print("ab: %d band kernel calls captured from phase 3c's traced frames"
          % len(band_calls))
    out = (ctypes.c_int * len(BK.OCCUPANCY))()
    _build.check(other[BK.NAME][0].band_occupancy(ctypes.addressof(out)),
                 "band_occupancy")
    print("ab: parent's blocks an SM: %s" % dict(zip(BK.OCCUPANCY, out)))
    print("ab: change's blocks an SM: %s" % BK.occupancy())
    TIME_PLAIN = False
    turns = []
    try:
        for tag, libs in rounds * (("parent", other), ("change", mine),
                                   ("change", mine), ("parent", other)):
            for name, (lib, _) in libs.items():
                _build._LIBS[name] = lib
            del CASES[:]
            print("ab: turn %d, %s" % (len(turns) + 1, tag))
            names = {name: kn for name, (_, kn) in libs.items()}
            phase_kernels(torch, dev, {}, names)
            sad_kernel_cases(torch, dev, {}, names[SK.NAME])
            band_kernel_cases(torch, {}, band_calls, names[BK.NAME])
            turns.append((tag, list(CASES)))
    finally:
        for name, (lib, _) in mine.items():
            _build._LIBS[name] = lib
    oks = {band_case(label, name, args): ok_share(args)
           for label, name, args in band_calls if name == "band_epilogue"}

    def side(dev_us, tag):
        got = [v for t, v in zip(turns, dev_us) if t[0] == tag and v]
        if not got:
            return "none"
        return "%.3f (%.3f-%.3f)" % (float(np.median(got)), min(got),
                                     max(got))

    rows = []
    for i, case in enumerate(turns[0][1]):
        dev_us = [t[1][i][2] * 1e3 if t[1][i][2] is not None else None
                  for t in turns]
        ms = [t[1][i][1] for t in turns]
        bound_us = None if case[4] != case[4] else case[4] * 1e3  # NaN
        rows.append({"case": case[0], "bound_us": bound_us,
                     "device_us": dev_us, "ms": ms,
                     "ok": oks.get(case[0])})
        print("ab: %-28s bound %s us  device us, median (range) of %d "
              "turns: parent %s / change %s%s  turns %s  wrapper ms %s" % (
                  case[0], "%7.3f" % bound_us if bound_us else "   none",
                  2 * rounds, side(dev_us, "parent"), side(dev_us, "change"),
                  "  ok candidates " + oks[case[0]] if case[0] in oks else "",
                  ", ".join("%.3f" % v if v is not None else "none"
                            for v in dev_us),
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
    bytes, luma PSNR and wall."""
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
    for name in ("lap_frame", "dct_frame", "sad_fields"):
        if snap["launches"].get(name, 0) <= 0:
            raise AssertionError("%s never launched on the main path" % name)
    psnr = luma_psnr(frames, card_pk, headers.Info(pic_width=W, pic_height=H))
    print("encode: luma PSNR %.4f dB (port Decoder)" % psnr)
    return dict(launches=snap["launches"], packets=card_pk,
                d2h_bytes=snap["d2h_bytes"], psnr=psnr, wall=card_s)


def _watch_band_search(calls):
    """Replace pvqsearch.band_search by a wrapper that appends (n, rows,
    input device, output device, the kernel launches that devstats
    counted in the call) of every call to `calls`; returns the function
    that restores it."""
    from daala_tpu_torch.models import pvqsearch as PS
    from daala_tpu_torch.utils import devstats
    real = PS.band_search

    def watched(*args, **kw):
        before = dict(devstats.snapshot()["launches"])
        out = real(*args, **kw)
        after = devstats.snapshot()["launches"]
        calls.append((args[9], int(args[2].shape[0]), args[0].device.type,
                      out[0].device.type,
                      {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}))
        return out
    PS.band_search = watched

    def restore():
        PS.band_search = real
    return restore


def watch_pulse_search(calls):
    """Replace pvqsearch.pulse_search by a wrapper that appends its
    arguments to `calls` (the tensors themselves: band_search makes
    them for the call and nothing writes them after it); returns the
    function that restores it."""
    from daala_tpu_torch.models import pvqsearch as PS
    real = PS.pulse_search

    def watched(*args):
        calls.append(args)
        return real(*args)
    PS.pulse_search = watched

    def restore():
        PS.pulse_search = real
    return restore


def watch_band_kernels(calls):
    """Replace pvqsearch.band_prologue and band_epilogue by wrappers that
    append ("band_prologue" or "band_epilogue", its arguments) to `calls`
    (the tensors themselves: nothing writes them after the call); returns
    the function that restores them."""
    from daala_tpu_torch.models import pvqsearch as PS
    real = {name: getattr(PS, name) for name in ("band_prologue",
                                                 "band_epilogue")}

    def wrap(name):
        def watched(*args):
            calls.append((name, args))
            return real[name](*args)
        return watched
    for name in real:
        setattr(PS, name, wrap(name))

    def restore():
        for name, fn in real.items():
            setattr(PS, name, fn)
    return restore


def watch_io(calls):
    """Replace pvqsearch.band_search by a wrapper that appends (args,
    kwargs, outputs) of every call to `calls`, the tensors themselves:
    on the card each is made for the call (an upload or a new tensor)
    and nothing writes it after, since the codec fetches copies (on the
    CPU an upload shares the codec's arrays, which it goes on updating);
    returns the function that restores it."""
    from daala_tpu_torch.models import pvqsearch as PS
    real = PS.band_search

    def watched(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out
    PS.band_search = watched

    def restore():
        PS.band_search = real
    return restore


def rows_differing(torch, got, want):
    """The rows of two band_search results (ints, y, skip_diff) where any
    output differs, skip_diff by its bits with NaN equal to NaN."""
    g, w = got[2], want[2]
    same = ((got[0] == want[0]).all(1) & (got[1] == want[1]).all(1)
            & ((g.view(torch.int32) == w.view(torch.int32))
               | (g.isnan() & w.isnan())))
    return int((~same).sum())


def replay_on_cpu(torch, calls, labels):
    """Each band_search call captured by watch_io on the card run again
    on the CPU, where the plain versions run; raises unless every row
    equals the card's."""
    from daala_tpu_torch.models.pvqsearch import band_search as search
    cpu = lambda v: v.cpu() if torch.is_tensor(v) else v
    if any(o.device.type != "cuda" for _, _, out in calls for o in out):
        raise AssertionError("a captured band_search call ran off the card")
    total = off = 0
    t0 = time.perf_counter()
    for label, (args, kw, out) in zip(labels, calls):
        d = rows_differing(torch, [cpu(o) for o in out],
                           search(*map(cpu, args),
                                  **{k: cpu(v) for k, v in kw.items()}))
        print("lean replay %s: band_search n=%d, %d rows: %d differ between "
              "the card and the CPU" % (label, args[9], out[0].shape[0], d))
        total += out[0].shape[0]
        off += d
    print("lean replay: %d of %d rows differ over %d calls (%.1f s)"
          % (off, total, len(calls), time.perf_counter() - t0))
    if off or not calls:
        raise AssertionError("band_search on the card differs from its CPU "
                             "replay on %d of %d rows" % (off, total))


def phase_band_acos(torch, dev):
    """The prologue kernel's arccos alone against acos_xla on the card,
    on every float32 c in [-1, 1].  For information, beside it: where
    CUDA's own atan2f (torch.atan2 on the card), which the kernels do not
    take, parts from acos_xla, and where theta_q parts with it."""
    import platform
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    one, chunk, sign = 0x3F800000, 1 << 26, 1 << 31
    n = off = native = native_tq = 0
    t0 = time.perf_counter()
    for neg in (0, sign):
        for u0 in range(0, one + 1, chunk):
            cnt = min(chunk, one + 1 - u0)
            c = torch.arange(u0 - neg, u0 + cnt - neg, dtype=torch.int64,
                             device=dev).to(torch.int32).view(torch.float32)
            got, want = BK.acos_xla_cuda(c), BK.acos_xla(c)
            off += int((got.view(torch.int32) != want.view(torch.int32))
                       .sum())
            cuda = torch.atan2(torch.sqrt((1.0 - c) * (c + 1.0)), c)
            part = cuda.view(torch.int32) != want.view(torch.int32)
            native += int(part.sum())
            tq = [torch.floor(BK._fma32(a[part], BK._THETA_C, 0.5))
                  for a in (cuda, want)]
            native_tq += int((tq[0] != tq[1]).sum())
            n += cnt
    torch.cuda.synchronize()
    print("band acos: host C library %s; CUDA's atan2f differs from "
          "acos_xla at %d of %d c, theta_q at %d [information only]"
          % (platform.libc_ver(), native, n, native_tq))
    print("band acos: the kernel's arccos against acos_xla on the card: %d "
          "of %d float32 c in [-1, 1] differ (%.1f s)"
          % (off, n, time.perf_counter() - t0))
    if off or n != 2 * (one + 1):
        raise AssertionError("the kernel's arccos differs from acos_xla on "
                             "%d of %d c" % (off, n))


def ok_candidates(args):
    """The candidates of an epilogue call that the prologue marked ok
    (ci[2]): the only ones that can win."""
    return int((args[4][2] != 0).sum())


def band_bytes(name, args):
    """Bytes of band_prologue or band_epilogue on its arguments.

    The prologue reads each row's n gathered coefficients (and, inter,
    reference coefficients) and its descriptors (base, table id,
    quantizer, beta: 13 bytes) once, the gather and QM tables once, and
    writes the distinct pulse-search rows (n float32: inter the
    reflected row and x16, keyframe x16), the C candidates' 11 fields
    (44 bytes) and the row's 3 (12 bytes).  The lane flags and each
    candidate's row index follow from the candidate, n and m, so they
    are not counted.  The epilogue reads every candidate's ok flag (4
    bytes) and, of the ok ones (ok_candidates, from the call's own
    flags), the pulses (n int32), cos_dist and the pulse search's ok (5
    bytes) and the 8 other fields the cost takes (32 bytes: ci[0, 1, 3,
    4], cf[1:5]), the row's 3 fields, the CDF and node tables once, and
    writes 6 int32, n int16 and a float32 a row."""
    if name == "band_prologue":
        _, _, base, _, tab, _, _, _, _, n, kf = args
        m, T = base.shape[0], tab.shape[0]
        C, G = (2, 1) if kf else (14, 2)
        return (m * n * 4 * G + 13 * m + 8 * T * n + G * m * n * 4
                + 44 * C * m + 12 * m)
    y_c, _, _, _, ci, _, _, n, k1, sp, _ = args
    C, m = ci.shape[1:]
    tables = (k1.numel() + sp.numel()) * 4 if k1 is not None else 0
    return (4 * C * m + ok_candidates(args) * (n * 4 + 5 + 32) + 12 * m
            + tables + 16 * (2 * n - 3) + m * (24 + 2 * n + 4))


def band_work_floor(name, args):
    """(bytes, int32 operations) of the count that the first design of
    the band kernels took for their bound, kept to compare: the bytes of
    band_bytes but, in the epilogue, every candidate's pulses, cos_dist,
    ok and 11 fields; per lane 12 (keyframe) or 36 (inter) and per
    candidate 60 in the prologue; per candidate 3 n and 8 per node of
    its tree in the epilogue, a floor that leaves out the nodes that
    code, the scalar chains and every float operation."""
    nbytes = band_bytes(name, args)
    if name == "band_prologue":
        _, _, base, _, _, _, _, _, _, n, kf = args
        m = base.shape[0]
        C, G = (2, 1) if kf else (14, 2)
        return nbytes, int(m * n * (12 if kf else 36) + G * m * n
                           + C * m * 60)
    _, _, _, _, ci, _, _, n, _, _, _ = args
    C, m = ci.shape[1:]
    nbytes += (C * m - ok_candidates(args)) * (n * 4 + 5 + 32) + 8 * C * m
    return nbytes, int(C * m * (3 * n + 8 * (2 * n - 1)))


# The band kernels' operations, (int32, float32) of each step, counted
# in csrc/band_row.cuh at the least instruction sequence that computes
# it: a product of 32-bit operands to 64 bits one multiply, an int64 add,
# subtract or compare two int32 operations, a shift of an int64 by a
# constant two and by a variable four, a float32 operation one and a
# fused multiply-add two, a float32 division eight (a reciprocal, its
# two Newton steps and the corrected quotient), a square root six, a
# float64 operation twice a float32 one.
# - XLA's log (br::log): 33 float32 (the exponent's conversion and add,
#   the mantissa's test and two adds, x^2 and x^3, nine FMAs, e q1, the
#   last FMA, add and FMA) and 3 int32 (the bit fields).
# - floordiv_q: 5 int32 (the remainder's multiply and subtract, two
#   tests) and 22 float32 (two conversions, the float64 division and
#   floor, each twice a float32 one).
# - glibc's atan2f as the prologue reaches it: 69 float32 (the square
#   root and its argument, 9; the reduction's division and adds, 10;
#   the polynomial, 22 products and adds, then 3; the quotient y / x,
#   8; the quadrant's 3; the rest's compares) and 10 int32.
BAND_OPS = {
    # Epilogue: a pulse of a tree's lanes (its magnitude, the prefix
    # sum's int64 add); a node that spans lanes (its pulse count, a
    # difference of int64 prefix sums, and its two tests); a node that
    # codes (its CDF indices: a k = 1 leaf's offset and position, a
    # split's count, bit length, shift, symbol, context and clamps, 12;
    # two logs; the three CDF values converted, their range and two
    # clamps, 6; its cost, three at the least; its add into the sum);
    # a candidate (the rate plus the theta rate, its distortion and
    # two costs, 16; its step of the row's selection, 4).
    "epi_lane": (3, 0), "epi_node": (4, 0),
    "epi_coding": (12 + 2 * 3, 6 + 2 * 33 + 3 + 1), "epi_cand": (4, 16),
    # Prologue, per lane: keyframe 12 (the gather's add and compares, the
    # QM product and shift, the squares and their sums), inter 24 more
    # (the reference's, the correlation, the largest lane, the
    # reflection's product, shift and wrap, the deletion); per
    # pulse-search lane written, its conversion.
    "pro_lane_kf": (12, 0), "pro_lane_inter": (36, 0), "pro_out": (1, 0),
    # A gain (od_sqrt's bit length, shifts and rsqrt_norm, 48; the
    # rounded shift, 5) and its companding at beta 1 (256 g + q0 / 2,
    # 3, and floordiv_q) or 1.5 (od_pow: the bit length and shift, 5,
    # od_log2's five steps, 25, the beta product, 3, od_exp2, 31, the
    # shift 2, and floordiv_q).
    "gain": (53, 0), "compand_b1": (3 + 5, 22), "compand_b15": (66 + 5, 22),
    # The rest of a keyframe row's chain (the shift, dist0) and an inter
    # row's: both shifts, the reference gain's split, 10 + 5; the
    # correlation's shift, 3, and division and clamp, 15; the skip and
    # initial distortions, 17; the reflection (the bump, 6, od_rcp, 27,
    # the shifts, 23); theta_on and the theta's terms, 8 and 7; the
    # arccos (atan2f above); theta_q's FMA, floor and conversion, 4.
    "row_kf": (5, 3), "row_inter": (15 + 3 + 56 + 8 + 10, 15 + 17 + 7
                                    + 69 + 4),
    # A theta candidate: its gain, 5; max_theta, 6; the bounds' two
    # floors, FMA, add and ceiling, 7 float32 and 3 int32; the theta
    # sines and cosines (pvq_cos, 15 int32 and 3 float32 each, four);
    # compute_theta twice (a clamp and the dividend, 4, and
    # floordiv_q); k_theta twice, 12; the gate and ok, 8; g2, dth and
    # its conversions, 10; the theta rate (a log, its clamp, conversion
    # and FMA, 4).  A noref candidate: its gain, 5; k_noref, 12; dth's
    # pvq_cos; ok, 4; its distortions and conversions, 9; the theta
    # rate.
    "cand_theta": (5 + 6 + 3 + 4 * 15 + 2 * (4 + 5) + 12 + 8 + 3,
                   7 + 4 * 3 + 2 * 22 + 10 + 33 + 4),
    "cand_noref": (5 + 12 + 15 + 4 + 3, 3 + 9 + 33 + 4),
}


def coding_nodes(y_c, ok, n, C):
    """The nodes that code over the ok candidates (ok: (C, m) bool) of an
    epilogue call whose pulses are y_c (C m, n): the plain version's masks
    (band_kernels._codeword_rate) on the call's own pulses."""
    import torch
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    y, ok = y_c.cpu().view(C, -1, n), ok.cpu()
    total = 0
    for nt, part, keep in ((n - 1, y[:C - 2], ok[:C - 2]),
                           (n, y[C - 2:], ok[C - 2:])):
        if not keep.any() or nt < 2:
            continue
        tg = BK._tree_tensors(nt, 1, "cpu")
        ya = part.reshape(-1, n)[keep.reshape(-1), :nt].abs().long()
        csum = torch.cat([torch.zeros_like(ya[:, :1]), ya.cumsum(-1)], -1)
        base, size = tg["base"], tg["size"]
        for rows in torch.split(csum, 1 << 14):
            k = rows[:, base + size] - rows[:, base]
            term = ((k == 1) & (size <= 16)[None, :]) | (k == 0)
            blocked = (term.double() @ tg["anc"]) > 0.5
            total += int(((~blocked) & (k > 0) & (size > 1)[None, :]).sum())
    return total


def band_work(name, args):
    """(bytes, {rate: operations}) of band_prologue or band_epilogue on
    its arguments: the bytes of band_bytes, the int32 and float32
    operations of BAND_OPS's steps.  The epilogue's steps are counted
    over the ok candidates only (the others cost their flag's test), its
    nodes that code from the call's own pulses (coding_nodes); every
    other node of an ok candidate costs its flags.  The prologue's rows take their own gains'
    companding (beta 1 or 1.5, from the call's flags).  Not counted:
    loads from shared memory, branches, the selection's row outputs and
    the fast rate model's sums (no CDF tables: each lane's product and
    add counted instead)."""
    nbytes = band_bytes(name, args)
    ops = np.zeros(2)
    O = {k: np.array(v, float) for k, v in BAND_OPS.items()}
    if name == "band_prologue":
        _, _, base, _, _, _, _, beta15, _, n, kf = args
        m = base.shape[0]
        b15 = int(beta15.sum())
        gains = 1 if kf else 2
        ops += m * n * O["pro_lane_kf" if kf else "pro_lane_inter"]
        ops += (1 if kf else 2) * m * n * O["pro_out"]
        ops += gains * (m * O["gain"] + (m - b15) * O["compand_b1"]
                        + b15 * O["compand_b15"])
        ops += m * O["row_kf" if kf else "row_inter"]
        ops += 2 * m * O["cand_noref"] + (0 if kf else 12 * m
                                          * O["cand_theta"])
    else:
        y_c, _, _, _, ci, _, _, n, k1, _, _ = args
        C, m = ci.shape[1:]
        ok = ci[2] != 0
        ok_th, ok_nr = int(ok[:C - 2].sum()), int(ok[C - 2:].sum())
        lanes = ok_th * (n - 1) + ok_nr * n
        ops += (ok_th + ok_nr) * O["epi_cand"] + C * m * np.array([1.0, 0])
        if k1 is None:
            ops += lanes * np.array([1.0, 2.0])
        else:
            nodes = ok_th * max(n - 2, 0) + ok_nr * (n - 1)
            ops += lanes * O["epi_lane"] + nodes * O["epi_node"]
            ops += coding_nodes(y_c, ok, n, C) * O["epi_coding"]
    return nbytes, {"ops_per_s": int(ops[0]), "flops_per_s": int(ops[1])}


def pulse_work(args):
    """(bytes, ops, "flops_per_s", longest trip count) of pulse_search on
    its arguments `args` (xc, k, g2, lam, lane_ok, iters[, src]).

    Bytes: xc (float32) and lane_ok (bool) of every lane of their rows,
    and k, g2 and src (when given) of every searched row, read once, the
    two tables read once, y (int32) of every lane and cos_dist and ok of
    every searched row written once.

    Operations: float32 operations from the code, a fused multiply-add
    counted as 2.  The prologue: per lane 17 (the magnitude; x.x, |x|_1,
    x.y, y.y and the pulse count; the init's product, quotient, floor
    and clamp; the rate penalty's four), per row 17 (norm_1's sum and
    rsqrt, the estimate and two Newton steps of 6, lamr's sum and
    quotient; the chunk sums of long rows not counted).  The steps that
    these rows take (each row min(iters, ceil(kf - i)) of them after
    the init, the first ones scoring the correlation, those from i >= kf
    - rdo_pulses on the rate penalised score): per lane and step 7
    (txy, tyy's three, the square, the division, the comparison of the
    argmax) or 9 (txy, tyy's three, 2 txy norm_1's two, the fused
    multiply-add, the comparison); the Newton steps of lanes past the
    table are not counted, so this is a least count; per row and step 5
    for the update.  The epilogue: per lane the sign, per row cos_dist's
    product and rsqrt (14).  The trip counts come from the plain
    version's loop arguments on these inputs."""
    from daala_tpu_torch.ops.cuda import pulse_kernels as PK
    xc, k, iters = args[0], args[1], args[5]
    src = args[6] if len(args) > 6 else None
    rows, n = xc.shape
    m = k.shape[0]
    nbytes = (rows * n * 5 + m * (8 if src is None else 12) + 16 * 4
              + 2048 * 4 + m * n * 4 + m * 5)
    loop = []
    real = PK.pulse_loop_plain
    PK.pulse_loop_plain = lambda *a: loop.append(a) or real(*a)
    try:
        PK.pulse_search_plain(*args)
    finally:
        PK.pulse_loop_plain = real
    _, _, _, _, i, kf, rdo = loop[0][:7]
    kf, i, rdo = (t.double().cpu().numpy() for t in (kf, i, rdo))
    trips = np.minimum(iters, np.maximum(0.0, np.ceil(kf - i)))
    p2 = np.maximum(0.0, trips - np.maximum(0.0, np.ceil(kf - rdo - i)))
    ops = (n * (7 * (trips - p2).sum() + 9 * p2.sum()) + 5 * trips.sum()
           + m * (18 * n + 31))
    return nbytes, int(ops), "flops_per_s", int(trips.max(initial=0))


def sad_work(shape, r, nv, nh):
    """(bytes, ops) of sad_fields on a (vh, vw) tile: the tile and its
    reference window read once, the (noff, nv, nh) int32 fields written
    once; one int32-lane instruction per 4 byte differences (a
    vabsdiff4 with its accumulation: 4 differences, magnitudes and
    sums), noff x vh x vw differences."""
    vh, vw = shape
    noff = (2 * r + 1) ** 2
    nbytes = vh * vw + (vh + 2 * r) * (vw + 2 * r) + 4 * noff * nv * nh
    return nbytes, noff * vh * vw // 4


def sad_tile_cases(cur, ref_padded, pad, vis, nvmvbs, nhmvbs, r, rows,
                   cols):
    """sad_fields' arguments for each tile of the fields cut over a (rows,
    cols) mesh as models/mefield.py fullpel_sad_fields cuts them: (label,
    current tile, reference window, nv, nh, oy, ox), numpy, the tiles
    with visible pixels."""
    from daala_tpu_torch.models import mefield as MF
    from daala_tpu_torch.parallel.sharding import Sharding
    nvb, nhb = nvmvbs // 8 + 1, nhmvbs // 8 + 1
    mesh = np.full((rows, cols), None, dtype=object)
    out = []
    for _, (rs, cs), (oy, ox), box in MF._window_tiles(
            vis, nvb, nhb, Sharding(mesh, ("dp", "sp"))):
        if box is None:
            continue
        out.append(("%dx%d tile, vertices %d:%d x %d:%d"
                    % (rows, cols, rs.start, rs.stop, cs.start, cs.stop),
                    np.ascontiguousarray(cur[box[0]:box[1], box[2]:box[3]]),
                    MF.tile_window(ref_padded, pad, r, box),
                    rs.stop - rs.start, cs.stop - cs.start, oy, ox))
    return out


def lean_encoder(info, device, **kw):
    from daala_tpu_torch.codec.encoder import Encoder
    return Encoder(info, device=device, use_device_analysis=False,
                   use_device_pvq=True, **kw)


def phase_lean(torch, dev, ref):
    """Phase 3c against phase 3's results `ref`; returns its bytes, its
    launches and, labelled by frame, the arguments of every pulse_search,
    band_prologue and band_epilogue call of its trace's keyframe and
    inter frame (one each per band_search call)."""
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
        for name in ("lap_frame", "dct_frame", "pulse_search",
                     "band_prologue", "band_epilogue", "sad_fields"):
            if snap["launches"].get(name, 0) <= 0:
                raise AssertionError("%s never launched in the lean tier"
                                     % name)
        per_call = {json.dumps(c[4], sort_keys=True) for c in calls}
        print("lean: kernel launches per band_search call (devstats), over "
              "its %d calls: %s" % (len(calls), sorted(per_call)))
        if per_call != {json.dumps({"band_epilogue": 1, "band_prologue": 1,
                                    "pulse_search": 1}, sort_keys=True)}:
            raise AssertionError("band_search did not run its three kernels "
                                 "once a call: %s" % sorted(per_call))
        if not snap["d2h_bytes"] < 0.5 * ref["d2h_bytes"]:
            raise AssertionError("lean d2h %d bytes not under half of %d"
                                 % (snap["d2h_bytes"], ref["d2h_bytes"]))
        # Launches per band_search call, from utils/profile.py's trace
        # of a fresh encoder's keyframe and first inter frame (it prints
        # each call's launches and device time); here each call gets its
        # band length and rows.
        del calls[:]
        os.makedirs(BUILD, exist_ok=True)
        pulse, band, io = [], [], []
        stop = watch_pulse_search(pulse)
        stop_band = watch_band_kernels(band)
        stop_io = watch_io(io)
        try:
            res = traced(frames, dev, BUILD, False, lean=True)
        finally:
            stop_io()
            stop_band()
            stop()
        work = [dict(frame=label, **w) for label in ("keyframe", "inter")
                for w in res[label]["band_search"]]
        labels = ([w["frame"] for w in work] if len(work) == len(pulse)
                  else ["call %d" % k for k in range(len(pulse))])
        if len(work) != len(calls):
            print("lean trace: %d band_search ranges for %d calls; "
                  "launches per call not read" % (len(work), len(calls)))
            work = []
        for (n, rows, _, _, _), w in zip(calls, work):
            print("lean trace %s: band_search n=%d, %d rows: %d launches, "
                  "device %.3f ms, host wall %.3f ms"
                  % (w["frame"], n, rows, w["launches"], w["device_ms"],
                     w["wall_ms"]))
    finally:
        restore()
    replay_on_cpu(torch, io, labels if len(labels) == len(io) else
                  ["call %d" % k for k in range(len(io))])
    band_labels = [lab for lab in labels for _ in range(2)]
    if len(band) != len(band_labels):
        band_labels = ["call %d" % (k // 2) for k in range(len(band))]
    return dict(bytes=nbytes, launches=snap["launches"],
                pulse_calls=list(zip(labels, pulse)),
                band_calls=[(lab,) + c for lab, c in zip(band_labels, band)])


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


def phase_search_kernels(torch, dev, res, pulse_calls, band_calls):
    """Phase 2d: pulse_search, band_prologue and band_epilogue on the
    arguments of phase 3c's traced band_search calls (`pulse_calls`,
    `band_calls`, labelled), and sad_fields on the 1080p translation
    pair, as one tile and as the 2 x 2 tiles of phase 9's mesh, against
    their plain versions on the card."""
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    from daala_tpu_torch.ops.cuda import pulse_kernels as PK
    if not pulse_calls or not band_calls:
        raise AssertionError("phase 3c captured no pulse_search or band "
                             "kernel call")
    phase_band_acos(torch, dev)
    band_kernel_cases(torch, res, band_calls)
    for label, args in pulse_calls:
        n, m = args[0].shape[1], args[1].shape[0]
        nbytes, ops, rate, trips = pulse_work(args)
        record(torch, res, PK.KERNEL, "pulse_search %s n=%d, %d rows, "
               "longest %d trips" % (label, n, m, trips),
               lambda: PK.pulse_search_cuda(*args),
               lambda: PK.pulse_search_plain(*args), (nbytes, ops, rate),
               PK.KERNELS)
    sad_kernel_cases(torch, dev, res)


def band_kernel_cases(torch, res, band_calls, names=None):
    """band_prologue and band_epilogue against their plain versions on
    the card, bit for bit, on each captured call (label, name, args),
    timed, with the bound of band_work and, beside it, of the first
    design's count (band_work_floor).  names: the trace names of the
    kernels, by default the module's."""
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    for label, name, args in band_calls:
        kern, plain = ((BK.band_prologue_cuda, BK.band_prologue_plain)
                       if name == "band_prologue" else
                       (BK.band_epilogue_cuda, BK.band_epilogue_plain))
        case = band_case(label, name, args)
        work = band_work(name, args)
        record(torch, res, name, case, lambda: kern(*args),
               lambda: plain(*args), work, names or BK.KERNELS)
        floor_ms, floor_by = bound(*band_work_floor(name, args))
        print("bound: %-44s %.4f ms (%s) by this count; %.4f ms (%s) by "
              "the first design's count%s [information only]"
              % (case, bound(*work)[0], bound(*work)[1], floor_ms, floor_by,
                 "" if name == "band_prologue" else
                 "; ok candidates %s" % ok_share(args)))


def band_case(label, name, args):
    """The case name of a band kernel call (label, name, args)."""
    n = args[9] if name == "band_prologue" else args[7]
    m = (args[2] if name == "band_prologue" else args[5]).shape[-1]
    return "%s %s n=%d, %d rows" % (name, label, n, m)


def ok_share(args):
    """'k of C m (p%)': an epilogue call's ok candidates."""
    total = args[4].shape[1] * args[4].shape[2]
    k = ok_candidates(args)
    return "%d of %d (%.1f%%)" % (k, total, 100.0 * k / total)


def sad_kernel_cases(torch, dev, res, names=None):
    """sad_fields against its plain version on the 1080p translation pair
    at r = 16, as one tile and as the 2 x 2 tiles of phase 9's mesh.
    names: the trace names of its kernels, by default the module's."""
    from daala_tpu_torch.codec.mc import OD_BUFFER_PADDING as pad
    from daala_tpu_torch.ops.cuda import sad_kernels as SK
    from daala_tpu_torch.utils.profile import H, W, translation_clip
    frames = translation_clip(nframes=2)
    cur = frames[1][0]
    ref = np.pad(frames[0][0], pad, mode="edge")
    nvm, nhm = ((H + 31) // 32 * 32) >> 3, ((W + 31) // 32 * 32) >> 3
    r = 16
    for rows, cols in ((1, 1), (2, 2)):
        for label, c, win, nv, nh, oy, ox in sad_tile_cases(
                cur, ref, pad, (H, W), nvm, nhm, r, rows, cols):
            ct = torch.from_numpy(c).to(dev)
            wt = torch.from_numpy(win).to(dev)
            record(torch, res, SK.NAME, "sad_fields r=%d %dx%d, %s"
                   % (r, c.shape[1], c.shape[0], label),
                   lambda: SK.sad_fields_cuda(ct, wt, r, nv, nh, oy, ox),
                   lambda: SK.sad_fields_plain(ct, wt, r, nv, nh, oy, ox),
                   sad_work(c.shape, r, nv, nh), names or SK.KERNELS)
    torch.cuda.synchronize()


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
    counts and the host decoder's frames."""
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
    return snap["launches"], host


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
             is_keyframe=False, use_masking=True, device_put_fn=None):
        host = torch.device("cpu")
        cpu = real(st, info, quantizer, [p.to(host) for p in d_planes],
                   None if md_planes is None
                   else [p.to(host) for p in md_planes], lam,
                   is_keyframe=is_keyframe, use_masking=use_masking)()
        finish = real(st, info, quantizer, d_planes, md_planes, lam,
                      is_keyframe=is_keyframe, use_masking=use_masking,
                      device_put_fn=device_put_fn)

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
    with the sweep on the card, encoder check on; returns its bytes."""
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
    return sum(map(len, pk))


def phase_python_path(torch, dev):
    """Phase 10: the lean tier with the sweep on 4c's clip (640x368, 3
    frames, a keyframe every 2) through the Python coefficient path
    (use_native_frame = False), then through the native frame pass, each
    with a fresh encoder and the encoder check on; returns the Python
    run's launches."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.utils import devstats
    w, h = 640, 368
    frames = textured_clip(w, h, 3)
    info = headers.Info(pic_width=w, pic_height=h)
    runs = {}
    for name in ("python", "native"):
        enc = lean_encoder(info, dev, quant=25, complexity=7,
                           mv_refine_mode="sweep")
        enc.use_native_frame = name == "native"
        enc.keyframe_rate = 2
        enc.enable_encoder_check = True
        devstats.reset()
        t0 = time.perf_counter()
        pk = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
        pk += [bytes(p) for p in enc.flush()]
        torch.cuda.synchronize()
        runs[name] = (pk, time.perf_counter() - t0, devstats.snapshot())
    (py_pk, py_s, snap), (nat_pk, nat_s, nat) = (runs["python"],
                                                  runs["native"])
    print("python path %dx%d lean+sweep on %s: %d bytes (%.2f s), native "
          "frame pass %d bytes (%.2f s), packets %s; encoder check passed "
          "on both; forced_bands %d; launches %s, native run %s" % (
              w, h, dev, sum(map(len, py_pk)), py_s, sum(map(len, nat_pk)),
              nat_s, "identical" if py_pk == nat_pk else "differ",
              snap["counts"].get("forced_bands", 0), snap["launches"],
              nat["launches"]))
    if py_pk != nat_pk:
        bad = [i for i, (a, b) in enumerate(zip(py_pk, nat_pk)) if a != b]
        raise AssertionError("the Python path's packets differ from the "
                             "native pass's (%d vs %d packets; first "
                             "differing: %s)" % (len(py_pk), len(nat_pk),
                                                 bad[:3]))
    if snap["counts"].get("forced_bands", 0) <= 0:
        raise AssertionError("the Python path replayed no forced band")
    for name in ("lap_frame", "dct_frame", "obmc_leaf_cells"):
        if snap["launches"].get(name, 0) <= 0:
            raise AssertionError("%s never launched on the Python path"
                                 % name)
    return snap["launches"]


def _watch_directions(calls):
    """Replace lap_frame_cuda and dct_frame_cuda by wrappers that append
    (kernel name, forward) of every call to `calls`; returns the function
    that restores them."""
    from daala_tpu_torch.ops.cuda import dct_kernels as D, lap_kernels as LK
    real_lap, real_dct = LK.lap_frame_cuda, D.dct_frame_cuda

    def lap(frame, sb_x=64, sb_y=64, forward=True, *tile):
        calls.append((LK.NAME, bool(forward)))
        return real_lap(frame, sb_x, sb_y, forward, *tile)

    def dct(frame, n, forward=True, *tile):
        calls.append((D.NAME, bool(forward)))
        return real_dct(frame, n, forward, *tile)
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
    PM.batch_encode_step(torch.from_numpy(frames[:1]).to(dev))  # warm-up
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
    want = PM.batch_encode_step(torch.from_numpy(frames))
    cpu_s = time.perf_counter() - t0
    got = torch.from_numpy(rec.gather())
    if not (torch.equal(got, want[0]) and (sse, nz) == want[1:]):
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
    return snap["launches"], dict(frames=frames, rec=got.numpy(), sse=sse,
                                  nz=nz, wall=card_s)


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
    return total, dict(clips=clips, serial=serial)


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


def phase_train_zigzag(torch, dev):
    """Phase 8a: train.zigzag.measure_mags over bench.py's two 1080p clips
    (luma, 4 frames each, cropped to 1024x1920) for n = 4..64 on the
    card and on the CPU: equal mags bit for bit, equal gen_zigzag
    tables; one lap_frame and one dct_frame launch per frame and n.
    Returns the card run's launches."""
    from daala_tpu_torch.train import zigzag as ZZ
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import (H, NFRAMES, W,
                                               make_natural_clip,
                                               translation_clip)
    frames = [f[0] for f in translation_clip()] + [
        f[0] for f in make_natural_clip(W, H, NFRAMES, seed=3)]
    sizes = (4, 8, 16, 32, 64)
    ZZ.measure_mags(frames[:1], 8, dev)  # warm-up
    torch.cuda.synchronize()
    devstats.reset()
    t0 = time.perf_counter()
    card = {n: ZZ.measure_mags(frames, n, dev) for n in sizes}
    card_s = time.perf_counter() - t0
    snap = devstats.snapshot()
    t0 = time.perf_counter()
    cpu = {n: ZZ.measure_mags(frames, n, "cpu") for n in sizes}
    cpu_s = time.perf_counter() - t0
    for n in sizes:
        if not np.array_equal(card[n], cpu[n]):
            raise AssertionError("measure_mags n=%d: card and cpu differ "
                                 "(max |diff| %g)" % (
                                     n, np.abs(card[n] - cpu[n]).max()))
        if not np.array_equal(ZZ.gen_zigzag(card[n]),
                              ZZ.gen_zigzag(cpu[n])):
            raise AssertionError("gen_zigzag n=%d: tables differ" % n)
    want = len(frames) * len(sizes)
    for name in ("lap_frame", "dct_frame"):
        if snap["launches"].get(name, 0) != want:
            raise AssertionError("measure_mags: %s launched %s times, not %d"
                                 % (name, snap["launches"].get(name), want))
    print("train zigzag: %d frames (%dx%d luma of the translation and "
          "natural clips), n = %s: mags equal bit for bit on %s and cpu, "
          "gen_zigzag tables equal; %s wall %.4f s, cpu %.4f s; launches %s; "
          "h2d %d bytes, d2h %d bytes" % (
              len(frames), H // 64 * 64, W // 64 * 64, list(sizes), dev, dev,
              card_s, cpu_s,
              snap["launches"], snap["h2d_bytes"], snap["d2h_bytes"]))
    return snap["launches"]


def vq_data(rng, rows=1 << 20, dims=16, clusters=512, noise=0.3):
    """(rows, dims) float64 unit vectors: `clusters` random centres, each
    row one of them (drawn uniformly) plus Gaussian noise."""
    from daala_tpu_torch.train import vq
    centres = rng.normal(size=(clusters, dims))
    x = centres[rng.integers(0, clusters, rows)]
    x += noise * rng.normal(size=(rows, dims))
    return vq._normalize(x)


def phase_train_vq(torch, dev):
    """Phase 8b: train.vq on 2^20 unit vectors of 16 dims (512 clusters
    with noise, from the seed), 256 entries, on the card.  One step
    against _step_np on the same float32 inputs (in float64): assignments
    equal on >= 99.99% of rows, rms within 1e-5 relative, codebook
    within 1e-4.  Then 20 iterations of train(), twice: rms falls, the
    two codebooks and histories are identical.  Prints the device time
    of a step from a torch.profiler trace."""
    from daala_tpu_torch.train import vq
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the k-means step needs "
                             "full float32")
    rng = np.random.default_rng(SEED)
    data = vq_data(rng)
    entries, iters = 256, 20
    cb = vq._normalize(data[rng.integers(0, len(data), entries)]
                       + 0.01 * rng.integers(-1, 2, (entries, 16)))
    d32, c32 = data.astype(np.float32), cb.astype(np.float32)
    step = vq._make_step_torch(True, dev)
    td, tc = torch.from_numpy(d32).to(dev), torch.from_numpy(c32).to(dev)
    got_cb, got_rms, got_best = step(td, tc)
    got_cb, got_rms = got_cb.cpu().numpy(), float(got_rms)
    got_best = got_best.cpu().numpy()
    d64, c64 = d32.astype(np.float64), c32.astype(np.float64)
    want_cb, want_rms = vq._step_np(d64, c64, True)
    want_best = np.argmax(np.abs(d64 @ c64.T), axis=1)
    agree = float(np.mean(got_best == want_best))
    cb_err = float(np.abs(got_cb - want_cb).max())
    rms_rel = abs(got_rms - want_rms) / want_rms
    print("train vq: one step, %d x 16 float32, %d entries: assignments "
          "equal on %.6f of rows (%d differ), rms %.8f vs numpy %.8f (rel "
          "%.3g), codebook max |diff| %.3g" % (
              len(data), entries, agree, int((got_best != want_best).sum()),
              got_rms, want_rms, rms_rel, cb_err))
    if agree < 0.9999 or rms_rel > 1e-5 or cb_err > 1e-4:
        raise AssertionError("the k-means step on %s disagrees with numpy"
                             % dev)
    per_kernel = {}
    ms, events, calls = trace_ms(torch, lambda: step(td, tc), ("",),
                                 calls=10, flush=False, detail=per_kernel)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
    print("train vq: a step's largest kernels (ms per step): %s" % "; ".join(
        "%s %.4f" % (k[:60], v) for k, v in top))
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(vq.train(data, entries, iters, exclude_pvq=True,
                             seed=SEED, device=dev))
        runs[-1] += (time.perf_counter() - t0,)
    (cb1, hist1, s1), (cb2, hist2, s2) = runs
    same = np.array_equal(cb1, cb2) and hist1 == hist2
    print("train vq: %d iterations on %s: rms %s; walls %.4f, %.4f s (with "
          "the upload); device time per step %s ms (%d kernel events in %d "
          "steps, torch.profiler); two card runs identical: %s" % (
              iters, dev, ["%.6f" % r for r in hist1], s1, s2,
              "%.4f" % ms if ms is not None else "not measured", events,
              calls, same))
    if not hist1[-1] < hist1[0]:
        raise AssertionError("vq rms did not fall: %s" % hist1)
    if not same:
        raise AssertionError("two card runs of vq.train differ")


def phase_train_gain(torch, dev):
    """Phase 8c: train.gain.search, (n 4, filt 4) and (n 8, filt 8), 400
    Adam steps, on the card and on the CPU: equal polished integer
    parameters, float_cg within 1e-4 dB.  Walls as information (tiny
    linear algebra, launch-bound)."""
    from daala_tpu_torch.train import gain
    for n, filt in ((4, 4), (8, 8)):
        t0 = time.perf_counter()
        best, cg, fcg = gain.search(n, filt, steps=400, device=dev)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cbest, ccg, cfcg = gain.search(n, filt, steps=400, device="cpu")
        cpu_s = time.perf_counter() - t0
        print("train gain: n %d filt %d, 400 steps: %s %s cg %.6f dB (float "
              "%.6f), cpu %s cg %.6f (float %.6f); walls %s %.3f s, cpu %.3f "
              "s [information only]" % (n, filt, dev, best, cg, fcg, cbest,
                                        ccg, cfcg, dev, card_s, cpu_s))
        if best != cbest or abs(fcg - cfcg) > 1e-4:
            raise AssertionError("gain.search n=%d filt=%d: card and cpu "
                                 "differ" % (n, filt))


def phase_sweep_quality(torch, dev):
    """Phase 8d: utils/sweep_quality.py's device_pvq on the natural class,
    seed 0, quants 12, 25, 40, 60, at 320x192 with 2 frames on the card
    (BD-rate and time ratio as information); the candidate's packets at
    quant 25 equal on the card and on the CPU."""
    from daala_tpu_torch.utils import sweep_quality as SQ
    w, h, nframes = 320, 192, 2
    t0 = time.perf_counter()
    row, = SQ.sweep_bd("device_pvq", ["natural"], [0], [12, 25, 40, 60], w,
                       h, nframes, device=dev)
    secs = time.perf_counter() - t0
    frames = SQ.make_natural_clip(w, h, nframes, seed=0)
    _, c_kw, _, c_cx = SQ.CONFIGS["device_pvq"]
    card, _ = SQ.encode_clip(frames, w, h, 25, c_kw, c_cx, dev)
    cpu, _ = SQ.encode_clip(frames, w, h, 25, c_kw, c_cx, "cpu")
    print("sweep quality: device_pvq, natural, seed 0, %dx%d, %d frames on "
          "%s: BD-rate %.3f%%, time vs anchor %.3f (%.1f s) [information "
          "only]; quant 25 candidate %d bytes on %s, %d on cpu" % (
              w, h, nframes, dev, row["bd_rate_mean_pct"],
              row["time_vs_anchor_mean"], secs, sum(map(len, card)), dev,
              sum(map(len, cpu))))
    if not np.isfinite(row["bd_rate_mean_pct"]):
        raise AssertionError("device_pvq BD-rate is not finite")
    if card != cpu:
        raise AssertionError("device_pvq quant 25: card packets differ from "
                             "the cpu run's")


def _same_frames(got, want, what):
    if len(got) != len(want):
        raise AssertionError("%s: %d frames, not %d" % (what, len(got),
                                                        len(want)))
    for i, (a, b) in enumerate(zip(got, want)):
        for pli in range(3):
            if not np.array_equal(a[pli], b[pli]):
                raise AssertionError("%s: frame %d plane %d differs"
                                     % (what, i, pli))


def _add_launches(total, snap):
    sum_launches(total, snap["launches"])


def phase_sharded(torch, dev, ref, batch_ref, clips_ref):
    """Phase 9: the mesh's sp axis on a 2 x 2 mesh of the card (see the
    module docstring); returns the launches of its sharded paths."""
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.decoder import Decoder
    from daala_tpu_torch.codec.encoder import Encoder
    from daala_tpu_torch.ops.cuda import dct_kernels as D, lap_kernels as LK
    from daala_tpu_torch.parallel import mesh as PM
    from daala_tpu_torch.parallel.sharding import Sharding, named_put, put
    from daala_tpu_torch.utils import devstats
    from daala_tpu_torch.utils.profile import (ENCODER_KW as kw, H, W,
                                               translation_clip)
    info = headers.Info(pic_width=W, pic_height=H)
    mesh = PM.make_mesh(devices=[str(dev)] * 4, dp=2)
    hook = named_put(mesh, ("dp", "sp"))
    frames = translation_clip()[:2]
    total = {}

    # 9a: the keyframe and one P frame, the analysis tier sharded.
    plain_pk, plain_s = encode(Encoder(info, device=dev, **kw), frames)
    if plain_pk != ref["packets"][:2]:
        raise AssertionError("the unsharded 2-frame encode differs from "
                             "phase 3's first packets")

    def sharded_encode(h):
        enc = Encoder(info, device=dev, **kw)
        enc.device_put_fn = h
        devstats.reset()
        pk, secs = encode(enc, frames)
        torch.cuda.synchronize()
        return pk, secs, devstats.snapshot()

    pk, enc_s, snap = sharded_encode(hook)
    _add_launches(total, snap)
    if pk != plain_pk:
        raise AssertionError("9a: sharded packets differ from the unsharded "
                             "card encode's (%d vs %d bytes)"
                             % (sum(map(len, pk)), sum(map(len, plain_pk))))
    for name in ("lap_frame", "dct_frame"):
        if snap["launches"].get(name, 0) <= 0:
            raise AssertionError("9a: %s never launched" % name)
    print("sharded 9a: keyframe + P frame at %dx%d on a (2, 2) mesh of %s, "
          "analysis tier sharded (dp, sp): %d bytes, byte-identical to the "
          "unsharded card encode (= phase 3's first 2 packets), encoder "
          "check passed; wall per frame sharded %.4f s, unsharded %.4f s "
          "[information only]; halo bytes per frame %d (the analysis takes "
          "its halos with the upload); h2d %d, d2h %d bytes; launches %s"
          % (W, H, dev, sum(map(len, pk)), enc_s / 2, plain_s / 2,
             snap["counts"].get("halo_bytes", 0) // 2, snap["h2d_bytes"],
             snap["d2h_bytes"], snap["launches"]))

    # 9b: those packets through the sharded synthesis.
    host = Decoder(info, use_device_synthesis=False)
    want = [f for p in pk for f in host.decode_packet(p)]
    dec = Decoder(info, device=dev)
    dec.device_put_fn = hook
    devstats.reset()
    t0 = time.perf_counter()
    got = [f for p in pk for f in dec.decode_packet(p)]
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    snap = devstats.snapshot()
    _add_launches(total, snap)
    _same_frames(got, want, "9b: the sharded decode against the host's")
    for name in ("lap_frame", "dct_frame"):
        if snap["launches"].get(name, 0) <= 0:
            raise AssertionError("9b: %s never launched" % name)
    print("sharded 9b: the sharded synthesis decode gives the host "
          "decoder's frames; wall per frame %.4f s; halo bytes per frame "
          "%d; synthesize_frame span %.4f s; launches %s"
          % (dec_s / 2, snap["counts"].get("halo_bytes", 0) // 2,
             snap["spans_s"].get("synthesize_frame", 0.0),
             snap["launches"]))

    # 9c: every tile's kernels against their plain versions (not counted).
    rng = np.random.default_rng(SEED)
    ntiles = 0
    for (h, w), sb, sizes in (((1088, 1920), 64, (4, 8, 16, 32, 64)),
                              ((544, 960), 32, (4, 8, 16, 32))):
        x = rng.integers(-(1 << 14), 1 << 14, (h, w)).astype(np.int32)
        sp = put(x, Sharding(mesh, ("dp", "sp")), halo=2, unit=sb)
        for fwd in (True, False):
            whole = LK.lap_frame_cuda(torch.from_numpy(x).to(dev), sb, sb,
                                      fwd).cpu().numpy()
            for t in sp.tiles:
                k = LK.lap_frame_cuda(t.data, sb, sb, fwd, t.origin, t.plane)
                if not torch.equal(k, LK.lap_frame_plain(
                        t.data, sb, sb, fwd, t.origin, t.plane)):
                    raise AssertionError("9c: lap_frame differs from its "
                                         "plain version on the tile at %s"
                                         % (t.start,))
                if not np.array_equal(t.crop(k).cpu().numpy(),
                                      whole[t.slices()]):
                    raise AssertionError("9c: lap_frame on the tile at %s "
                                         "differs from the plane's"
                                         % (t.start,))
                inner = t.crop()
                for n in sizes:
                    if not torch.equal(
                            D.dct_frame_cuda(inner, n, fwd, t.start),
                            D.dct_frame_plain(inner, n, fwd)):
                        raise AssertionError("9c: dct_frame n=%d differs on "
                                             "the tile at %s" % (n, t.start))
                ntiles += 1
        # The first tile's forward filter as the sharded path cuts it (a
        # halo of 2: a width of 2 mod 4, 4-byte copies) and with a halo of
        # 4 (16-byte copies), the rejected alternative.
        times = []
        for halo in (2, 4):
            t = put(x, Sharding(mesh, ("dp", "sp")), halo=halo,
                    unit=sb).tiles[0]

            def fn(t=t):
                return LK.lap_frame_cuda(t.data, sb, sb, True, t.origin,
                                         t.plane)
            times.append((halo, "x".join(map(str, t.data.shape)),
                          batch_ms(torch, fn),
                          trace_ms(torch, fn, LK.KERNELS)[0],
                          bound(*lap_work(*t.data.shape, sb, True))))
        print("sharded 9c: %dx%d in %d tiles (%s); lap_frame forward on the "
              "first tile %s [information only]"
              % (h, w, len(sp.tiles), [tuple(t.data.shape) for t in sp.tiles],
                 "; ".join("halo %d, %s: wrapper %.4f ms, device %s ms, bound "
                           "%.5f ms (%s)" % (hl, shape, ms,
                                             "%.5f" % d if d else "none",
                                             b[0], b[1])
                           for hl, shape, ms, d, b in times)))
    torch.cuda.synchronize()
    print("sharded 9c: lap_frame forward and inverse and dct_frame at every "
          "size on each of %d tile passes equal their plain versions bit for "
          "bit, and the tiles' lap_frame the plane's" % ntiles)

    # 9d: two 1080p clips on the (2, 2) mesh, each over its row's columns.
    clips = [c[:2] for c in clips_ref["clips"]]
    serial = [c[:2] for c in clips_ref["serial"]]
    ekw = {k: v for k, v in kw.items() if k not in ("quant", "complexity")}
    walls = {}
    for threads in (False, True):
        devstats.reset()
        t0 = time.perf_counter()
        outs = PM.encode_clips_batched(
            clips, dict(pic_width=W, pic_height=H), mesh, quant=kw["quant"],
            complexity=kw["complexity"], enc_kwargs=ekw, threads=threads)
        torch.cuda.synchronize()
        walls[threads] = time.perf_counter() - t0
        snap = devstats.snapshot()
        _add_launches(total, snap)
        for ci in range(2):
            if [bytes(p) for p in outs[ci]] != serial[ci]:
                raise AssertionError("9d: clip %d (threads=%s) differs from "
                                     "its serial card encode" % (ci, threads))
    print("sharded 9d: encode_clips_batched of 2 clips x 2 frames at %dx%d "
          "on the (2, 2) mesh (each clip over its row's 2 columns) equal to "
          "serial card encodes in both schedules; walls round-robin %.2f s, "
          "threads %.2f s [information only]" % (W, H, walls[False],
                                                 walls[True]))

    # 9e: the uniform pipeline's batch over the 2 x 2 mesh.
    devstats.reset()
    t0 = time.perf_counter()
    rec, sse, nz = PM.batch_encode_step(
        PM.shard_batch(batch_ref["frames"], mesh))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    snap = devstats.snapshot()
    _add_launches(total, snap)
    if not (np.array_equal(rec.gather(), batch_ref["rec"])
            and (sse, nz) == (batch_ref["sse"], batch_ref["nz"])):
        raise AssertionError("9e: batch_encode_step over the (2, 2) mesh "
                             "differs from one device's")
    nb = len(batch_ref["frames"])
    print("sharded 9e: batch_encode_step of %s over the (2, 2) mesh equal to "
          "one device's (sse %d, nz %d); wall %.4f s, one device %.4f s "
          "[information only]; halo bytes per frame %d; launches %s"
          % (batch_ref["frames"].shape, sse, nz, step_s, batch_ref["wall"],
             snap["counts"].get("halo_bytes", 0) // nb, snap["launches"]))

    # 9f: across cards, only where there are several.
    n = torch.cuda.device_count()
    if n >= 2:
        cards = ["cuda:%d" % i for i in range(min(n, 4))]
        cross = named_put(PM.make_mesh(devices=cards), ("dp", "sp"))
        pk2, secs, snap = sharded_encode(cross)
        if pk2 != plain_pk:
            raise AssertionError("9f: packets sharded over %s differ" % cards)
        print("sharded 9f: 9a over %s: byte-identical; wall per frame %.4f s"
              % (cards, secs / 2))
    else:
        print("sharded 9f: did not run: torch sees %d CUDA device; the "
              "cross-card leg needs 2 or more [not a pass]" % n)
    print("sharded: launches of 9a, 9b, 9d and 9e %s" % total)
    return total


def run_json(args, timeout):
    """Run `python -m args...` from the checkout in a session of its own
    and return the JSON object on the last line of its output; on a
    timeout, kill the session (the command and every process it
    started) and raise."""
    import signal
    proc = subprocess.Popen([sys.executable, "-m"] + args, cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("%s: timed out (%d s)" % (args[0], timeout))
    if proc.returncode != 0 or not out.strip():
        raise AssertionError("%s: rc=%d %s" % (args[0], proc.returncode,
                                               err.strip()[-2000:]))
    return json.loads(out.strip().splitlines()[-1])


def phase_bench(torch, dev, checked):
    """Phase 11 against `checked`, the bytes of the translation clip's
    checked encode per configuration; returns each kernel's launches in
    the probe runs."""
    t0 = time.perf_counter()
    line = run_json(["daala_tpu_torch.bench"], 700)
    bench_s = time.perf_counter() - t0
    print(json.dumps(line))
    cfg = line["config"]
    launches = {}
    for name in ("analysis", "device", "device+sweep"):
        probe = cfg["probe"][name]
        if not isinstance(probe, dict):
            raise AssertionError("bench probe %s: %s" % (name, probe))
        need = ("lap_frame", "dct_frame", "sad_fields") + (
            ("obmc_leaf_cells",) if name == "device+sweep" else ()) + (
            ("pulse_search", "band_prologue", "band_epilogue")
            if name != "analysis" else ())
        for k in need:
            if probe["dev"]["launches"].get(k, 0) <= 0:
                raise AssertionError("bench probe %s: %s never launched"
                                     % (name, k))
        for k, v in probe["dev"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if not line["value"] > 0:
        raise AssertionError("bench headline %r" % line["value"])
    if set(cfg["per_content"]) != {"translation", "natural"}:
        raise AssertionError("bench contents %s" % sorted(cfg["per_content"]))
    got = cfg["per_content"]["translation"]["bytes"]
    if got != checked[cfg["name"]]:
        raise AssertionError("bench %s: translation clip %d bytes, checked "
                             "encode %d" % (cfg["name"], got,
                                            checked[cfg["name"]]))
    print("bench: %s chosen, %.4f Mpix/s, translation clip %d bytes == the "
          "checked encode's; probes %s; %.1f s"
          % (cfg["name"], line["value"], got,
             {n: round(p["mpix_s"], 4) for n, p in cfg["probe"].items()},
             bench_s))
    t0 = time.perf_counter()
    scaling = run_json(["daala_tpu_torch.utils.bench_scaling"], 400)
    print(json.dumps(scaling))
    if not (scaling["serial_s"] > 0 and scaling["threaded_s"] > 0):
        raise AssertionError("bench_scaling walls %r, %r"
                             % (scaling["serial_s"], scaling["threaded_s"]))
    print("bench_scaling: serial %.3f s, threaded %.3f s (%.3fx); %.1f s"
          % (scaling["serial_s"], scaling["threaded_s"], scaling["speedup"],
             time.perf_counter() - t0))
    return launches


CLI_DIR = os.path.join(HERE, "build", "cli")
# Phase 12c's modes, name: (frames, chroma, bit depth, the encoder's
# flags), each through tools/encode.py and tools/decode.py on the card
# and on the CPU.
CLI_MODES = {
    "b2_check": (4, "420", 8, ["-v", "12", "-b", "2", "--check"]),
    "bitrate": (4, "420", 8, ["--bitrate", "200000"]),
    "two_pass": (4, "420", 8, ["--bitrate", "200000"]),
    "lossless": (2, "420", 8, ["-v", "0", "-k", "1"]),
    "10bit": (3, "420", 10, ["-v", "12", "--check"]),
    "422": (3, "422", 8, ["-v", "12"]),
    "444": (3, "444", 8, ["-v", "12", "--check"]),
    "mono": (3, "mono", 8, ["-v", "12", "--check"]),
    "limit": (4, "420", 8, ["-v", "15", "--limit", "2"]),
    "z3": (3, "420", 8, ["-v", "15", "-z", "3"]),
    "seek": (8, "420", 8, ["-v", "15", "-k", "4"]),
    "device": (3, "420", 8, ["-v", "25", "--check", "--config", "device"]),
    "device+sweep": (3, "420", 8, ["-v", "25", "--check", "--config",
                                   "device+sweep"]),
    "workers": (32, "420", 8, ["-v", "15", "-k", "16", "--workers", "2"]),
}
CLI_SEEK = ["--seek", "0.2"]  # frame 6, after the keyframe at frame 4


def cli_frames(frames, chroma, depth):
    """4:2:0 8-bit frames in another layout: chroma rows (4:2:2) or rows
    and columns (4:4:4) repeated, no chroma (mono); at depth > 8 each
    sample shifted up with its own low bits below."""
    out = []
    for y, cb, cr in frames:
        planes = [y]
        if chroma == "420":
            planes += [cb, cr]
        elif chroma == "422":
            planes += [np.repeat(c, 2, 0) for c in (cb, cr)]
        elif chroma == "444":
            planes += [np.repeat(np.repeat(c, 2, 0), 2, 1) for c in (cb, cr)]
        if depth > 8:
            sh = depth - 8
            planes = [(p.astype(np.uint16) << sh) | (p & ((1 << sh) - 1))
                      for p in planes]
        out.append(planes)
    return out


def write_y4m(path, frames, chroma="420", depth=8):
    from daala_tpu_torch.utils.y4m import Y4MWriter
    h, w = frames[0][0].shape
    wr = Y4MWriter(path, w, h, chroma=chroma, aspect=(1, 1), depth=depth)
    for fr in frames:
        wr.write_frame(fr)
    wr.close()


def sum_launches(total, launches):
    """Add the counts of `launches` into `total`; returns `total`."""
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def read_file(path):
    with open(path, "rb") as f:
        return f.read()


def cli_run(torch, tool, args):
    """daala_tpu_torch.tools.<tool>.main(args) in this process; returns
    its wall and the kernel launches counted in it (reset just before)."""
    import importlib
    from daala_tpu_torch.utils import devstats
    main = importlib.import_module("daala_tpu_torch.tools." + tool).main
    devstats.reset()
    t0 = time.perf_counter()
    main([str(a) for a in args])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, devstats.snapshot()["launches"]


def phase_cli_1080p(torch, dev, ref, host_frames):
    """Phase 12a-b against phase 3's results `ref` and phase 6's host
    decoder frames; returns the kernels' launches in both runs."""
    import io
    from daala_tpu_torch.utils.ogg import OggPageWriter, read_ogg_packets
    from daala_tpu_torch.utils.profile import H, NFRAMES, W, translation_clip
    os.makedirs(CLI_DIR, exist_ok=True)
    src, ogv, out = (os.path.join(CLI_DIR, "1080p" + e)
                     for e in (".y4m", ".ogv", ".out.y4m"))
    write_y4m(src, translation_clip())
    # The host I/O alone: reading the clip, muxing phase 3's packets.
    t0 = time.perf_counter()
    nread = len(read_y4m(src))
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mux = OggPageWriter(io.BytesIO(), serial=0x0da1a)
    for p in ref["packets"]:
        mux.add_packet(p, 0, flush=True)
    mux.close()
    mux_s = time.perf_counter() - t0
    enc_s, enc_l = cli_run(torch, "encode", [src, ogv, "-v", "25", "-z", "7",
                                             "--check", "--device", dev])
    with open(ogv, "rb") as f:
        pk = [p for p, _ in read_ogg_packets(f)]
    if pk[3:] != ref["packets"]:
        raise AssertionError("the CLI's 1080p packets differ from phase 3's "
                             "(%d vs %d)" % (len(pk) - 3, len(ref["packets"])))
    dec_s, dec_l = cli_run(torch, "decode", [ogv, out, "--device", dev])
    frames = read_y4m(out)
    if not len(frames) == len(host_frames) == nread:
        raise AssertionError("the CLI decoded %d frames, the host decoder %d"
                             % (len(frames), len(host_frames)))
    for i, (a, b) in enumerate(zip(frames, host_frames)):
        for pli in range(3):
            if not np.array_equal(a[pli], b[pli]):
                raise AssertionError("the CLI's decoded frame %d plane %d "
                                     "differs from phase 6's host frame"
                                     % (i, pli))
    for name in ("lap_frame", "dct_frame"):
        if enc_l.get(name, 0) <= 0 or dec_l.get(name, 0) <= 0:
            raise AssertionError("%s never launched in the CLI's 1080p "
                                 "encode or decode" % name)
    mpix = NFRAMES * W * H / 1e6
    print("cli 1080p: encode %d packets == phase 3's, encoder check passed; "
          "decode %d frames == phase 6's host decoder; launches encode %s, "
          "decode %s" % (len(pk) - 3, len(frames), enc_l, dec_l))
    print("cli 1080p: encode wall %.3f s, %.4f Mpix/s (phase 3's API wall "
          "%.3f s, %.4f Mpix/s; ratio %.3f); decode wall %.3f s; host I/O "
          "alone: y4m read %.4f s, ogg mux %.4f s, %.4f of the encode wall "
          "[information only]"
          % (enc_s, mpix / enc_s, ref["wall"], mpix / ref["wall"],
             enc_s / ref["wall"], dec_s, read_s, mux_s,
             (read_s + mux_s) / enc_s))
    return sum_launches(sum_launches({}, enc_l), dec_l)


def read_y4m(path):
    from daala_tpu_torch.utils.y4m import Y4MReader
    rd = Y4MReader(path)
    frames = list(rd)
    rd.close()
    return frames


def equal_frames(got, want):
    return len(got) == len(want) and all(
        np.array_equal(a, b) for fa, fb in zip(got, want)
        for a, b in zip(fa, fb))


def cli_mode(torch, name, d, src):
    """Phase 12c's mode `name` on device `d`: the CLI encode (both runs of
    two-pass) and decode (and the --seek decode) of the y4m `src`.
    Returns the paths of what they wrote, their walls, and the kernels'
    launches in the encodes and in the decodes."""
    flags = CLI_MODES[name][3]
    tag = name + (".cpu" if d == "cpu" else ".card")
    out = lambda ext: os.path.join(CLI_DIR, tag + ext)  # noqa: E731
    paths, walls, enc, dec = [out(".ogv"), out(".y4m")], [], {}, {}
    if name == "two_pass":
        stats = out(".stats")
        if os.path.exists(stats):
            os.unlink(stats)
        paths += [out(".pass1.ogv"), stats]
        s, l = cli_run(torch, "encode", [src, paths[2], "--two-pass", stats,
                                         "--device", d])
        walls.append(s)
        sum_launches(enc, l)
        flags = flags + ["--two-pass", stats]
    s, l = cli_run(torch, "encode", [src, paths[0]] + flags + ["--device", d])
    walls.append(s)
    sum_launches(enc, l)
    s, l = cli_run(torch, "decode", [paths[0], paths[1], "--device", d])
    walls.append(s)
    sum_launches(dec, l)
    if name == "seek":
        paths.append(out(".seek.y4m"))
        s, l = cli_run(torch, "decode", [paths[0], paths[-1], "--device", d]
                       + CLI_SEEK)
        walls.append(s)
        sum_launches(dec, l)
    return paths, walls, enc, dec


def phase_cli_modes(torch, dev):
    """Phase 12c; returns the kernels' launches in the card's runs."""
    base = textured_clip(320, 192, max(m[0] for m in CLI_MODES.values()))
    total = {}
    for name, (n, chroma, depth, flags) in CLI_MODES.items():
        frames = cli_frames(base[:n], chroma, depth)
        src = os.path.join(CLI_DIR, name + ".y4m")
        write_y4m(src, frames, chroma, depth)
        paths, walls, enc, dec = cli_mode(torch, name, str(dev), src)
        cpu_paths, cpu_walls, _, _ = cli_mode(torch, name, "cpu", src)
        for a, b in zip(paths, cpu_paths):
            if read_file(a) != read_file(b):
                raise AssertionError("cli %s: %s differs between the card and"
                                     " the cpu" % (name, os.path.basename(a)))
        if name == "lossless":
            if any(enc.values()) or any(dec.values()):
                raise AssertionError("cli lossless: kernels launched: %s %s"
                                     % (enc, dec))
            if not equal_frames(read_y4m(paths[1]), frames):
                raise AssertionError("cli lossless: the decoded frames are "
                                     "not the input")
        else:
            for k in ("lap_frame", "dct_frame"):
                # The spawned workers count their own launches.
                if dec.get(k, 0) <= 0 or (name != "workers"
                                          and enc.get(k, 0) <= 0):
                    raise AssertionError("cli %s: %s never launched on the "
                                         "card" % (name, k))
        if name == "device+sweep" and enc.get("obmc_leaf_cells", 0) <= 0:
            raise AssertionError("cli device+sweep: obmc_leaf_cells never "
                                 "launched")
        if name == "seek" and not equal_frames(read_y4m(paths[-1]),
                                               read_y4m(paths[1])[6:]):
            raise AssertionError("cli seek: the frames written are not the "
                                 "full decode's from frame 6 on")
        sum_launches(total, enc)
        sum_launches(total, dec)
        print("cli %s: %d frames %s %d-bit [%s]: .ogv (%d bytes) and y4m "
              "equal on the card and the cpu; walls (encode, decode) card %s "
              "s, cpu %s s; card launches encode %s, decode %s [walls "
              "information only]"
              % (name, n, chroma, depth, " ".join(flags),
                 os.path.getsize(paths[0]), ["%.2f" % v for v in walls],
                 ["%.2f" % v for v in cpu_walls], enc, dec))
    return total


def phase_cli(torch, dev, ref, host_frames):
    """Phase 12: the command-line encoder and decoder on the card; returns
    each kernel's launches in the runs of this process (the spawned
    --workers count their own)."""
    import shutil
    try:
        total = phase_cli_1080p(torch, dev, ref, host_frames)
        sum_launches(total, phase_cli_modes(torch, dev))
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    return total


def kernel_line(kern, launches, phases):
    """The kernels line: each kernel's launches on its main path
    ("launches": lap_frame and dct_frame in phase 3's encode, obmc_blend
    in phase 2c, obmc_leaf_cells in phase 4's 1080p sweep encode,
    sad_fields in phase 3's encode, pulse_search, band_prologue and
    band_epilogue in phase 3c's lean encode) and, under each key of `phases`, its launches in that run:
    phase 3's analysis-tier encode ("analysis_launches"), phase 3c's
    lean encode ("lean_launches"), phase 4's 1080p sweep encode
    ("sweep_launches"), phase 6's decode, the batched phases 7a-7b (both
    schedules), the training statistics (phase 8a), the sharded paths of
    phase 9 ("shard_launches": 9a, 9b, 9d and 9e, each tile a launch),
    the encoder's Python coefficient path (phase 10's Python run), the
    benchmark's probe runs (phase 11, "bench_launches") and the
    command-line tools' card runs of this process (phase 12,
    "cli_launches"); and its numbers summed over phase 2's, 2b's and
    2d's timed variants (each shape, size, direction, bit depth, call or
    tile once): per-call medians through the wrapper ("ms"), the
    kernels' device time per call in the trace ("device_ms"), the plain
    version's, and the bounds; "bound_by" names what bounds the larger
    part of bound_ms.  No single PyTorch call computes any of these
    functions, so library_ms is null.  pulse_search, band_prologue,
    band_epilogue and sad_fields replace functions that JAX computes in
    XLA, not in Pallas."""
    pallas = "daala_tpu/ops/pallas/"
    sources = {
        "lap_frame": ("lap_frame.cu", pallas + "lap_kernels.py:78"),
        "dct_frame": ("dct_frame.cu", pallas + "dct_kernels.py:83"),
        "obmc_blend": ("obmc_leaf.cu", pallas + "obmc_kernels.py:191"),
        "obmc_leaf_cells": ("obmc_leaf.cu", pallas + "obmc_kernels.py:208"),
        "pulse_search": ("pulse_search.cu", "daala_tpu/models/pvqsearch.py:"
                         "318 _pulse_search (XLA in JAX)"),
        "band_prologue": ("band_search.cu", "daala_tpu/models/pvqsearch.py:"
                          "562 band_search before its pulse search (XLA in "
                          "JAX)"),
        "band_epilogue": ("band_search.cu", "daala_tpu/models/pvqsearch.py:"
                          "562 band_search after its pulse search (XLA in "
                          "JAX)"),
        "sad_fields": ("sad_fields.cu", "daala_tpu/models/mefield.py:42"
                       " _fullpel_fields (XLA in JAX)"),
    }
    rows = []
    for name, (src, rep) in sources.items():
        if name not in kern:
            continue
        k = kern[name]
        row = {"name": name, "route": "cuda",
               "source": "daala_tpu_torch/csrc/" + src, "replaces": rep,
               "launches": launches.get(name)}
        row.update({key: counts.get(name, 0)
                    for key, counts in phases.items()})
        row.update({
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "device_ms": k["device_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": max(k["bound_by"], key=k["bound_by"].get),
            "library_ms": None, "variants": k["variants"]})
        rows.append(row)
    return {"kernels": rows}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="PARENT",
                    help="only phases 1 and 2 (and 2d's sad_fields and "
                    "band kernel cases), with the lap_frame.cu, "
                    "dct_frame.cu, sad_fields.cu and band_search.cu of the "
                    "checkout PARENT and of this tree in turns (parent, "
                    "change, change, parent)")
    ap.add_argument("--rounds", type=int, default=1, metavar="R",
                    help="with --ab, R rounds of the four turns (default "
                    "1)")
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
        phase_ab(torch, dev, args.ab, args.rounds)
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
    launches["sad_fields"] = ref["launches"].get("sad_fields", 0)
    checked = {"analysis": sum(map(len, ref["packets"]))}
    lean = run("3c", phase_lean, torch, dev, ref)
    checked["device"] = lean["bytes"]
    launches["pulse_search"] = lean["launches"].get("pulse_search", 0)
    for name in ("band_prologue", "band_epilogue"):
        launches[name] = lean["launches"].get(name, 0)
    run("2d", phase_search_kernels, torch, dev, kern,
        lean.pop("pulse_calls"), lean.pop("band_calls"))
    run("3d", phase_fields, torch, dev)
    run("3e", phase_dering_candidates, torch, dev)
    sweep_launches = run("4", phase_sweep, torch, dev)
    launches["obmc_leaf_cells"] = sweep_launches["obmc_leaf_cells"]
    run("4c", phase_lean_small, torch, dev)
    run("4c sweep", phase_lean_small, torch, dev, sweep=True)
    checked["device+sweep"] = run("4c sweep 1080p", phase_lean_sweep_1080p,
                                  torch, dev)
    decode_launches, host_frames = run("6", phase_decoder, torch, dev, ref)
    batch_launches, batch_ref = run("7a", phase_batch_step, torch, dev)
    clips_launches, clips_ref = run("7b", phase_clips_batched, torch, dev,
                                    ref)
    for k, v in clips_launches.items():
        batch_launches[k] = batch_launches.get(k, 0) + v
    run("7c", phase_segments, torch, dev)
    train_launches = run("8a", phase_train_zigzag, torch, dev)
    run("8b", phase_train_vq, torch, dev)
    run("8c", phase_train_gain, torch, dev)
    run("8d", phase_sweep_quality, torch, dev)
    shard_launches = run("9", phase_sharded, torch, dev, ref, batch_ref,
                         clips_ref)
    python_path_launches = run("10", phase_python_path, torch, dev)
    bench_launches = run("11", phase_bench, torch, dev, checked)
    cli_launches = run("12", phase_cli, torch, dev, ref, host_frames)
    leaked = sorted(m for m in sys.modules if m in ("jax", "daala_tpu")
                    or m.startswith(("jax.", "daala_tpu.")))
    if leaked:
        raise AssertionError("imported: %s" % leaked)
    print(json.dumps(kernel_line(kern, launches, dict(
        analysis_launches=ref["launches"], lean_launches=lean["launches"],
        sweep_launches=sweep_launches, decode_launches=decode_launches,
        batch_launches=batch_launches, train_launches=train_launches,
        shard_launches=shard_launches,
        python_path_launches=python_path_launches,
        bench_launches=bench_launches, cli_launches=cli_launches))))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
