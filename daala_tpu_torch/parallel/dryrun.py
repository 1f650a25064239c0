"""The port's counterparts of the repository root's __graft_entry__.py:
a single-device entry point and a multi-device dry run, both on the
REAL codec's device stage.

- `entry(device)` returns a function and its arguments: the device
  analysis of one keyframe luma plane (models/keyframe.py
  keyframe_analysis_plane), exactly what the production encoder
  consumes.
- `dryrun_multichip(n_devices, device)` runs the legs the port can run
  on a mesh of `n_devices` rows (parallel/mesh.py) and checks each:
  a complexity-7 keyframe + P-frame encode with the device analysis,
  the device synthesis decode, and the batched multi-clip encode.  The
  spatially sharded leg of JAX's dry run waits for the mesh's `sp` axis
  (ROADMAP.md, multi-GPU batching).

Both run on the card unless the caller asks for the CPU
(device="cpu"), and raise when the cards are missing.
"""

from __future__ import annotations

import time

import numpy as np


def _test_frame(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 60 * np.sin(xx / 7.0) + 40 * np.cos(yy / 11.0)
         + rng.normal(0, 8, (h, w))).clip(0, 255).astype(np.uint8)
    cb = (128 + 30 * np.sin(xx[::2, ::2] / 9.0)).clip(0, 255) \
        .astype(np.uint8)
    cr = (128 + 30 * np.cos(yy[::2, ::2] / 13.0)).clip(0, 255) \
        .astype(np.uint8)
    return [y, cb, cr]


def entry(device="cuda"):
    """Returns (fn, example_args): the device analysis of one 256x256
    keyframe luma plane on `device` (frame lapped prefilter + masked
    split lapped filters + per-size reversible DCT pyramid + Haar DC
    merges) over a mixed block-size map that exercises every level."""
    import torch
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.state import CodecState
    from daala_tpu_torch.device import resolve
    from daala_tpu_torch.models import keyframe as KF
    from daala_tpu_torch.utils import devstats

    dev = resolve(device)
    w = h = 256
    info = headers.Info(pic_width=w, pic_height=h)
    st = CodecState(info)
    st.init_superblock_split(2)
    st.bsize[:8, :8] = 0
    st.bsize[8:16, :8] = 1
    st.bsize[:8, 8:16] = 3
    st.bsize[16:24, 16:24] = 4
    mask_args = KF._mask_tensors(KF.build_analysis_masks(st, info, 0), dev)
    plane = devstats.upload(_test_frame(w, h)[0], dev)

    def fn(p, margs):
        d = KF.keyframe_analysis_plane(p, margs, xdec=0, ydec=0,
                                       lossless=False)
        return d.to(torch.int64).sum(), d

    return fn, (plane, mask_args)


def dryrun_multichip(n_devices, device="cuda"):
    """Run the port's multi-device legs on a mesh of n_devices rows of
    `device` ("cuda": the first n_devices cards, RuntimeError when fewer
    are present; "cpu": n_devices CPU rows) and check each:

    1. a complexity-7 keyframe + P-frame encode with the device analysis
       on the mesh's first device, encoder check on, byte-identical to
       the same encode on the CPU (whose packets the CPU tests hold to
       daala_tpu's host encoder);
    2. those packets decoded by the device back end on the mesh's first
       device: the host decoder's frames;
    3. mesh.encode_clips_batched of n_devices clips (one per row, two
       frames each, complexity 7) in both schedules, byte-identical to
       serial encodes.

    Prints one line per leg and a summary; returns the packets of each
    leg ({"kf_p": [...], "clips": [[...], ...]})."""
    import torch
    from daala_tpu_torch.codec import headers
    from daala_tpu_torch.codec.decoder import Decoder
    from daala_tpu_torch.codec.encoder import Encoder
    from daala_tpu_torch.parallel import mesh as PM

    if device == "cpu":
        devices = ["cpu"] * n_devices
    else:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                "dryrun_multichip: need %d CUDA devices, torch sees %d"
                % (n_devices, torch.cuda.device_count()
                   if torch.cuda.is_available() else 0))
        devices = None
    mesh = PM.make_mesh(n_devices, devices=devices)
    dev0 = mesh[0, 0]
    t_start = time.perf_counter()

    def leg(name, t0):
        now = time.perf_counter()
        print("dryrun leg [%s]: %.1f s (total %.1f s)"
              % (name, now - t0, now - t_start), flush=True)
        return now

    w, h = 256, 192
    frames = [_test_frame(w, h, seed=1), _test_frame(w, h, seed=2)]
    info = headers.Info(pic_width=w, pic_height=h)

    def encode(dev, frs):
        enc = Encoder(info, quant=18, complexity=7, device=dev)
        enc.keyframe_rate = 64
        enc.enable_encoder_check = True
        return [bytes(enc.encode_frame(fr)[0]) for fr in frs]

    t0 = time.perf_counter()
    pkts_dev = encode(dev0, frames)
    pkts_cpu = encode("cpu", frames)
    t0 = leg("c7 KF+P device analysis encode on %s and cpu" % dev0, t0)
    for i, (pd, pc) in enumerate(zip(pkts_dev, pkts_cpu)):
        if pd != pc:
            raise AssertionError("device analysis packet %d differs from "
                                 "the cpu run's (%d vs %d bytes)"
                                 % (i, len(pd), len(pc)))

    host = Decoder(info, use_device_synthesis=False)
    frames_host = [f for p in pkts_dev for f in host.decode_packet(p)]
    dec_dev = Decoder(info, device=dev0)
    frames_dev = [f for p in pkts_dev for f in dec_dev.decode_packet(p)]
    t0 = leg("device synthesis decode on %s" % dev0, t0)
    if not len(frames_dev) == len(frames_host) == 2:
        raise AssertionError("decoded %d / %d frames of 2"
                             % (len(frames_dev), len(frames_host)))
    for fi in range(2):
        for pli in range(3):
            if not np.array_equal(frames_host[fi][pli],
                                  frames_dev[fi][pli]):
                raise AssertionError("device synthesis reconstruction "
                                     "differs (frame %d plane %d)"
                                     % (fi, pli))

    dp = mesh.shape[0]
    clips = [[_test_frame(w, h, seed=10 + c), _test_frame(w, h, seed=20 + c)]
             for c in range(dp)]
    kw = dict(pic_width=w, pic_height=h)
    outs = {}
    for threads in (False, True):
        outs[threads] = PM.encode_clips_batched(clips, kw, mesh, quant=18,
                                                complexity=7,
                                                threads=threads)
    t0 = leg("batched %d-clip c7 KF+P encode, both schedules" % dp, t0)
    nbytes = 0
    for ci, frames_c in enumerate(clips):
        enc = Encoder(info, quant=18, complexity=7, device=mesh[ci, 0])
        want = [bytes(p) for fr in frames_c for p in enc.encode_frame(fr)]
        want += [bytes(p) for p in enc.flush()]
        for threads, got in outs.items():
            if [bytes(p) for p in got[ci]] != want:
                raise AssertionError(
                    "batched packets differ from serial (clip %d, "
                    "threads=%s)" % (ci, threads))
        nbytes += sum(map(len, want))
    leg("serial comparison", t0)
    print("dryrun_multichip ok: %d %s rows; complexity-7 keyframe + "
          "P-frame encode with the device analysis byte-identical to the "
          "cpu run (%d + %d bytes); device synthesis decode bit-exact; "
          "batched %d-clip c7 KF+P encode byte-identical to serial in both "
          "schedules (%d bytes); %.1f s total"
          % (dp, dev0.type, len(pkts_dev[0]), len(pkts_dev[1]), dp, nbytes,
             time.perf_counter() - t_start))
    return {"kf_p": pkts_dev, "clips": outs[True]}
