"""The measured windows: an encoding job and a player, chosen by the
mix's `mode`.

encode: one Encoder of the configuration runs the whole window as a
closed loop, the next frame going in when encode_frame returns its
packets; the source is the mix's clip, played forward and back.  The
window runs `seconds` and finishes the frame in flight; the rate is
every pixel coded over all the elapsed time.  The first
`quality_frames` frames are decoded after the window by the port's
decoder for the stream's size and luma PSNR.  A window runs at least
the mix's `checked_within` frames (and `quality_frames`), about the
fewest that `seconds` hold on the card, so that the check's sample
(codecbench/check.py `sample_frames`) reaches late into the window.

decode: set-up encodes the mix's clip under the configuration; the
window plays that stream again and again, a fresh Decoder at each pass,
as a player that seeks back to the keyframe; the rate is every pixel
decoded over all the elapsed time.

Set-up runs the same shapes once on a throwaway encoder or decoder
(`warm_frames` frames), so that every kernel is built before the
window; `setup_s` runs from the process's start to the window's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from codecbench import check as C
from codecbench import source as S
from codecbench import trace as T


class Run:
    """What a window gave: the end-to-end numbers (`e2e`), the per-frame
    walls, the port's counters over the window (`stats`), the trace
    (`trace`, traced runs only) and what the check compares."""

    def __init__(self, mode, dev, root):
        self.mode = mode
        self.dev = dev
        self.root = root
        self.e2e = {}
        self.frame_walls = []
        self.frames = 0
        self.window_s = None
        self.stats = None
        self.trace = None
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.sample = []
        self.capture = None
        self.decoded = {}
        self.recon_off = 0
        self.source = None
        self.cpu_s = None

    def device_info(self):
        info = {"platform": "gpu" if self.dev.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(self.dev)
                         if self.dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(self.memory_peak)}
        if self.trace is not None:
            info["busy_s"] = self.trace.busy_s
            info["window_s"] = self.trace.window_s
        return info


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tuples(v):
    """JSON's lists as the tuples that headers.Info holds."""
    return tuple(map(_tuples, v)) if isinstance(v, list) else v


def stream_info(config):
    """The stream's headers.Info: the picture's size and the
    configuration's optional `info`, further fields of headers.Info
    (bit depth, full-precision references, planes)."""
    from daala_tpu_torch.codec import headers
    extra = {k: _tuples(v) for k, v in config.get("info", {}).items()}
    return headers.Info(pic_width=config["width"],
                        pic_height=config["height"], **extra)


def new_encoder(config, dev):
    """The configuration's Encoder: its keywords (`encoder`), then its
    optional `attributes`, the switches the Encoder takes as attributes
    after construction (b_frames, mv_res_min, ...), as the port's CLI
    sets them."""
    from daala_tpu_torch.codec.encoder import Encoder
    enc = Encoder(stream_info(config), quant=config["quant"],
                  complexity=config["complexity"], device=str(dev),
                  **config["encoder"])
    enc.keyframe_rate = config["keyframe_rate"]
    enc.enable_encoder_check = bool(config["encoder_check"])
    for k, v in config.get("attributes", {}).items():
        setattr(enc, k, v)
    return enc


def new_decoder(config, dev):
    from daala_tpu_torch.codec.decoder import Decoder
    return Decoder(stream_info(config), device=str(dev))


def luma_psnr(got, want):
    mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def run_window(config, mix, seed, seconds, trace, dev, t_start, root="."):
    """Set up, warm up and run the mix's window; returns a Run."""
    from daala_tpu_torch.utils import devstats
    w, h = config["width"], config["height"]
    clip = S.make_clip(mix["content"], w, h, mix["clip_frames"], seed,
                       mix.get("texture_seed"))
    run = Run(mix["mode"], dev, root)
    run.source = lambda i: clip[S.palindrome(len(clip), i)]
    if run.mode == "encode":
        drive = _encode_window
    elif run.mode == "decode":
        drive = _decode_window
    else:
        raise ValueError("unknown mode %r" % run.mode)
    drive(run, config, mix, seed, seconds, trace, dev, t_start, devstats)
    return run


def _window(run, dev, trace, seconds, step, devstats, t_start, frame_hook,
            min_frames):
    """Time `step(i)` for i = 0, 1, ... until `seconds` have passed and
    `min_frames` frames are done, finishing the frame in flight; fills
    the run's walls, counters, trace, memory peak and the process's CPU
    seconds (every thread).  Returns the elapsed seconds."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    rec = T.Recorder(dev, run.root) if trace else None
    if rec is not None:
        rec.start()
    devstats.reset()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    run.e2e["setup_s"] = t0 - t_start
    i = 0
    while True:
        frame_hook(i)
        tf = time.perf_counter()
        if rec is not None:
            with torch.profiler.record_function("frame"):
                step(i)
        else:
            step(i)
        run.frame_walls.append(time.perf_counter() - tf)
        i += 1
        if i >= min_frames and time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    elapsed = time.perf_counter() - t0
    run.cpu_s = time.process_time() - cpu0
    run.stats = devstats.snapshot()
    if rec is not None:
        t_stop = time.perf_counter()
        run.trace = rec.stop(elapsed)
        run.trace.reduce_s = time.perf_counter() - t_stop
    run.frames = i
    run.window_s = elapsed
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    return elapsed


def _encode_window(run, config, mix, seed, seconds, trace, dev, t_start,
                   devstats):
    w, h = config["width"], config["height"]
    nq = mix["quality_frames"]
    warm = new_encoder(config, dev)
    for i in range(mix["warm_frames"]):
        warm.encode_frame(run.source(i))
    warm.flush()
    del warm
    within = mix["checked_within"]
    run.sample = C.sample_frames(seed, within, mix["checked_frames"])
    cap = run.capture = C.Capture(run.sample,
                                  C.load_stages(run.root, config))
    cap.install_encode()
    enc = new_encoder(config, dev)
    packets, recons = [], []

    def step(i):
        out = enc.encode_frame(run.source(i))
        if i < nq:
            packets.extend(out)
            recons.append([np.array(p) for p in enc.recon])

    def at(i):
        cap.frame = i

    try:
        elapsed = _window(run, dev, trace, seconds, step, devstats, t_start,
                          at, max(nq, within))
        enc.flush()
    finally:
        cap.uninstall()
    del enc
    run.attempted = run.frames
    run.e2e["encode_mpix_s"] = run.frames * w * h / elapsed / 1e6
    run.e2e["bits_per_pixel"] = 8.0 * sum(map(len, packets[:nq])) / (
        nq * w * h)
    dec = new_decoder(config, dev)
    psnr = []
    for k, p in enumerate(packets[:nq]):
        (got,) = dec.decode_packet(p)
        psnr.append(luma_psnr(got[0], run.source(k)[0]))
        run.recon_off += sum(int((g != r).sum())
                             for g, r in zip(got, recons[k]))
    run.e2e["psnr_y_db"] = float(np.mean(psnr))


def _decode_window(run, config, mix, seed, seconds, trace, dev, t_start,
                   devstats):
    w, h = config["width"], config["height"]
    nclip = mix["clip_frames"]
    enc = new_encoder(config, dev)
    stream = []
    for i in range(nclip):
        stream.extend(enc.encode_frame(run.source(i)))
    stream.extend(enc.flush())
    del enc
    warm = new_decoder(config, dev)
    for p in stream:
        warm.decode_packet(p)
    del warm
    run.sample = C.sample_frames(seed, mix["checked_within"],
                                 mix["checked_frames"])
    cap = run.capture = C.Capture(run.sample)
    cap.install_decode()
    state = {"dec": None}

    def step(i):
        k = i % len(stream)
        if k == 0:
            state["dec"] = new_decoder(config, dev)
        out = state["dec"].decode_packet(stream[k])
        if i in cap.sample:
            run.decoded[i] = [np.array(p) for p in out[0]]

    def at(i):
        cap.frame = i

    try:
        elapsed = _window(run, dev, trace, seconds, step, devstats, t_start,
                          at, mix["checked_within"])
    finally:
        cap.uninstall()
    run.attempted = run.frames
    run.e2e["decode_mpix_s"] = run.frames * w * h / elapsed / 1e6
