"""Multi-device scaling: the counterpart of daala_tpu/parallel/mesh.py.

Two independent axes of parallelism, reflecting the codec's structure
(SURVEY.md section 7: the only irreducibly sequential parts are the range
coder and cross-block adaptation; everything else batches):

1. **Device mesh (dp, sp)**, a numpy array of torch devices, for the
   uniform-quantizer pipeline (models/analysis.py) and the batched
   multi-clip encode: clips and frames go to the rows (`dp`), frame
   columns to the columns (`sp`).  Where XLA inserts the halo
   collectives of the lapped filters for JAX, the port cuts the planes
   into tiles on superblock boundaries and exchanges the halos itself
   (parallel/sharding.py).  A mesh may name a device more than once: a
   2 x 2 mesh on one card is `make_mesh(devices=["cuda:0"] * 4)`.

2. **Host segment parallelism** for full conformant encodes: the
   bitstream resets all adaptation at keyframes, so a clip split at
   keyframe boundaries encodes in fully independent processes and the
   packets concatenate exactly (the standard production pattern for
   non-parallel codecs; the reference has no equivalent, it is strictly
   single-threaded, SURVEY.md section 2.6).

Every entry point runs on the card unless the caller asks for the CPU
(`make_mesh(devices=["cpu", ...])`, `enc_kwargs={"device": "cpu"}`), and
none moves work to the CPU when a card is missing or a build fails: it
raises.
"""

from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from daala_tpu_torch.device import resolve
from daala_tpu_torch.models.analysis import encode_step, wrap32
from daala_tpu_torch.parallel.sharding import (Sharding, as_plane,
                                               named_put, put)


# -- 1. device mesh ---------------------------------------------------------

def make_mesh(n_devices=None, dp=None, *, devices=None):
    """A (dp, sp) numpy array of torch.devices: the first `n_devices` of
    `devices` (default: every CUDA card; raises RuntimeError without
    one), dp rows of sp = n_devices // dp columns; dp = 2 when
    n_devices is even, else 1 (JAX's default).  `devices` may name a
    device more than once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices=['cpu', ...] to run on the CPU")
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    devs = [resolve(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise RuntimeError("make_mesh: %d devices asked for, %d present"
                           % (n, len(devs)))
    if dp is None:
        dp = 2 if n % 2 == 0 else 1
    if dp < 1 or n % dp:
        raise ValueError("make_mesh: dp=%d does not divide %d devices"
                         % (dp, n))
    mesh = np.empty((dp, n // dp), dtype=object)
    for i in range(n):
        mesh[i // (n // dp), i % (n // dp)] = devs[i]
    return mesh


def shard_batch(frames_u8, mesh):
    """Place a (B, H, W) uint8 batch (numpy) on the mesh: the batch over
    dp, columns over sp, cut on superblocks with the 2-pixel halo that
    batch_encode_step's forward lapped filter needs (a ShardedPlane,
    parallel/sharding.py).  B must split evenly over dp."""
    frames = np.asarray(frames_u8)
    if frames.ndim != 3 or frames.dtype != np.uint8:
        raise ValueError("shard_batch takes a (B, H, W) uint8 batch, got "
                         "%s %s" % (frames.dtype, frames.shape))
    return put(frames, Sharding(mesh, ("dp", None, "sp")), halo=2)


def batch_encode_step(frames, bs=1, quant=3840):
    """models/analysis.py encode_step over a (B, H, W) uint8 batch: a
    ShardedPlane from shard_batch (each frame in its tiles, on their
    devices) or a tensor on one device.  Returns (rec, sse, nz): rec the
    uint8 reconstructions laid out as `frames`, sse and nz Python ints,
    the sums over the batch with JAX's int32 wrap, fetched after every
    frame's work is issued."""
    frames, back = as_plane(frames)
    outs = [encode_step(frames.frame(b), bs=bs, quant=quant)
            for b in range(frames.shape[0])]
    rec = back(frames.stack([o[0] for o in outs]))
    sse = sum(int(o[1]) for o in outs)
    nz = sum(int(o[2]) for o in outs)
    return rec, int(wrap32(sse)), int(wrap32(nz))


# -- 2. host segment parallelism --------------------------------------------

def _encode_segment(args):
    (frames, info_kwargs, enc_kwargs, b_frames, enc_attrs) = args
    from daala_tpu_torch.codec import headers as H
    from daala_tpu_torch.codec.encoder import Encoder
    info = H.Info(**info_kwargs)
    enc = Encoder(info, **enc_kwargs)
    enc.b_frames = b_frames
    for name, value in enc_attrs.items():
        setattr(enc, name, value)
    packets = []
    for planes in frames:
        packets.extend(enc.encode_frame(planes))
    packets.extend(enc.flush())
    return packets


def _share_cores(n_threads):
    """A worker's start: torch's intra-op threads get its share of the
    host's cores (the workers would otherwise each start one thread per
    core and crowd each other out)."""
    torch.set_num_threads(n_threads)


def encode_clip_parallel(frames, info_kwargs, enc_kwargs=None, b_frames=0,
                         segment_len=32, workers=None, enc_attrs=None):
    """Encode a clip with keyframe-aligned segments in parallel processes.

    frames: list of per-frame plane lists.  Each segment starts with a
    keyframe (adaptation and reference state fully reset), so packets
    from consecutive segments concatenate into a conformant stream.
    segment_len must be a multiple of 16 (OD_MAX_REORDER) so the coded
    display numbering stays aligned across segment boundaries.
    enc_kwargs go to the port's Encoder, `device` among them (default:
    the card).  enc_attrs ({name: value}) are set on each segment's
    Encoder after b_frames, for the switches it takes as attributes
    (mv_max_level, enable_encoder_check, ...).  The workers are spawned,
    not forked (a process forked after CUDA is initialised cannot use
    it), and share the host's cores.  Returns the flat packet list in
    display order."""
    assert segment_len % 16 == 0
    enc_kwargs = dict(enc_kwargs or {})
    segs = [frames[i:i + segment_len]
            for i in range(0, len(frames), segment_len)]
    # Force a keyframe at each segment start by capping keyframe_rate.
    info_kwargs = dict(info_kwargs)
    info_kwargs.setdefault("keyframe_rate", segment_len)
    args = [(seg, info_kwargs, enc_kwargs, b_frames, dict(enc_attrs or {}))
            for seg in segs]
    if len(segs) == 1 or (workers is not None and workers <= 1):
        out = [_encode_segment(a) for a in args]
    else:
        import multiprocessing as mp
        nproc = workers or min(len(segs), os.cpu_count() or 1)
        ctx = mp.get_context("spawn")
        with ctx.Pool(nproc, initializer=_share_cores,
                      initargs=(max(1, (os.cpu_count() or 1) // nproc),)) \
                as pool:
            out = pool.map(_encode_segment, args)
    packets = []
    for seg_pkts in out:
        packets.extend(seg_pkts)
    return packets


# -- 3. batched multi-clip encode over the device mesh ----------------------

def _prepare(devices):
    """Load the native engine and build the CUDA sources before any
    thread starts: the native loader marks itself tried before it
    builds, so a second thread that calls it meanwhile would get None."""
    from daala_tpu_torch import native
    if native.get_lib() is None:
        raise RuntimeError("the port's native engine did not build")
    if any(d.type == "cuda" for d in devices):
        from daala_tpu_torch.ops.cuda import (dct_kernels, lap_kernels,
                                              obmc_kernels)
        with ThreadPoolExecutor(3) as ex:
            list(ex.map(lambda m: m.build(),
                        (lap_kernels, dct_kernels, obmc_kernels)))


@contextlib.contextmanager
def _on(row):
    """The context a clip's thread runs in: its row's first card and, on
    every card of its row, a stream of its own (nothing on the CPU), so
    that its tiles and their halo copies stay on its streams."""
    with contextlib.ExitStack() as stack:
        if row[0].type == "cuda":
            stack.enter_context(torch.cuda.device(row[0]))
        for dev in dict.fromkeys(d for d in row if d.type == "cuda"):
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
        yield


def encode_clips_batched(clips, info_kwargs, mesh, quant=18, complexity=7,
                         enc_kwargs=None, threads=None):
    """BASELINE.json config 5: N clips encoded by the REAL production
    encoder (trial-encode RDO, full entropy stage) with every device
    stage of the analysis tier (the SAD fields, the RDO transform
    pyramids, the final analysis, the dering candidates) on the mesh:
    clip ci on row ci % dp, its planes cut over that row's sp columns
    (the encoder's device_put_fn, as JAX's put: a 2-D plane's columns
    over sp).  Each encoder's device is its row's first.

    With threads (the default for >1 clip) each clip encodes on its own
    host thread, on a CUDA stream of its own on every card of its row:
    clip B's device work is issued while clip A's host entropy stage
    runs,
    because the ctypes calls into the native frame/ME engines and the
    blocking device-result reads release the GIL (the native engines'
    persistent scratch is thread_local).  threads=False keeps the
    round-robin single-thread schedule on the current stream.

    Packets are byte-identical to a serial single-device encode either
    way (the device stages are exact and the clips are independent).
    enc_kwargs go to each Encoder; its device is the mesh's.  Returns a
    list of per-clip packet lists; an error in any clip is raised."""
    from daala_tpu_torch.codec import headers as H
    from daala_tpu_torch.codec.encoder import Encoder
    enc_kwargs = dict(enc_kwargs or {})
    if "device" in enc_kwargs:
        raise ValueError("encode_clips_batched: the mesh gives each clip "
                         "its device; enc_kwargs may not")
    enc_kwargs["use_device_analysis"] = True
    dp = mesh.shape[0]
    _prepare(list(mesh.ravel()))
    rows = [list(mesh[ci % dp]) for ci in range(len(clips))]
    encs = []
    for row in rows:
        enc = Encoder(H.Info(**info_kwargs), quant=quant,
                      complexity=complexity, device=row[0], **enc_kwargs)
        enc.device_put_fn = named_put(np.array(row, dtype=object),
                                      (None, "sp"))
        encs.append(enc)
    outs = [[] for _ in clips]
    if threads is None:
        threads = len(clips) > 1
    if threads:
        errs = [None] * len(clips)

        def run_clip(ci):
            try:
                with _on(rows[ci]):
                    for fr in clips[ci]:
                        outs[ci].extend(encs[ci].encode_frame(fr))
                    outs[ci].extend(encs[ci].flush())
                    for dev in dict.fromkeys(rows[ci]):
                        if dev.type == "cuda":
                            torch.cuda.current_stream(dev).synchronize()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs[ci] = e

        workers = [threading.Thread(target=run_clip, args=(ci,))
                   for ci in range(len(clips))]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        for e in errs:
            if e is not None:
                raise e
        return outs
    nfr = max(len(c) for c in clips)
    for t in range(nfr):
        for ci, frames in enumerate(clips):
            if t < len(frames):
                outs[ci].extend(encs[ci].encode_frame(frames[t]))
    for ci in range(len(clips)):
        outs[ci].extend(encs[ci].flush())
    return outs
