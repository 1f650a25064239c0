"""Multi-device scaling: the counterpart of daala_tpu/parallel/mesh.py.

Two independent axes of parallelism, reflecting the codec's structure
(SURVEY.md section 7: the only irreducibly sequential parts are the range
coder and cross-block adaptation; everything else batches):

1. **Device mesh** for the uniform-quantizer pipeline
   (models/analysis.py) and the batched multi-clip encode: clips and
   frames go to the rows (`dp`) of a (dp, sp) array of torch devices.
   JAX also shards frame columns over `sp`, with XLA inserting the halo
   collectives; torch has nothing that inserts them, so the port's mesh
   has one column, and `sp > 1` raises (ROADMAP.md, multi-GPU batching).

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


# -- 1. device mesh ---------------------------------------------------------

def make_mesh(n_devices=None, dp=None, *, devices=None):
    """A (dp, sp) numpy array of torch.devices: the first `n_devices` of
    `devices` (default: every CUDA card; raises RuntimeError without
    one), dp rows of sp = n_devices // dp columns, dp = n_devices by
    default.  sp > 1 raises NotImplementedError."""
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
    dp = n if dp is None else dp
    if dp < 1 or n % dp:
        raise ValueError("make_mesh: dp=%d does not divide %d devices"
                         % (dp, n))
    if n // dp > 1:
        raise NotImplementedError(
            "make_mesh: sp=%d; the port's mesh has one column (no halo "
            "collectives shard a frame's columns yet: ROADMAP.md, "
            "multi-GPU batching)" % (n // dp))
    mesh = np.empty((dp, 1), dtype=object)
    for i in range(dp):
        mesh[i, 0] = devs[i]
    return mesh


def _rows(mesh):
    dp, sp = mesh.shape
    if sp != 1:
        raise NotImplementedError("the port's mesh has one column, got "
                                  "sp=%d" % sp)
    return [mesh[i, 0] for i in range(dp)]


def shard_batch(frames_u8, mesh):
    """Split a (B, H, W) uint8 batch (numpy or tensor) over the mesh's
    rows: a list of dp (B / dp, H, W) tensors, one on each row's device."""
    rows = _rows(mesh)
    frames = (frames_u8 if isinstance(frames_u8, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(frames_u8)))
    if frames.dim() != 3 or frames.dtype != torch.uint8:
        raise ValueError("shard_batch takes a (B, H, W) uint8 batch, got "
                         "%s %s" % (frames.dtype, tuple(frames.shape)))
    if frames.shape[0] % len(rows):
        raise ValueError("shard_batch: %d frames do not split over %d rows"
                         % (frames.shape[0], len(rows)))
    return [part.to(dev) for part, dev in
            zip(frames.chunk(len(rows)), rows)]


def batch_encode_step(shards, bs=1, quant=3840):
    """models/analysis.py encode_step over a batch split into shards
    (shard_batch's list of (b, H, W) uint8 tensors), each frame on its
    shard's device.  Returns (rec, sse, nz): rec a list of the shards'
    uint8 reconstructions, sse and nz Python ints, the sums over the
    batch with JAX's int32 wrap."""
    recs, sums = [], []
    for shard in shards:
        outs = [encode_step(f, bs=bs, quant=quant) for f in shard]
        recs.append(torch.stack([o[0] for o in outs]))
        sums.append((torch.stack([o[1] for o in outs]).to(torch.int64).sum(),
                     torch.stack([o[2] for o in outs]).to(torch.int64).sum()))
    # Fetched after every shard's work is issued.
    sse = sum(int(s) for s, _ in sums)
    nz = sum(int(z) for _, z in sums)
    return recs, int(wrap32(sse)), int(wrap32(nz))


# -- 2. host segment parallelism --------------------------------------------

def _encode_segment(args):
    (frames, info_kwargs, enc_kwargs, b_frames) = args
    from daala_tpu_torch.codec import headers as H
    from daala_tpu_torch.codec.encoder import Encoder
    info = H.Info(**info_kwargs)
    enc = Encoder(info, **enc_kwargs)
    enc.b_frames = b_frames
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
                         segment_len=32, workers=None):
    """Encode a clip with keyframe-aligned segments in parallel processes.

    frames: list of per-frame plane lists.  Each segment starts with a
    keyframe (adaptation and reference state fully reset), so packets
    from consecutive segments concatenate into a conformant stream.
    segment_len must be a multiple of 16 (OD_MAX_REORDER) so the coded
    display numbering stays aligned across segment boundaries.
    enc_kwargs go to the port's Encoder, `device` among them (default:
    the card).  The workers are spawned, not forked (a process forked
    after CUDA is initialised cannot use it), and share the host's cores.
    Returns the flat packet list in display order."""
    assert segment_len % 16 == 0
    enc_kwargs = dict(enc_kwargs or {})
    segs = [frames[i:i + segment_len]
            for i in range(0, len(frames), segment_len)]
    # Force a keyframe at each segment start by capping keyframe_rate.
    info_kwargs = dict(info_kwargs)
    info_kwargs.setdefault("keyframe_rate", segment_len)
    args = [(seg, info_kwargs, enc_kwargs, b_frames) for seg in segs]
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
def _on(dev):
    """The context a clip's thread runs in: its card and a stream of its
    own (nothing on the CPU)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
        yield


def encode_clips_batched(clips, info_kwargs, mesh, quant=18, complexity=7,
                         enc_kwargs=None, threads=None):
    """BASELINE.json config 5: N clips encoded by the REAL production
    encoder (trial-encode RDO, full entropy stage) with every device
    stage of the analysis tier (the SAD fields, the RDO transform
    pyramids, the final analysis, the dering candidates) on the mesh:
    clip ci on the device of row ci % dp.

    With threads (the default for >1 clip) each clip encodes on its own
    host thread, on its card and a CUDA stream of its own: clip B's
    device work is issued while clip A's host entropy stage runs,
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
    rows = _rows(mesh)
    _prepare(rows)
    devs = [rows[ci % len(rows)] for ci in range(len(clips))]
    encs = [Encoder(H.Info(**info_kwargs), quant=quant,
                    complexity=complexity, device=dev, **enc_kwargs)
            for dev in devs]
    outs = [[] for _ in clips]
    if threads is None:
        threads = len(clips) > 1
    if threads:
        errs = [None] * len(clips)

        def run_clip(ci):
            try:
                with _on(devs[ci]):
                    for fr in clips[ci]:
                        outs[ci].extend(encs[ci].encode_frame(fr))
                    outs[ci].extend(encs[ci].flush())
                    if devs[ci].type == "cuda":
                        torch.cuda.current_stream(devs[ci]).synchronize()
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
