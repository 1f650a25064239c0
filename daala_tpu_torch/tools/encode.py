"""CLI encoder: y4m -> Ogg/Daala on a torch device, the counterpart of
the JAX package's tools/encode.py (the reference's encoder_example,
reference: examples/encoder_example.c).

Usage, from the repository root:

    python -m daala_tpu_torch.tools.encode in.y4m out.ogv [-v 15]
        [--config analysis|device|device+sweep] [--device cuda|cpu] ...

It takes every flag of tools/encode.py with the same defaults and
meaning, and two more:

  --device  the torch device of the encoder's device tier (default
            "cuda"; without a card it exits with the resolver's message
            and writes nothing: nothing falls back to the CPU)
  --config  the device tier, one of daala_tpu_torch/bench.py's CONFIGS:
            "analysis" (the default: the device analysis planes feed the
            host entropy pass, and the stream is the JAX CLI's byte for
            byte), "device" (the lean tier, the PVQ search on the
            device) or "device+sweep" (the lean tier with the
            colour-sweep MV refinement)

With --workers N > 1 the clip's keyframe-aligned segments encode in N
spawned processes (parallel/mesh.py encode_clip_parallel), each on
--device, with the same Info and Encoder options as the serial path
(bit depth, -z, --qm, activity masking, the MV flags and --check
included); --two-pass does not combine with it.  The closing line is
the host wall of the encode, which on a first run includes the
kernels' build.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from daala_tpu_torch.bench import CONFIGS
from daala_tpu_torch.codec import headers as H
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.device import resolve
from daala_tpu_torch.utils.granule import GranuleTracker
from daala_tpu_torch.utils.ogg import OggPageWriter
from daala_tpu_torch.utils.y4m import Y4MReader


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="daala_tpu_torch.tools.encode",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("input", help="input .y4m")
    ap.add_argument("output", help="output .ogv")
    ap.add_argument("-v", "--video-quality", type=int, default=10,
                    help="0 = lossless, 1..511 coarser (like the "
                         "reference's -v)")
    ap.add_argument("-k", "--keyframe-rate", type=int, default=256)
    ap.add_argument("--limit", type=int, default=0,
                    help="max frames to encode (0 = all)")
    ap.add_argument("--no-dering", action="store_true")
    ap.add_argument("-b", "--b-frames", type=int, default=0,
                    help="number of B-frames between P-frames (0..4)")
    ap.add_argument("--bitrate", type=int, default=0,
                    help="target bitrate in bits/s (enables CBR)")
    ap.add_argument("--check", action="store_true",
                    help="re-decode every packet with an embedded decoder "
                         "and verify the reconstruction matches "
                         "(like the reference's --enable-encoder-check)")
    ap.add_argument("-z", "--complexity", type=int, default=7,
                    help="encoder complexity 0..10 (like the reference's "
                         "-z; gates block-size RDO and the ME stages)")
    ap.add_argument("--qm", type=int, choices=(0, 1), default=1,
                    help="quantization matrix: 0 = flat, 1 = HVS "
                         "(reference's --qm)")
    ap.add_argument("--fast-trial", action="store_true", default=True,
                    help="fast block-size RDO trial pass (speed=2 "
                         "projection-only PVQ candidates + closed-form "
                         "rates; BD-neutral, final pass stays exact). "
                         "ON by default; --exact-trial restores the "
                         "reference-identical trial pass")
    ap.add_argument("--exact-trial", dest="fast_trial",
                    action="store_false",
                    help="exact (reference-identical) block-size RDO "
                         "trial pass instead of the fast preset")
    ap.add_argument("--trial-prune-boost", type=float, default=3.0,
                    help="with --fast-trial: scale on the fitted "
                         "subtree-prune envelopes, rate-gated to "
                         "mostly-skip nodes (1.0 disables)")
    ap.add_argument("--no-activity-masking", action="store_true",
                    help="disable perceptual activity masking "
                         "(reference's --activity-masking 0)")
    ap.add_argument("--mv-level-max", type=int, default=None,
                    help="maximum MV mesh subdivision level (0..6)")
    ap.add_argument("--mv-level-min", type=int, default=0,
                    help="minimum (forced) MV mesh subdivision level "
                         "(reference's OD_SET_MV_LEVEL_MIN)")
    ap.add_argument("--mv-res-min", type=int, default=0,
                    choices=(0, 1, 2),
                    help="minimum (coarsest-allowed bound on) MV "
                         "resolution: 0 = 1/8 pel .. 2 = 1/2 pel "
                         "(reference's OD_SET_MV_RES_MIN)")
    ap.add_argument("--mv-pipeline", type=int, default=None,
                    choices=(0, 1, 2, 3, 5),
                    help="MV mesh pipeline override (mv_decimate knob): "
                         "0 greedy split, 1 optimistic split + "
                         "decimate, 5 subdivide-all -> refine -> "
                         "decimate -> refine (default: 5 at complexity "
                         ">= 8, else 0)")
    ap.add_argument("--mv-satd", action="store_true",
                    help="Hadamard SATD cells in the MV refinement "
                         "objective (reference's OD_ENC_USE_SATD)")
    ap.add_argument("--two-pass", metavar="STATS", default=None,
                    help="two-pass rate control: first run (stats file "
                         "absent) records per-frame metrics to STATS; "
                         "second run (file present, with --bitrate) "
                         "allocates bits using them. The reference "
                         "only stubs this API.")
    ap.add_argument("--workers", type=int, default=0,
                    help="encode keyframe-aligned segments in N parallel "
                         "processes (keyframe rate is capped to the "
                         "segment length, a multiple of 16)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoder's device tier "
                         "(default: the card; no fallback)")
    ap.add_argument("--config", choices=tuple(CONFIGS), default="analysis",
                    help="device tier (daala_tpu_torch/bench.py CONFIGS): "
                         "analysis (the JAX CLI's stream byte for byte), "
                         "device (the lean PVQ search) or device+sweep")
    return ap.parse_args(argv)


class _To420:
    """A 4:2:2 reader's frames with chroma row pairs averaged to 4:2:0
    (an odd height repeats the last row)."""

    def __init__(self, rd):
        self._rd = rd
        self.width = rd.width
        self.height = rd.height
        self.nplanes = rd.nplanes
        self.fps = rd.fps
        self.aspect = rd.aspect
        self.depth = rd.depth

    def __iter__(self):
        for planes in self._rd:
            out = [planes[0]]
            for p in planes[1:]:
                p16 = p.astype(np.uint16)
                if len(p16) & 1:
                    p16 = np.vstack([p16, p16[-1:]])
                out.append(((p16[0::2] + p16[1::2] + 1) >> 1)
                           .astype(p.dtype))
            yield out


def _frames(rd, limit):
    n = 0
    for planes in rd:
        yield planes
        n += 1
        if limit and n >= limit:
            return


def _report(n, dt, rd):
    print("encoded %d frames in %.2fs (%.2f fps, %.3f Mpix/s)"
          % (n, dt, n / dt, n * rd.width * rd.height / dt / 1e6))


def main(argv=None):
    args = parse_args(argv)
    try:
        device = resolve(args.device)
    except (RuntimeError, ValueError) as e:
        sys.exit("daala_tpu_torch.tools.encode: %s" % e)
    if args.workers > 1 and args.two_pass:
        sys.exit("--two-pass does not combine with --workers: each segment "
                 "would run its own rate control")
    rd = Y4MReader(args.input)
    dec = tuple(rd.dec) + (((0, 0),) if rd.nplanes == 3 else ())
    # The daala format supports only square chroma decimation (the
    # reference decoder asserts xdec == ydec, src/decode.c:617,734).
    # Convert 4:2:2 input to 4:2:0 by averaging chroma row pairs, like
    # running the clip through a format converter first.
    if any(d[0] != d[1] for d in dec[:rd.nplanes]):
        print("input is 4:2:2; converting chroma to 4:2:0 "
              "(the daala format supports 4:2:0/4:4:4 only)",
              file=sys.stderr)
        dec = ((0, 0),) + ((1, 1),) * (rd.nplanes - 1)
        if rd.nplanes == 3:
            dec = dec + ((0, 0),)
        rd = _To420(rd)
    depth = getattr(rd, "depth", 8)
    if depth not in (8, 10, 12):
        sys.exit("unsupported input bit depth %d (the daala format "
                 "codes 8/10/12-bit, reference: "
                 "include/daala/codec.h:196-200)" % depth)
    info_kwargs = dict(pic_width=rd.width, pic_height=rd.height,
                       nplanes=rd.nplanes, plane_dec=dec,
                       keyframe_rate=args.keyframe_rate,
                       timebase_numerator=rd.fps[0],
                       timebase_denominator=rd.fps[1],
                       pixel_aspect_numerator=rd.aspect[0],
                       pixel_aspect_denominator=rd.aspect[1],
                       bitdepth_mode=1 + (depth - 8) // 2,
                       # High depth requires full-precision references
                       # (reference: src/state.c:370-373).
                       full_precision_references=1 if depth > 8 else 0)
    info = H.Info(**info_kwargs)
    two_pass_writing = False
    if args.two_pass and os.path.exists(args.two_pass):
        if not args.bitrate:
            sys.exit("--two-pass second run requires --bitrate")
    elif args.two_pass:
        two_pass_writing = True
    enc_kwargs = dict(quant=args.video_quality, complexity=args.complexity,
                      qm=args.qm,
                      use_activity_masking=not args.no_activity_masking,
                      use_dering=not args.no_dering,
                      bitrate=args.bitrate if not two_pass_writing else 0,
                      trial_rate_approx=args.fast_trial,
                      trial_prune_boost=args.trial_prune_boost,
                      device=str(device), **CONFIGS[args.config])
    # The switches the Encoder takes as attributes.
    enc_attrs = dict(b_frames=args.b_frames, mv_res_min=args.mv_res_min,
                     mv_level_min=args.mv_level_min,
                     enable_encoder_check=args.check)
    if args.mv_level_max is not None:
        enc_attrs["mv_max_level"] = args.mv_level_max
    if args.mv_pipeline is not None:
        enc_attrs["mv_decimate"] = args.mv_pipeline
    if args.mv_satd:
        enc_attrs["mv_satd"] = 1
    if args.workers > 1:
        # Segment-parallel: read the clip, fan segments out to spawned
        # processes (parallel/mesh.py), then mux in order.
        from daala_tpu_torch.parallel.mesh import encode_clip_parallel
        seg = max(16, min(args.keyframe_rate, 64) // 16 * 16)
        info_kwargs["keyframe_rate"] = min(args.keyframe_rate, seg)
        frames = list(_frames(rd, args.limit))
        t0 = time.time()
        pkts = encode_clip_parallel(frames, info_kwargs, enc_kwargs,
                                    segment_len=seg, workers=args.workers,
                                    enc_attrs=enc_attrs)
        enc = Encoder(H.Info(**info_kwargs), **enc_kwargs)
        with open(args.output, "wb") as f:
            ogg = OggPageWriter(f, serial=0x0da1a)
            for hpkt in enc.flush_headers():
                ogg.add_packet(hpkt, 0, flush=True)
            gt = GranuleTracker(info)
            for pkt in pkts:
                ogg.add_packet(pkt, gt.stamp(pkt), flush=True)
            ogg.close()
        _report(len(frames), time.time() - t0, rd)
        return
    enc = Encoder(info, **enc_kwargs)
    for name, value in enc_attrs.items():
        setattr(enc, name, value)
    if args.two_pass and not two_pass_writing:
        with open(args.two_pass, "rb") as f:
            enc.rc.twopass_in(f.read())
    elif two_pass_writing:
        enc.record_pass1 = True
    with open(args.output, "wb") as f:
        ogg = OggPageWriter(f, serial=0x0da1a)
        for hpkt in enc.flush_headers():
            ogg.add_packet(hpkt, 0, flush=True)
        gt = GranuleTracker(info)
        n = 0
        t0 = time.time()
        for planes in _frames(rd, args.limit):
            for pkt in enc.encode_frame(planes):
                ogg.add_packet(pkt, gt.stamp(pkt), flush=True)
            n += 1
        for pkt in enc.flush():
            ogg.add_packet(pkt, gt.stamp(pkt), flush=True)
        ogg.close()
    if two_pass_writing:
        with open(args.two_pass, "wb") as f:
            f.write(enc.rc.twopass_out())
        print("wrote first-pass stats to %s" % args.two_pass)
    _report(n, time.time() - t0, rd)


if __name__ == "__main__":
    main()
