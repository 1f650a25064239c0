"""CLI decoder: Ogg/Daala -> y4m with the port's device back end, the
counterpart of the JAX package's tools/decode.py (the reference's
dump_video, reference: examples/dump_video.c).

Usage, from the repository root:

    python -m daala_tpu_torch.tools.decode in.ogv out.y4m [--seek T]
        [--device cuda|cpu]

The native engine parses each frame and the port's Decoder reconstructs
it on --device (default "cuda": models/synthesis.py and the batched
dering of models/restore.py; without a card it exits with the
resolver's message and writes nothing).  Its frames equal the host
decoder's.  --seek T starts at the keyframe before time T seconds,
found from the granule positions, and writes the frames from T on.
"""

from __future__ import annotations

import argparse
import sys
import time

from daala_tpu_torch.codec import headers as H
from daala_tpu_torch.codec.decoder import Decoder
from daala_tpu_torch.device import resolve
from daala_tpu_torch.utils import granule as G
from daala_tpu_torch.utils.ogg import read_ogg_packets
from daala_tpu_torch.utils.y4m import Y4MWriter


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="daala_tpu_torch.tools.decode",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("input", help="input .ogv")
    ap.add_argument("output", help="output .y4m")
    ap.add_argument("--seek", type=float, default=None, metavar="T",
                    help="start decoding at the keyframe preceding time "
                         "T seconds (uses the keyframe-shift granulepos "
                         "packing, reference: src/state.c:1010-1040)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decoder's back end "
                         "(default: the card; no fallback)")
    return ap.parse_args(argv)


def _seek_start(path, t):
    """(index of the first video packet to feed the decoder, number of
    display frames to drop) for a seek to `t` seconds: the target frame
    and its preceding keyframe from the granule positions (the
    keyframe's time lives in the high bits)."""
    tmp_info = None
    vidx = 0
    key_of_target = 0
    target = None
    with open(path, "rb") as f:
        for data, gp in read_ogg_packets(f):
            if data and (data[0] & 0x80):
                tmp_info, _ = H.decode_header(data, tmp_info)
                continue
            if target is None and gp >= 0 \
                    and G.granule_time(tmp_info, gp) >= t:
                target = G.granule_basetime(tmp_info, gp)
                key_of_target = G.granule_keytime(tmp_info, gp)
                break
            vidx += 1
    if target is None:
        target = vidx
        key_of_target = 0
    return key_of_target, target - key_of_target


def _writer(path, info):
    chroma = "420"
    if info.nplanes >= 2 and info.plane_dec[1] == (0, 0):
        chroma = "444"
    elif info.nplanes == 1:
        chroma = "mono"
    return Y4MWriter(path, info.pic_width, info.pic_height,
                     fps=(info.timebase_numerator,
                          info.timebase_denominator),
                     chroma=chroma,
                     aspect=(info.pixel_aspect_numerator,
                             info.pixel_aspect_denominator),
                     depth=8 + 2 * (info.bitdepth_mode - 1))


def main(argv=None):
    args = parse_args(argv)
    try:
        device = resolve(args.device)
    except (RuntimeError, ValueError) as e:
        sys.exit("daala_tpu_torch.tools.decode: %s" % e)
    info = None
    dec = None
    wr = None
    n = 0
    start_index = 0   # first video packet to feed the decoder
    emit_from = 0     # first display frame to write
    if args.seek is not None:
        start_index, emit_from = _seek_start(args.input, args.seek)
    vcount = 0
    t0 = time.time()
    with open(args.input, "rb") as f:
        for data, gp in read_ogg_packets(f):
            # Header packets have the MSB of the first byte set; the first
            # coded bit of every video packet is 0 (reference:
            # src/internal.c:662 daala_packet_isheader).
            if data and (data[0] & 0x80):
                info, kind = H.decode_header(data, info)
                if kind == "setup":
                    dec = Decoder(info, device=device)
                    wr = _writer(args.output, info)
                continue
            vcount += 1
            if vcount - 1 < start_index:
                continue
            if args.seek is not None and vcount - 1 == start_index:
                dec.sync_to_packet(data)
            for planes in dec.decode_packet(data):
                if emit_from > 0:
                    emit_from -= 1
                    continue
                wr.write_frame(planes)
                n += 1
    wr.close()
    dt = time.time() - t0
    print("decoded %d frames in %.2fs (%.2f fps)" % (n, dt, n / dt))


if __name__ == "__main__":
    main()
