"""Debug image/reconstruction dump hooks.

Equivalent of the reference's OD_DUMP_IMAGES / OD_DUMP_RECONS builds
(reference: src/state.c:736-828 od_state_dump_yuv): when enabled via
environment variable, every tagged frame is appended to a per-tag y4m
file, so encodes and decodes can be inspected or diffed offline.

Environment:
  DAALA_TPU_DUMP_IMAGES=<dir>   dump decoder output / encoder input
  DAALA_TPU_DUMP_RECONS=<dir>   dump encoder reconstructions
  DAALA_TPU_DUMP_SUFFIX=<s>     filename suffix (OD_DUMP_IMAGES_SUFFIX)

The port's copy of daala_tpu/utils/dump.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

import os

import numpy as np

_files: dict = {}

_CHROMA_TAGS = {(1, 1): " C420jpeg", (0, 1): " C422", (1, 0): " C411",
                (0, 0): " C444"}


def images_dir():
    return os.environ.get("DAALA_TPU_DUMP_IMAGES")

def recons_dir():
    return os.environ.get("DAALA_TPU_DUMP_RECONS")


def dump_yuv(dirname, tag, planes, info):
    """Append one frame (list of uint8 planes, cropped to the picture
    size) to <dirname>/<tag><suffix>.y4m."""
    if not dirname:
        return
    suf = os.environ.get("DAALA_TPU_DUMP_SUFFIX", "")
    key = (dirname, tag)
    f = _files.get(key)
    pw, ph = info.pic_width, info.pic_height
    if f is None:
        os.makedirs(dirname, exist_ok=True)
        path = os.path.join(dirname, "%s%s.y4m" % (tag, suf))
        f = open(path, "wb")
        _files[key] = f
        xdec, ydec = (info.plane_dec[1] if info.nplanes > 1 else (1, 1))
        chroma = _CHROMA_TAGS.get((xdec, ydec), " C420jpeg")
        f.write(("YUV4MPEG2 W%d H%d F%d:%d Ip A%d:%d%s\n" % (
            pw, ph, info.timebase_numerator,
            info.timebase_denominator * max(1, info.frame_duration),
            info.pixel_aspect_numerator,
            info.pixel_aspect_denominator, chroma)).encode())
    f.write(b"FRAME\n")
    for pli, p in enumerate(planes[:3]):
        xd, yd = info.plane_dec[pli]
        a = np.asarray(p)[:(ph + (1 << yd) - 1) >> yd,
                          :(pw + (1 << xd) - 1) >> xd]
        f.write(np.ascontiguousarray(a, np.uint8).tobytes())
    f.flush()
