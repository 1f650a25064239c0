"""Stream header packets: info (0x80), comment (0x81), setup (0x82).

Byte-compatible with the reference (reference: src/infoenc.c:32-119,
src/infodec.c:70-221).  All multi-byte fields are little-endian
(reference: src/internal.c oggbyte_write4).

The port's copy of daala_tpu/codec/headers.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class Info:
    """daala_info equivalent (reference: include/daala/codec.h:204-235)."""
    version_major: int = 0
    version_minor: int = 0
    version_sub: int = 0
    pic_width: int = 0
    pic_height: int = 0
    pixel_aspect_numerator: int = 0
    pixel_aspect_denominator: int = 0
    timebase_numerator: int = 30
    timebase_denominator: int = 1
    frame_duration: int = 1
    keyframe_granule_shift: int = 31
    bitdepth_mode: int = 1  # OD_BITDEPTH_MODE_8
    full_precision_references: int = 0
    nplanes: int = 3
    plane_dec: tuple = (((0, 0), (1, 1), (1, 1), (0, 0)))
    keyframe_rate: int = 256

    @property
    def frame_width(self):
        return (self.pic_width + 63) & ~63

    @property
    def frame_height(self):
        return (self.pic_height + 63) & ~63


VENDOR = "Xiph's experimental encoder library"


def encode_info_header(info: Info) -> bytes:
    out = bytearray()
    out.append(0x80)
    out += b"daala"
    out += bytes([info.version_major, info.version_minor, info.version_sub])
    out += struct.pack("<iiIIIII", info.pic_width, info.pic_height,
                       info.pixel_aspect_numerator,
                       info.pixel_aspect_denominator,
                       info.timebase_numerator,
                       info.timebase_denominator,
                       info.frame_duration)
    out.append(info.keyframe_granule_shift)
    out.append(info.bitdepth_mode)
    out.append(info.full_precision_references)
    out.append(info.nplanes)
    for pli in range(info.nplanes):
        out.append(info.plane_dec[pli][0])
        out.append(info.plane_dec[pli][1])
    return bytes(out)


def encode_comment_header(comments=()) -> bytes:
    out = bytearray()
    out.append(0x81)
    out += b"daala"
    v = VENDOR.encode()
    out += struct.pack("<I", len(v))
    out += v
    out += struct.pack("<I", len(comments))
    for c in comments:
        cb = c.encode() if isinstance(c, str) else c
        out += struct.pack("<I", len(cb))
        out += cb
    return bytes(out)


def encode_setup_header() -> bytes:
    return b"\x82daala"


def decode_header(packet: bytes, info: Info | None):
    """daala_decode_header_in equivalent: returns (info, kind) where kind
    is 'info' | 'comment' | 'setup' (reference: src/infodec.c:111-221)."""
    if len(packet) < 6 or packet[1:6] != b"daala":
        raise ValueError("not a daala header packet")
    kind = packet[0]
    if kind == 0x80:
        info = Info()
        (info.version_major, info.version_minor, info.version_sub) = \
            packet[6], packet[7], packet[8]
        (info.pic_width, info.pic_height, info.pixel_aspect_numerator,
         info.pixel_aspect_denominator, info.timebase_numerator,
         info.timebase_denominator, info.frame_duration) = \
            struct.unpack_from("<iiIIIII", packet, 9)
        pos = 9 + 28
        info.keyframe_granule_shift = packet[pos]
        info.bitdepth_mode = packet[pos + 1]
        info.full_precision_references = packet[pos + 2]
        info.nplanes = packet[pos + 3]
        pos += 4
        dec = []
        for _ in range(info.nplanes):
            dec.append((packet[pos], packet[pos + 1]))
            pos += 2
        while len(dec) < 4:
            dec.append((0, 0))
        info.plane_dec = tuple(dec)
        return info, "info"
    if kind == 0x81:
        return info, "comment"
    if kind == 0x82:
        return info, "setup"
    raise ValueError("unknown header packet type 0x%02x" % kind)
