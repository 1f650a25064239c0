"""Granule-position math and packet classification.

Mirrors the reference's granule API (reference: src/state.c:1010-1040,
src/internal.c:662-669): a granule position packs the last keyframe's
base time in the high bits (above keyframe_granule_shift) and the frame
delta since that keyframe in the low bits, so a seek can locate the
preceding keyframe directly from any page's granulepos."""

from __future__ import annotations


def packet_isheader(pkt: bytes) -> int:
    """daala_packet_isheader (reference: src/internal.c:662-664)."""
    return (pkt[0] >> 7) if pkt else 0


def packet_iskeyframe(pkt: bytes) -> int:
    """daala_packet_iskeyframe (reference: src/internal.c:666-668)."""
    return (pkt[0] & 0x40) if pkt else 0


def granule_pack(key_time: int, delta: int, shift: int) -> int:
    return (key_time << shift) + delta


def granule_basetime(info, granpos: int) -> int:
    """daala_granule_basetime (reference: src/state.c:1010-1023)."""
    if granpos < 0:
        return -1
    shift = info.keyframe_granule_shift
    key_time = granpos >> shift
    delta = granpos - (key_time << shift)
    return key_time + delta


def granule_keytime(info, granpos: int) -> int:
    """Base time of the keyframe this granule position belongs to."""
    if granpos < 0:
        return -1
    return granpos >> info.keyframe_granule_shift


def granule_time(info, granpos: int) -> float:
    """daala_granule_time (reference: src/state.c:1025-1037): seconds."""
    base = granule_basetime(info, granpos)
    if base < 0:
        return -1.0
    return base * info.timebase_denominator / info.timebase_numerator


class GranuleTracker:
    """Encoder-side granulepos assignment: packets are stamped in coding
    order with (last keyframe time << shift) + delta, monotonic in mux
    order (the reference encoder tracks cur_time the same way,
    src/encode.c:3179,3304)."""

    def __init__(self, info):
        self.shift = info.keyframe_granule_shift
        self.cur_time = -1
        self.key_time = 0

    def stamp(self, pkt: bytes) -> int:
        self.cur_time += 1
        if packet_iskeyframe(pkt):
            self.key_time = self.cur_time
        return granule_pack(self.key_time, self.cur_time - self.key_time,
                            self.shift)
