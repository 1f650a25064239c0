"""Minimal Ogg container mux/demux (RFC 3533), enough to carry Daala
streams like the reference examples do via libogg
(reference: examples/encoder_example.c:78-86, examples/dump_video.c).
"""

from __future__ import annotations

import struct

_CRC_TABLE = []


def _crc_init():
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if (r & 0x80000000) \
                else (r << 1) & 0xFFFFFFFF
        _CRC_TABLE.append(r)


_crc_init()


def _crc(data: bytes) -> int:
    r = 0
    for b in data:
        r = ((r << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((r >> 24) & 0xFF) ^ b]
    return r


class OggPageWriter:
    def __init__(self, f, serial):
        self.f = f
        self.serial = serial
        self.pageno = 0
        self._pending = []  # list of (packet_bytes, granulepos)
        self._first = True

    def add_packet(self, data: bytes, granulepos: int, flush=False,
                   eos=False):
        self._pending.append((data, granulepos))
        if flush or eos or sum(len(p) for p, _ in self._pending) > 4096:
            self._flush(eos)

    def _flush(self, eos=False):
        if not self._pending:
            return
        segs = bytearray()
        body = bytearray()
        gp = self._pending[-1][1]
        for data, _ in self._pending:
            n = len(data)
            while n >= 255:
                segs.append(255)
                n -= 255
            segs.append(n)
            body += data
        htype = 0
        if self._first:
            htype |= 2
            self._first = False
        if eos:
            htype |= 4
        header = struct.pack("<4sBBqIIi", b"OggS", 0, htype, gp,
                             self.serial, self.pageno, 0)
        header += bytes([len(segs)]) + bytes(segs)
        page = bytearray(header + bytes(body))
        crc = _crc(bytes(page))
        page[22:26] = struct.pack("<I", crc)
        self.f.write(bytes(page))
        self.pageno += 1
        self._pending = []

    def close(self, eos=True):
        self._flush(eos)


def read_ogg_packets(f):
    """Yield (packet_bytes, granulepos) from a single-stream Ogg file.
    granulepos is the page's value for the last packet completed on the
    page, else -1."""
    partial = b""
    while True:
        magic = f.read(4)
        if len(magic) < 4:
            return
        if magic != b"OggS":
            raise ValueError("bad ogg capture pattern")
        hdr = f.read(23)
        (version, htype, gp, serial, pageno, crc) = struct.unpack(
            "<BBqIIi", hdr[:22])
        nsegs = hdr[22]
        segtab = f.read(nsegs)
        completed = []
        for s in segtab:
            partial += f.read(s)
            if s < 255:
                completed.append(partial)
                partial = b""
        for i, data in enumerate(completed):
            yield data, (gp if i == len(completed) - 1 else -1)
