"""YUV4MPEG2 (.y4m) reader/writer (reference: tools/vidinput.c,
examples/encoder_example.c:184-448).  High-depth variants (C420p10,
C420p12, ...) carry 16-bit little-endian samples."""

from __future__ import annotations

import numpy as np

_CHROMA_DEC = {
    "420": ((0, 0), (1, 1), (1, 1)),
    "420jpeg": ((0, 0), (1, 1), (1, 1)),
    "420mpeg2": ((0, 0), (1, 1), (1, 1)),
    "422": ((0, 0), (1, 0), (1, 0)),
    "444": ((0, 0), (0, 0), (0, 0)),
    "mono": ((0, 0),),
}


def _parse_chroma(tag):
    """(base_chroma, bitdepth) from a y4m C tag, e.g. '420p10' ->
    ('420', 10) (reference: examples/encoder_example.c:239-369)."""
    import re
    tag = tag.lower()
    m = re.fullmatch(r"(.*?)p(\d+)", tag)
    if m:
        return m.group(1), int(m.group(2))
    return tag, 8


class Y4MReader:
    def __init__(self, path):
        self.f = open(path, "rb")
        header = self.f.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m file")
        self.width = self.height = 0
        self.fps = (30, 1)
        self.aspect = (0, 0)
        self.chroma = "420"
        self.depth = 8
        for tok in header.split()[1:]:
            k, v = tok[0], tok[1:]
            if k == "W":
                self.width = int(v)
            elif k == "H":
                self.height = int(v)
            elif k == "F":
                a, b = v.split(":")
                self.fps = (int(a), int(b))
            elif k == "A":
                a, b = v.split(":")
                self.aspect = (int(a), int(b))
            elif k == "C":
                self.chroma, self.depth = _parse_chroma(v)
        if self.chroma not in _CHROMA_DEC:
            raise ValueError("unsupported chroma %s" % self.chroma)
        self.dec = _CHROMA_DEC[self.chroma]
        self.nplanes = len(self.dec)

    def read_frame(self):
        line = self.f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError("bad frame marker")
        nbytes = 2 if self.depth > 8 else 1
        dt = np.dtype("<u2") if self.depth > 8 else np.uint8
        planes = []
        for (xd, yd) in self.dec:
            w = (self.width + (1 << xd) - 1) >> xd
            h = (self.height + (1 << yd) - 1) >> yd
            data = self.f.read(w * h * nbytes)
            if len(data) < w * h * nbytes:
                return None
            planes.append(np.frombuffer(data, dt).reshape(h, w))
        return planes

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self):
        self.f.close()


class Y4MWriter:
    def __init__(self, path, width, height, fps=(30, 1), chroma="420",
                 aspect=(0, 0), depth=8):
        self.f = open(path, "wb")
        base, cdepth = _parse_chroma(chroma)
        self.depth = depth if depth != 8 else cdepth
        self.dec = _CHROMA_DEC[base]
        ctag = {"420": " C420jpeg", "422": " C422", "444": " C444",
                "mono": " Cmono"}.get(base, " C420jpeg")
        if self.depth > 8:
            ctag = " C%sp%d" % (base, self.depth)
        self.f.write(("YUV4MPEG2 W%d H%d F%d:%d Ip A%d:%d%s\n"
                      % (width, height, fps[0], fps[1], aspect[0],
                         aspect[1], ctag)).encode())

    def write_frame(self, planes):
        self.f.write(b"FRAME\n")
        dt = np.dtype("<u2") if self.depth > 8 else np.uint8
        for p in planes:
            self.f.write(np.ascontiguousarray(p, dt).tobytes())

    def close(self):
        self.f.close()
