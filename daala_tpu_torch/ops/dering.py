"""Directional deringing filter (the CDEF ancestor).

Mirrors od_dering (reference: src/dering.c:54-350): per-8x8 direction
detection by line-variance maximization, a 7-tap conditional-replacement
filter along the direction, then a 4-tap filter orthogonal to it with a
tighter threshold.  All filter arithmetic is int16 (reference uses int16_t
throughout; the input plane etmp is int16, reference: src/state.h:270).

The direction search and both filters are vectorized over entire 64x64
superblocks with numpy; the same formulation maps to a fused Pallas TPU
kernel (each candidate direction is a shifted-gather + square-reduce).

The port's copy of daala_tpu/ops/dering.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

import numpy as np

OD_FILT_BORDER = 3
OD_FILT_BSTRIDE = 64 + 2 * OD_FILT_BORDER
OD_DERING_VERY_LARGE = 30000
OD_DERING_GAIN_TABLE = [0, 0.5, 0.707, 1, 1.41, 2]

_DIV_TABLE = [0, 840, 420, 280, 210, 168, 140, 120, 105]

# Per-direction tap offsets as (dy, dx) (reference:
# src/dering.c:39-48, offsets are k*OD_FILT_BSTRIDE + j pairs).
DIRECTION_OFFSETS = [
    [(-1, 1), (-2, 2), (-3, 3)],
    [(0, 1), (-1, 2), (-1, 3)],
    [(0, 1), (0, 2), (0, 3)],
    [(0, 1), (1, 2), (1, 3)],
    [(1, 1), (2, 2), (3, 3)],
    [(1, 0), (2, 1), (3, 1)],
    [(1, 0), (2, 0), (3, 0)],
    [(1, 0), (2, -1), (3, -1)],
]

_THRESH_TABLE_Q8 = [128, 134, 150, 168, 188, 210, 234, 262,
                    292, 327, 365, 408, 455, 509, 569, 635,
                    710, 768]


def _i16(x):
    return x.astype(np.int16)


_DIR_IDX = None


def _dir_index_maps():
    """Precomputed (8, 8, 8) index maps for the 8 directional projections
    (reference: src/dering.c:54-62)."""
    global _DIR_IDX
    if _DIR_IDX is None:
        i = np.arange(8)[:, None] + np.zeros((1, 8), np.int64)
        j = np.arange(8)[None, :] + np.zeros((8, 1), np.int64)
        i = i.astype(np.int64)
        j = j.astype(np.int64)
        _DIR_IDX = np.stack([
            i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
            3 - i // 2 + j, j, i // 2 + j]).astype(np.int64)
    return _DIR_IDX


def dir_find8(block8, coeff_shift):
    """od_dir_find8 on one 8x8 int array; returns (dir, var)
    (reference: src/dering.c:61-125)."""
    x = (block8.astype(np.int64)) >> coeff_shift
    idx = _dir_index_maps()
    partial = [np.bincount(idx[d].ravel(), weights=x.ravel(),
                           minlength=15).astype(np.int64)
               for d in range(8)]
    cost = [0] * 8
    for i in range(8):
        cost[2] += int(partial[2][i]) ** 2
        cost[6] += int(partial[6][i]) ** 2
    cost[2] *= _DIV_TABLE[8]
    cost[6] *= _DIV_TABLE[8]
    for i in range(7):
        cost[0] += (int(partial[0][i]) ** 2
                    + int(partial[0][14 - i]) ** 2) * _DIV_TABLE[i + 1]
        cost[4] += (int(partial[4][i]) ** 2
                    + int(partial[4][14 - i]) ** 2) * _DIV_TABLE[i + 1]
    cost[0] += int(partial[0][7]) ** 2 * _DIV_TABLE[8]
    cost[4] += int(partial[4][7]) ** 2 * _DIV_TABLE[8]
    for i in range(1, 8, 2):
        for j in range(5):
            cost[i] += int(partial[i][3 + j]) ** 2
        cost[i] *= _DIV_TABLE[8]
        for j in range(3):
            cost[i] += (int(partial[i][j]) ** 2
                        + int(partial[i][10 - j]) ** 2) * _DIV_TABLE[2 * j + 2]
    # int32 wrap like the reference's int32_t cost accumulation.
    cost = [((c + (1 << 31)) % (1 << 32)) - (1 << 31) for c in cost]
    best_cost = 0
    best_dir = 0
    for i in range(8):
        if cost[i] > best_cost:
            best_cost = cost[i]
            best_dir = i
    # The subtraction is int32 in the reference and can wrap on
    # garbage-stream cost magnitudes; the wrap is observable through
    # the threshold table below, so replicate it exactly.
    diff = (best_cost - cost[(best_dir + 4) & 7]) & 0xFFFFFFFF
    if diff >= 1 << 31:
        diff -= 1 << 32
    var = diff >> 10
    return best_dir, var


def filter_direction(inb, ln, threshold, direction):
    """od_filter_dering_direction_c, vectorized over the (n, n) block.
    inb: int16 array with 3-pixel borders ((n+6, n+6), block at [3:3+n]).
    Returns filtered (n, n) int16."""
    n = 1 << ln
    taps = [3, 2, 1]
    xx = inb[3:3 + n, 3:3 + n].astype(np.int16)
    acc = np.zeros((n, n), np.int16)
    for k in range(3):
        dy, dx = DIRECTION_OFFSETS[direction][k]
        p0 = _i16(inb[3 + dy:3 + dy + n, 3 + dx:3 + dx + n]
                  .astype(np.int32) - xx)
        p1 = _i16(inb[3 - dy:3 - dy + n, 3 - dx:3 - dx + n]
                  .astype(np.int32) - xx)
        acc = _i16(acc + np.where(np.abs(p0.astype(np.int32)) < threshold,
                                  taps[k] * p0.astype(np.int32), 0))
        acc = _i16(acc + np.where(np.abs(p1.astype(np.int32)) < threshold,
                                  taps[k] * p1.astype(np.int32), 0))
    return _i16(xx.astype(np.int32) + ((acc.astype(np.int32) + 8) >> 4))


def filter_orthogonal(inb, x_orig, ln, threshold, direction):
    """od_filter_dering_orthogonal_c vectorized.  inb: bordered int16
    ((n+6, n+6)); x_orig: original (n, n) input."""
    n = 1 << ln
    if 0 < direction < 4:
        off = (1, 0)
    else:
        off = (0, 1)
    yy = inb[3:3 + n, 3:3 + n].astype(np.int32)
    athresh = np.minimum(
        threshold,
        threshold // 3 + np.abs(yy - x_orig.astype(np.int32)))
    acc = np.zeros((n, n), np.int16)
    for mult in (1, 2, -1, -2):
        dy, dx = off[0] * mult, off[1] * mult
        p = _i16(inb[3 + dy:3 + dy + n, 3 + dx:3 + dx + n]
                 .astype(np.int32) - yy)
        acc = _i16(acc + np.where(np.abs(p.astype(np.int32)) < athresh,
                                  p.astype(np.int32), 0))
    return _i16(yy + ((3 * acc.astype(np.int32) + 8) >> 4))


try:
    from daala_tpu_torch import native as _native
    _NLIB = _native.get_lib()
except Exception:  # pragma: no cover
    _NLIB = None


def _native_dering(plane_i16, sby, sbx, xdec, pli, bskip, threshold, n,
                   dirs, coeff_shift):
    if _NLIB is None:
        return None
    if (plane_i16.dtype != np.int16 or not plane_i16.flags.c_contiguous
            or bskip.dtype != np.uint8 or not bskip.flags.c_contiguous):
        return None
    bsize = 3 - xdec
    nb = n >> bsize
    if pli == 0:
        dirs = np.zeros((nb, nb), np.int32)
    else:
        if dirs is None:
            return None
        dirs = np.ascontiguousarray(dirs, np.int32)
        if dirs.shape != (nb, nb):
            return None
    out = np.empty((n, n), np.int16)
    _NLIB.ec_dering(plane_i16.ctypes.data, plane_i16.shape[0],
                    plane_i16.shape[1], sby, sbx, xdec, pli,
                    bskip.ctypes.data, bskip.shape[0], bskip.shape[1],
                    threshold, n, dirs.ctypes.data, coeff_shift,
                    out.ctypes.data, n)
    return out, dirs


def od_dering(plane_i16, sby, sbx, xdec, pli, bskip, threshold, n,
              dirs=None, coeff_shift=4):
    """Filter one deringing superblock; returns (filtered (n, n) int16,
    dirs) where dirs is the per-8x8 direction map (computed for luma,
    reused by chroma exactly as the reference shares the dir array across
    planes, reference: src/decode.c:1020-1080).

    plane_i16: full-plane int16 input (unfiltered copy); sby/sbx index the
    64-pixel grid; bskip: per-plane 4x4 skip map."""
    r = _native_dering(plane_i16, sby, sbx, xdec, pli, bskip, threshold,
                       n, dirs, coeff_shift)
    if r is not None:
        return r
    nhdr = plane_i16.shape[1] >> (6 - xdec)
    nvdr_ = plane_i16.shape[0] >> (6 - xdec)
    bsize = 3 - xdec
    nhb = nvb = n >> bsize
    # Build bordered input with VERY_LARGE outside-frame sentinel.
    inb = np.full((n + 2 * OD_FILT_BORDER, n + 2 * OD_FILT_BORDER),
                  OD_DERING_VERY_LARGE, np.int16)
    y0 = sby << (6 - xdec)
    x0 = sbx << (6 - xdec)
    i_lo = -OD_FILT_BORDER if sby != 0 else 0
    i_hi = n + (OD_FILT_BORDER if sby != nvdr_ - 1 else 0)
    j_lo = -OD_FILT_BORDER if sbx != 0 else 0
    j_hi = n + (OD_FILT_BORDER if sbx != nhdr - 1 else 0)
    inb[OD_FILT_BORDER + i_lo:OD_FILT_BORDER + i_hi,
        OD_FILT_BORDER + j_lo:OD_FILT_BORDER + j_hi] = \
        plane_i16[y0 + i_lo:y0 + i_hi, x0 + j_lo:x0 + j_hi]
    x_orig = plane_i16[y0:y0 + n, x0:x0 + n]
    thresh = np.zeros((nvb, nhb), np.int32)
    if pli == 0:
        dirs = np.zeros((nvb, nhb), np.int32)
        for by in range(nvb):
            for bx in range(nhb):
                d, var = dir_find8(x_orig[8 * by:8 * by + 8,
                                          8 * bx:8 * bx + 8], coeff_shift)
                dirs[by, bx] = d
                v1 = min(32767, var >> 6)
                if v1 < 0:
                    # Wrapped-negative variance: the reference computes
                    # OD_ILOG(v1) == 32 and reads past its 18-entry
                    # threshold table (an out-of-bounds read, upstream
                    # UB; reference: src/dering.c:241-248).  The bytes
                    # that follow in its .rodata are a negative int16
                    # (OD_DIRECTION_OFFSETS_TABLE), so the block goes
                    # unfiltered; emulate that deterministically.
                    thresh[by, bx] = 0
                else:
                    thresh[by, bx] = (threshold
                                      * _THRESH_TABLE_Q8[v1.bit_length()]
                                      + 128) >> 8
    else:
        assert dirs is not None, "chroma requires the luma direction map"
        thresh[:, :] = threshold
    # Skip logic (reference: src/dering.c:301-327, DAALA_ODINTRIN path).
    skip_stride_blocks = bskip.shape[1]
    for by in range(nvb):
        for bx in range(nhb):
            xstart = ystart = 0
            xend = yend = 2 >> xdec
            xstart -= int(sbx != 0)
            ystart -= int(sby != 0)
            xend += int(sbx != nhdr - 1)
            yend += int(sby != nvdr_ - 1)
            skip = 1
            for i in range(ystart, yend):
                for j in range(xstart, xend):
                    yy = (sby << (4 - xdec)) + (by << 1 >> xdec) + i
                    xx = (sbx << (4 - xdec)) + (bx << 1 >> xdec) + j
                    skip = skip and bskip[yy, xx]
            if skip:
                thresh[by, bx] = 0
    out = np.empty((n, n), np.int16)
    for by in range(nvb):
        for bx in range(nhb):
            b = 1 << bsize
            sub = inb[by * b:(by + 1) * b + 2 * OD_FILT_BORDER,
                      bx * b:(bx + 1) * b + 2 * OD_FILT_BORDER]
            out[by * b:(by + 1) * b, bx * b:(bx + 1) * b] = \
                filter_direction(sub, bsize + 0, int(thresh[by, bx]),
                                 int(dirs[by, bx]))
    # Second pass input: first-pass output with the same borders.
    inb2 = inb.copy()
    inb2[OD_FILT_BORDER:OD_FILT_BORDER + n,
         OD_FILT_BORDER:OD_FILT_BORDER + n] = out
    out2 = np.empty((n, n), np.int16)
    for by in range(nvb):
        for bx in range(nhb):
            b = 1 << bsize
            sub = inb2[by * b:(by + 1) * b + 2 * OD_FILT_BORDER,
                       bx * b:(bx + 1) * b + 2 * OD_FILT_BORDER]
            out2[by * b:(by + 1) * b, bx * b:(bx + 1) * b] = \
                filter_orthogonal(sub, x_orig[by * b:(by + 1) * b,
                                              bx * b:(bx + 1) * b],
                                  bsize + 0, int(thresh[by, bx]),
                                  int(dirs[by, bx]))
    return out2, dirs
