"""Overlapped Block Motion Compensation (shared encoder/decoder).

Mirrors the live paths of the reference MC (reference: src/mc.c,
src/state.c:612-960): 6-tap 1/8-pel subpel interpolation, bilinear OBMC
blending (full and split-edge variants; the multiresolution blender is
compiled out in the reference, src/mc.c:1941), and the recursive
adaptive-mesh prediction over the MV grid.

All per-block math is vectorized numpy over the block; the frame loop
walks 64x64 MV superblocks.  Reference images are stored as padded uint8
planes (OD_BUFFER_PADDING = 64 on each side, reference: src/state.h:100-109).

The port's copy of daala_tpu/codec/mc.py; tests/test_torch_copies.py
holds it to the original.  It loads the native engine at first use
(`_nlib`), not at import.
"""

from __future__ import annotations

import numpy as np

OD_LOG_MVBSIZE_MIN = 3
OD_LOG_MVBSIZE_MAX = 6
OD_LOG_MVB_DELTA0 = OD_LOG_MVBSIZE_MAX - OD_LOG_MVBSIZE_MIN
OD_MVB_DELTA0 = 1 << OD_LOG_MVB_DELTA0
OD_MVB_MASK = OD_MVB_DELTA0 - 1
OD_MC_LEVEL_MAX = 2 * OD_LOG_MVB_DELTA0
OD_BUFFER_PADDING = 64
OD_UMV_CLAMP = 32

OD_FRAME_GOLD = 0
OD_FRAME_PREV = 1
OD_FRAME_NEXT = 2
OD_FRAME_SELF = 3

# 6-tap windowed-sinc subpel filter set, Q7 (reference: src/mc.c:66-79).
SUBPEL_FILTER_SET = np.array([
    [0, 0, 128, 0, 0, 0],
    [1, -9, 122, 18, -5, 1],
    [3, -15, 112, 37, -11, 2],
    [3, -18, 97, 58, -15, 3],
    [4, -20, 80, 80, -20, 4],
    [3, -15, 58, 97, -18, 3],
    [2, -11, 37, 112, -15, 3],
    [1, -5, 18, 122, -9, 1],
], np.int32)

# Vertex offset tables (reference: src/state.c:587-626).
_OD_VERT_D = [0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 1, 0, -1, 1, 1, 0, -1, 0, 1,
              1, -1]
OD_VERT_DX = _OD_VERT_D[1:5]
OD_VERT_DY = _OD_VERT_D[0:4]
_DX_OFF = [[9, 1, 9, 1], [13, 13, 1, 1], [18, 1, 18, 1], [5, 5, 1, 1]]
_DY_OFF = [[4, 4, 0, 0], [8, 0, 8, 0], [12, 12, 0, 0], [17, 0, 17, 0]]
VERT_SETUP_DX = [[_OD_VERT_D[o:o + 4] for o in row] for row in _DX_OFF]
VERT_SETUP_DY = [[_OD_VERT_D[o:o + 4] for o in row] for row in _DY_OFF]


def div_pow2_re(x, shift):
    """OD_DIV_POW2_RE: divide by 2**shift rounding to even
    (reference: src/odintrin.h:149)."""
    if shift == 0:
        return x
    return (x + ((1 << shift) + ((x >> shift) & 1) - 1 >> 1)) >> shift


class RefImage:
    """One padded reference image: per-plane uint8 arrays with
    OD_BUFFER_PADDING margins (already >>dec for chroma).  With
    full-precision references (FPR), planes are uint16 at
    8 + OD_COEFF_SHIFT = 12 bits (reference: src/state.c:237-298)."""

    def __init__(self, info):
        self.info = info
        self.fpr = bool(getattr(info, "full_precision_references", 0))
        self.planes = []
        fw, fh = info.frame_width, info.frame_height
        fill = (128 << 4) if self.fpr else 128
        dtype = np.uint16 if self.fpr else np.uint8
        for pli in range(info.nplanes):
            xd, yd = info.plane_dec[pli]
            pad_x = OD_BUFFER_PADDING >> xd
            pad_y = OD_BUFFER_PADDING >> yd
            self.planes.append(np.full(((fh >> yd) + 2 * pad_y,
                                        (fw >> xd) + 2 * pad_x), fill,
                                       dtype))

    def plane_view(self, pli):
        """The visible region (no padding)."""
        xd, yd = self.info.plane_dec[pli]
        pad_x = OD_BUFFER_PADDING >> xd
        pad_y = OD_BUFFER_PADDING >> yd
        p = self.planes[pli]
        return p[pad_y:p.shape[0] - pad_y, pad_x:p.shape[1] - pad_x]

    def edge_ext(self):
        """od_img_edge_ext: replicate edges into the padding
        (reference: src/state.c:1102-1160)."""
        for pli in range(self.info.nplanes):
            xd, yd = self.info.plane_dec[pli]
            pad_x = OD_BUFFER_PADDING >> xd
            pad_y = OD_BUFFER_PADDING >> yd
            p = self.planes[pli]
            p[pad_y:-pad_y, :pad_x] = p[pad_y:-pad_y, pad_x:pad_x + 1]
            p[pad_y:-pad_y, -pad_x:] = p[pad_y:-pad_y, -pad_x - 1:-pad_x]
            p[:pad_y, :] = p[pad_y:pad_y + 1, :]
            p[-pad_y:, :] = p[-pad_y - 1:-pad_y, :]

    def blank(self):
        fill = (128 << 4) if self.fpr else 128
        for p in self.planes:
            p[:, :] = fill


def predict1fmv(plane_pad, pad, y0, x0, mvx, mvy, ny, nx):
    """od_mc_predict1fmv8_c (reference: src/mc.c:92-206): predict the
    (ny, nx) block whose top-left visible coordinate is (y0, x0) with the
    1/8-pel MV (mvx, mvy).  Returns uint8 (ny, nx)."""
    sy = pad + y0 + (mvy >> 3)
    sx = pad + x0 + (mvx >> 3)
    mvxf = mvx & 7
    mvyf = mvy & 7
    if not (mvxf or mvyf):
        return plane_pad[sy:sy + ny, sx:sx + nx].copy()
    fx = SUBPEL_FILTER_SET[mvxf]
    fy = SUBPEL_FILTER_SET[mvyf]
    # Stage 1: horizontal over rows [-2, ny+3).
    win = plane_pad[sy - 2:sy + ny + 3, sx - 2:sx + nx + 3].astype(np.int32)
    if mvxf:
        buff = np.zeros((ny + 5, nx), np.int32)
        for k in range(6):
            buff += win[:, k:k + nx] * int(fx[k])
        buff -= 128 << 7
    else:
        buff = (win[:, 2:2 + nx] << 7) - (128 << 7)
    buff = buff.astype(np.int16).astype(np.int32)
    # Stage 2: vertical.
    if mvyf:
        acc = np.zeros((ny, nx), np.int32)
        for k in range(6):
            acc += buff[k:k + ny, :] * int(fy[k])
        rnd3 = (1 << 13) + (128 << 14)
        out = (acc + rnd3) >> 14
    else:
        rnd4 = (1 << 6) + (128 << 7)
        out = (buff[2:2 + ny, :] + rnd4) >> 7
    return np.clip(out, 0, 255).astype(np.uint8)


def predict1fmv16(plane_pad, pad, y0, x0, mvx, mvy, ny, nx):
    """od_mc_predict1fmv16_c (reference: src/mc.c:219-340): the
    full-precision (12-bit) subpel prediction.  plane_pad: uint16."""
    sy = pad + y0 + (mvy >> 3)
    sx = pad + x0 + (mvx >> 3)
    mvxf = mvx & 7
    mvyf = mvy & 7
    if not (mvxf or mvyf):
        return plane_pad[sy:sy + ny, sx:sx + nx].copy()
    fx = SUBPEL_FILTER_SET[mvxf]
    fy = SUBPEL_FILTER_SET[mvyf]
    win = plane_pad[sy - 2:sy + ny + 3, sx - 2:sx + nx + 3] \
        .astype(np.int32)
    if mvxf:
        buff = np.zeros((ny + 5, nx), np.int32)
        for k in range(6):
            buff += win[:, k:k + nx] * int(fx[k])
        buff -= 128 << (4 + 7)  # OD_COEFF_SHIFT + OD_SUBPEL_COEFF_SCALE
    else:
        buff = (win[:, 2:2 + nx] - (128 << 4)) << 7
    # No int16 wrap in the FPR path (the reference buffers are int32).
    if mvyf:
        acc = np.zeros((ny, nx), np.int32)
        for k in range(6):
            acc += buff[k:k + ny, :] * int(fy[k])
        out = ((acc + (1 << 14 >> 1)) >> 14) + (128 << 4)
    else:
        out = ((buff[2:2 + ny, :] + (1 << 7 >> 1)) >> 7) + (128 << 4)
    return np.clip(out, 0, (1 << 12) - 1).astype(np.uint16)


def blend_full(preds, log_x, log_y):
    """od_mc_blend_full8_c (reference: src/mc.c:352-378).  preds: list of
    4 (ny, nx) uint8 arrays in rotation order TL,TR,BR,BL."""
    nx = 1 << log_x
    ny = 1 << log_y
    lb2 = log_x + log_y
    rnd = 1 << (lb2 - 1)
    i = np.arange(nx)[None, :]
    j = np.arange(ny)[:, None]
    p0 = preds[0].astype(np.int32)
    p1 = preds[1].astype(np.int32)
    p2 = preds[2].astype(np.int32)
    p3 = preds[3].astype(np.int32)
    a = (p0 << log_x) + (p1 - p0) * i
    b = (p3 << log_x) + (p2 - p3) * i
    return (((a << log_y) + (b - a) * j + rnd) >> lb2) \
        .astype(preds[0].dtype)


def _setup_s_split(oc, s, log_x, log_y):
    """od_mc_setup_s_split (reference: src/mc.c:1650-1698)."""
    lb2 = log_x + log_y
    s0 = [2 << lb2, 0, 0, 0]
    dsdi = [-(2 << log_x), 2 << log_x, 0, 0]
    dsdj = [-(2 << log_y), 0, 0, 2 << log_y]
    dd = [2, -2, 2, -2]
    if not (s & 1):
        k = (oc + 1) & 3
        s0[k] >>= 1
        s0[oc] += s0[k]
        dsdi[k] >>= 1
        dsdi[oc] += dsdi[k]
        dsdj[k] >>= 1
        dsdj[oc] += dsdj[k]
        dd[k] >>= 1
        dd[oc] += dd[k]
    if not (s & 2):
        k = (oc + 3) & 3
        s0[k] >>= 1
        s0[oc] += s0[k]
        dsdi[k] >>= 1
        dsdi[oc] += dsdi[k]
        dsdj[k] >>= 1
        dsdj[oc] += dsdj[k]
        dd[k] >>= 1
        dd[oc] += dd[k]
    return s0, dsdi, dsdj, dd


def blend_full_split(preds, oc, s, log_x, log_y):
    """od_mc_blend_full_split8_c (reference: src/mc.c:1700-1750)."""
    nx = 1 << log_x
    ny = 1 << log_y
    lb2p1 = log_x + log_y + 1
    rnd = 1 << (lb2p1 - 1)
    s0, dsdi, dsdj, dd = _setup_s_split(oc, s, log_x, log_y)
    i = np.arange(nx)[None, :]
    j = np.arange(ny)[:, None]
    sw = [s0[k] + i * dsdi[k] + j * dsdj[k] + i * j * dd[k]
          for k in range(4)]
    p0 = preds[0].astype(np.int64)
    b = (preds[1].astype(np.int64) - p0) * sw[1]
    c = (preds[2].astype(np.int64) - p0) * sw[2]
    d = (preds[3].astype(np.int64) - p0) * sw[3]
    return (((p0 << lb2p1) + b + c + d + rnd) >> lb2p1) \
        .astype(preds[0].dtype)


class MVGrid:
    """The motion-vector mesh (reference: src/state.h mv_grid)."""

    def __init__(self, nhmvbs, nvmvbs):
        self.nhmvbs = nhmvbs
        self.nvmvbs = nvmvbs
        shape = (nvmvbs + 1, nhmvbs + 1)
        self.valid = np.zeros(shape, np.uint8)
        self.ref = np.zeros(shape, np.uint8)
        self.mv = np.zeros(shape + (2,), np.int32)   # PREV/GOLD vector
        self.mv1 = np.zeros(shape + (2,), np.int32)  # NEXT vector

    def clear(self):
        self.valid[:] = 0
        self.ref[:] = 0
        self.mv[:] = 0
        self.mv1[:] = 0

    def get_mv(self, vy, vx):
        if self.ref[vy, vx] == OD_FRAME_NEXT:
            return int(self.mv1[vy, vx, 0]), int(self.mv1[vy, vx, 1])
        return int(self.mv[vy, vx, 0]), int(self.mv[vy, vx, 1])


def compute_median(neighbors, mv_res):
    """od_compute_median (reference: src/mc.c:2097-2123): the neighbor
    minimizing total L1 distance to the others."""
    n = len(neighbors)
    if n == 0:
        return [0, 0]
    distsum = [0] * n
    for i in range(n):
        for j in range(i + 1, n):
            dist = (abs(neighbors[j][0] - neighbors[i][0])
                    + abs(neighbors[j][1] - neighbors[i][1]))
            distsum[i] += dist
            distsum[j] += dist
    first = 0
    for i in range(1, n):
        if distsum[i] < distsum[first]:
            first = i
    return [div_pow2_re(neighbors[first][0], mv_res),
            div_pow2_re(neighbors[first][1], mv_res)]


def _corner_neighbors(grid: MVGrid, vx, vy, level):
    """The candidate neighbor list shared by the ref and MV predictors
    (reference: src/mc.c:2036-2095, 2125-2200).  Returns a list of
    (ref, mv, mv1) tuples; None entries are the zero MV."""
    ZERO = None
    mvb_sz = 1 << ((OD_MC_LEVEL_MAX - level) >> 1)
    cn = []
    if level == 0:
        if vy >= mvb_sz:
            cn.append((vy - mvb_sz, vx - mvb_sz) if vx >= mvb_sz else ZERO)
            cn.append((vy - mvb_sz, vx))
            cn.append((vy - mvb_sz, vx + mvb_sz)
                      if vx + mvb_sz <= grid.nhmvbs else ZERO)
        else:
            cn += [ZERO, ZERO, ZERO]
        cn.append((vy, vx - mvb_sz) if vx >= mvb_sz else ZERO)
    else:
        if level & 1:
            cn.append((vy - mvb_sz, vx - mvb_sz))
            cn.append((vy - mvb_sz, vx + mvb_sz))
            cn.append((vy + mvb_sz, vx - mvb_sz))
            cn.append((vy + mvb_sz, vx + mvb_sz))
        else:
            cn.append((vy - mvb_sz, vx) if vy >= mvb_sz else ZERO)
            cn.append((vy, vx - mvb_sz) if vx >= mvb_sz else ZERO)
            if not (vx > 0 and vx + mvb_sz > ((vx + OD_MVB_MASK)
                                              & ~OD_MVB_MASK)):
                cn.append((vy, vx + mvb_sz))
            if not (vy > 0 and vy + mvb_sz > ((vy + OD_MVB_MASK)
                                              & ~OD_MVB_MASK)):
                cn.append((vy + mvb_sz, vx))
    return cn


def get_ref_predictor(grid: MVGrid, frame_type, vx, vy, level):
    """od_mc_get_ref_predictor (reference: src/mc.c:2036-2095)."""
    cn = _corner_neighbors(grid, vx, vy, level)
    hist = [0, 0, 0, 0]
    max_count = 0
    max_ref = OD_FRAME_PREV
    for c in cn:
        ref = OD_FRAME_PREV if c is None else int(grid.ref[c[0], c[1]])
        hist[ref] += 1
        if hist[ref] > max_count:
            max_ref = ref
            max_count = hist[ref]
    return max_ref


def get_predictor(grid: MVGrid, vx, vy, level, mv_res, ref):
    """od_state_get_predictor (reference: src/mc.c:2125-2215).
    Returns (pred, equal_mvs)."""
    cn = _corner_neighbors(grid, vx, vy, level)
    zero_ref = ref if ref == OD_FRAME_NEXT else OD_FRAME_PREV
    a = []
    entries = []
    for c in cn:
        if c is None:
            cref = zero_ref
            cmv = (0, 0)
        else:
            cref = int(grid.ref[c[0], c[1]])
            if cref == OD_FRAME_NEXT:
                cmv = (int(grid.mv1[c[0], c[1], 0]),
                       int(grid.mv1[c[0], c[1], 1]))
            else:
                cmv = (int(grid.mv[c[0], c[1], 0]),
                       int(grid.mv[c[0], c[1], 1]))
        entries.append((cref, cmv))
        if cref == ref:
            a.append(cmv)
    pred = compute_median(a, mv_res)
    equal_mvs = 0
    for cref, cmv in entries:
        if cref == ref:
            if (pred[0] == div_pow2_re(cmv[0], mv_res)
                    and pred[1] == div_pow2_re(cmv[1], mv_res)):
                equal_mvs += 1
    return pred, equal_mvs


def mv_split_flag_ctx(grid: MVGrid, vx, vy, level):
    """od_mv_split_flag_ctx (reference: src/mc.c:2217-2253)."""
    mvb_sz = 1 << ((OD_MC_LEVEL_MAX - level) >> 1)

    def getmv(c):
        if c is None:
            return None
        vy_, vx_ = c
        if grid.ref[vy_, vx_] == OD_FRAME_NEXT:
            return (int(grid.mv1[vy_, vx_, 0]), int(grid.mv1[vy_, vx_, 1]))
        return (int(grid.mv[vy_, vx_, 0]), int(grid.mv[vy_, vx_, 1]))

    if level & 1:
        v1 = (vy - mvb_sz, vx + mvb_sz)
        v2 = (vy + mvb_sz, vx + mvb_sz)
        v3 = (vy + mvb_sz, vx - mvb_sz)
    else:
        v1 = (vy - mvb_sz, vx) if vy >= mvb_sz else None
        v2 = (vy, vx - mvb_sz) if vx >= mvb_sz else None
        v3 = (vy, vx + mvb_sz) if vx & mvb_sz else (vy + mvb_sz, vx)
    split1 = int(grid.valid[vy, vx - 2 * mvb_sz]) if vx >= 2 * mvb_sz else 0
    split2 = int(grid.valid[vy - 2 * mvb_sz, vx]) if vy >= 2 * mvb_sz else 0
    m1, m2, m3 = getmv(v1), getmv(v2), getmv(v3)
    same1 = int(m1 is not None and m2 is not None and m1 == m2)
    same2 = int(m2 is not None and m2 == m3)
    return 3 * (split1 + split2) + same1 + same2


def pred_block_from_setup(grid: MVGrid, ref_imgs, ref_imgi, info, dst, pli,
                          vx, vy, oc, s, log_mvb_sz):
    """od_state_pred_block_from_setup (reference: src/state.c:628-672)."""
    xdec, ydec = info.plane_dec[pli]
    dxp = VERT_SETUP_DX[oc][s]
    dyp = VERT_SETUP_DY[oc][s]
    mvx = [0] * 4
    mvy = [0] * 4
    srcs = []
    preds = []
    log_x = log_mvb_sz + OD_LOG_MVBSIZE_MIN - xdec
    log_y = log_mvb_sz + OD_LOG_MVBSIZE_MIN - ydec
    x = vx << (OD_LOG_MVBSIZE_MIN - xdec)
    y = vy << (OD_LOG_MVBSIZE_MIN - ydec)
    for k in range(4):
        gy = vy + dyp[k] * (1 << log_mvb_sz)
        gx = vx + dxp[k] * (1 << log_mvb_sz)
        mvx_, mvy_ = grid.get_mv(gy, gx)
        mvx[k] = div_pow2_re(mvx_, xdec)
        mvy[k] = div_pow2_re(mvy_, ydec)
        srcs.append(int(grid.ref[gy, gx]))
    pad = OD_BUFFER_PADDING >> xdec
    cache = {}
    for k in range(4):
        key = (srcs[k], mvx[k], mvy[k])
        if key not in cache:
            plane = ref_imgs[ref_imgi[srcs[k]]].planes[pli]
            pfn = predict1fmv16 if plane.dtype == np.uint16 \
                else predict1fmv
            cache[key] = pfn(plane, pad, y, x, mvx[k], mvy[k],
                             1 << log_y, 1 << log_x)
        preds.append(cache[key])
    if s == 3:
        blk = blend_full(preds, log_x, log_y)
    else:
        blk = blend_full_split(preds, oc, s, log_x, log_y)
    dst[y:y + (1 << log_y), x:x + (1 << log_x)] = blk


def pred_block(grid: MVGrid, ref_imgs, ref_imgi, info, dst, pli, vx, vy,
               log_mvb_sz):
    """od_state_pred_block (reference: src/state.c:674-724)."""
    half = 1 << log_mvb_sz >> 1
    if log_mvb_sz > 0 and grid.valid[vy + half, vx + half]:
        pred_block(grid, ref_imgs, ref_imgi, info, dst, pli, vx, vy,
                   log_mvb_sz - 1)
        pred_block(grid, ref_imgs, ref_imgi, info, dst, pli, vx + half, vy,
                   log_mvb_sz - 1)
        pred_block(grid, ref_imgs, ref_imgi, info, dst, pli, vx, vy + half,
                   log_mvb_sz - 1)
        pred_block(grid, ref_imgs, ref_imgi, info, dst, pli, vx + half,
                   vy + half, log_mvb_sz - 1)
    else:
        if log_mvb_sz < OD_LOG_MVB_DELTA0:
            mask = (1 << (log_mvb_sz + 1)) - 1
            oc = 1 if (vx & mask) else 0
            if vy & mask:
                oc = 3 - oc
            s1vx = vx + (OD_VERT_DX[(oc + 1) & 3] << log_mvb_sz)
            s1vy = vy + (OD_VERT_DY[(oc + 1) & 3] << log_mvb_sz)
            s3vx = vx + (OD_VERT_DX[(oc + 3) & 3] << log_mvb_sz)
            s3vy = vy + (OD_VERT_DY[(oc + 3) & 3] << log_mvb_sz)
            s = (int(grid.valid[s1vy, s1vx])
                 | int(grid.valid[s3vy, s3vx]) << 1)
        else:
            oc = 0
            s = 3
        pred_block_from_setup(grid, ref_imgs, ref_imgi, info, dst, pli, vx,
                              vy, oc, s, log_mvb_sz)


def _nlib():
    """The native engine, loaded at first use and not at import: the
    port's device layer imports this module for its tables alone."""
    try:
        from daala_tpu_torch import native as _native
        return _native.get_lib()
    except Exception:  # pragma: no cover
        return None


def pred_l0_native(grid: MVGrid, ref_imgs, ref_imgi, info, dst, pli, vx, vy,
                   cur=None, vis=None):
    """Native single-call prediction of one level-0 mesh block (with
    optional SAD against cur); returns the SAD (0 when cur is None) or
    None when the native engine is unavailable / layouts don't fit."""
    lib = _nlib()
    if lib is None:
        return None
    xdec, ydec = info.plane_dec[pli]
    planes = []
    for r in range(4):
        idx = ref_imgi[r]
        if idx is None or idx < 0:
            idx = 0
        img = ref_imgs[idx]
        if img is None:
            return None
        p = img.planes[pli]
        if p.strides[1] != 1:
            return None
        planes.append(p)
    if (dst.strides[1] != 1 or grid.valid.flags.c_contiguous is False
            or not grid.mv.flags.c_contiguous
            or not grid.mv1.flags.c_contiguous
            or not grid.ref.flags.c_contiguous):
        return None
    if cur is not None:
        if cur.dtype != np.uint8 or cur.strides[1] != 1:
            return None
        cptr, cstride = cur.ctypes.data, cur.strides[0]
        if vis is None:
            w, h = cur.shape[1], cur.shape[0]
        else:
            h, w = vis
    else:
        cptr, cstride, w, h = None, 0, 0, 0
    return lib.ec_obmc_pred_l0(
        grid.valid.ctypes.data, grid.ref.ctypes.data,
        grid.mv.ctypes.data, grid.mv1.ctypes.data,
        grid.nhmvbs, grid.nvmvbs,
        planes[0].ctypes.data, planes[1].ctypes.data,
        planes[2].ctypes.data, planes[3].ctypes.data,
        planes[0].strides[0], OD_BUFFER_PADDING >> xdec, xdec, ydec,
        dst.ctypes.data, dst.strides[0], vx, vy,
        cptr, cstride, w, h)


def _predict_frame_plane_native(grid, ref_imgs, ref_imgi, info, dst, pli):
    """Whole-plane OBMC prediction in one native call; returns False when
    the native engine is unavailable / layouts don't fit."""
    lib = _nlib()
    if lib is None or not hasattr(lib, "me_predict_frame_plane"):
        return False
    xdec, ydec = info.plane_dec[pli]
    planes = []
    for r in range(4):
        idx = ref_imgi[r]
        if idx is None or idx < 0:
            idx = 0
        img = ref_imgs[idx]
        if img is None:
            return False
        p = img.planes[pli]
        if p.strides[1] != 1:
            return False
        planes.append(p)
    if dst.strides[1] != 1:
        return False
    lib.me_predict_frame_plane(
        grid.valid.ctypes.data, grid.ref.ctypes.data,
        grid.mv.ctypes.data, grid.mv1.ctypes.data,
        grid.nhmvbs, grid.nvmvbs,
        planes[0].ctypes.data, planes[1].ctypes.data,
        planes[2].ctypes.data, planes[3].ctypes.data,
        planes[0].strides[0], OD_BUFFER_PADDING >> xdec, xdec, ydec,
        dst.ctypes.data, dst.strides[0])
    return True


def mc_predict_frame(grid: MVGrid, ref_imgs, ref_imgi, info, dst_img):
    """od_state_mc_predict (reference: src/state.c:932-961): fill the
    SELF reference image planes with the OBMC prediction."""
    nhmvbs = grid.nhmvbs
    nvmvbs = grid.nvmvbs
    views = [dst_img.plane_view(pli) for pli in range(info.nplanes)]
    for pli in range(info.nplanes):
        if _predict_frame_plane_native(grid, ref_imgs, ref_imgi, info,
                                       views[pli], pli):
            continue
        for vy in range(0, nvmvbs, OD_MVB_DELTA0):
            for vx in range(0, nhmvbs, OD_MVB_DELTA0):
                if pred_l0_native(grid, ref_imgs, ref_imgi, info,
                                  views[pli], pli, vx, vy) is None:
                    pred_block(grid, ref_imgs, ref_imgi, info,
                               views[pli], pli, vx, vy,
                               OD_LOG_MVB_DELTA0)
