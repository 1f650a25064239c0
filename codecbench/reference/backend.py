"""The decoder's back end in plain PyTorch: from a frame's parsed
coefficient planes to its output pixels.

A frozen copy of the port's models/synthesis.py (one tile) and of the
batched dering of models/restore.py with ops/dering.py's tables:

  leaf coefficients d -> per-size masked inverse DCTs -> masked split
  postfilters, children before parents -> frame lapped postfilter
  -> dering of every superblock with a nonzero level (luma directions,
     variance thresholds, two filter passes; chroma on luma's
     directions) -> pixels (od_coeff_to_ref_buf) -> the picture's crop

and the encoder's dering candidates (restore.py
dering_candidates_device): every luma superblock at each of the 5 gains.

`dtype` is the integer type of the synthesis' lifting: int32 as the
codec states it, int16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from codecbench.reference.frontend import (NBSIZES, _torch_masks,
                                           analysis_masks, leaf_transform,
                                           split_filter)
from codecbench.reference.intrin import wrap32 as _wrap32
from codecbench.reference.transform import lap_frame

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


def _proj_tensor():
    """(8, 15, 8, 8) 0/1 projection: proj[d, l, i, j] = 1 iff pixel
    (i, j) belongs to line l of direction d (reference:
    src/dering.c:54-62)."""
    i = np.arange(8)[:, None] * np.ones((1, 8), np.int64)
    j = np.arange(8)[None, :] * np.ones((8, 1), np.int64)
    i = i.astype(np.int64)
    j = j.astype(np.int64)
    idx = np.stack([i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
                    3 - i // 2 + j, j, i // 2 + j])
    proj = np.zeros((8, 15, 8, 8), np.int32)
    for d in range(8):
        for a in range(8):
            for b in range(8):
                proj[d, idx[d, a, b], a, b] = 1
    return proj


_PROJ = _proj_tensor()


def _cost_weights():
    w = np.zeros((8, 15), np.int32)
    for i in range(8):
        w[2, i] = _DIV_TABLE[8]
        w[6, i] = _DIV_TABLE[8]
    for i in range(7):
        w[0, i] = w[0, 14 - i] = _DIV_TABLE[i + 1]
        w[4, i] = w[4, 14 - i] = _DIV_TABLE[i + 1]
    w[0, 7] = w[4, 7] = _DIV_TABLE[8]
    for d in range(1, 8, 2):
        for j in range(5):
            w[d, 3 + j] = _DIV_TABLE[8]
        for j in range(3):
            w[d, j] = w[d, 10 - j] = _DIV_TABLE[2 * j + 2]
    return w


_COST_W = _cost_weights()
_DIR_DY = np.array([[o[0] for o in DIRECTION_OFFSETS[d]]
                    for d in range(8)], np.int64)  # (8, 3)
_DIR_DX = np.array([[o[1] for o in DIRECTION_OFFSETS[d]]
                    for d in range(8)], np.int64)


def _wrap16(v):
    """int32 v wrapped to int16, kept as int32 (the reference's int16_t)."""
    return ((v + (1 << 15)) & 0xFFFF) - (1 << 15)


def _const(table, device):
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def compute_dirs_var(x_orig, coeff_shift=4, wrap=_wrap32):
    """Vectorized od_dir_find8 over all 8x8 blocks of (..., n, n) blocks.
    Returns (dirs, var) as (..., n//8, n//8) int32 tensors.  `wrap` is
    the width the costs accumulate in: int32 as the codec states it
    (`_wrap16` for the control)."""
    *lead, n, _ = x_orig.shape
    nb = n // 8
    x = x_orig.to(torch.int32) >> coeff_shift
    blocks = (x.reshape(*lead, nb, 8, nb, 8).transpose(-3, -2)
              .reshape(*lead, nb, nb, 64))
    proj = _const(_PROJ.reshape(120, 64).T.astype(np.float64), x.device)
    # partial[..., by, bx, d, l]: sums of at most 8 values of |v| <= 2048,
    # exact in float64.
    partial = (blocks.to(torch.float64) @ proj).to(torch.int64) \
        .reshape(*lead, nb, nb, 8, 15)
    w = _const(_COST_W.astype(np.int64), x.device)
    cost = wrap((partial * partial * w).sum(-1))
    best_dir = torch.argmax(cost, dim=-1)  # the first maximum, as JAX's
    best_cost = cost.amax(dim=-1)
    # The reference's scan starts from best_cost=0/dir=0 and uses strict
    # greater-than, so all-nonpositive costs give dir 0.
    best_dir = torch.where(best_cost > 0, best_dir, 0)
    best_cost = best_cost.clamp_min(0)
    opp = cost.gather(-1, ((best_dir + 4) & 7)[..., None])[..., 0]
    var = wrap(best_cost - opp) >> 10
    return best_dir.to(torch.int32), var.to(torch.int32)


def _per_pixel(v, b):
    """(..., nb, nb) per-block values -> (..., nb*b, nb*b) per pixel."""
    return v.repeat_interleave(b, -2).repeat_interleave(b, -1)


def dering_filter(inb, x_orig, dirs, thresh, bsize=3):
    """Both dering passes over a batch of superblocks.

    inb: (..., n+6, n+6) int16 bordered input; x_orig: (..., n, n) int16;
    dirs: (..., n>>bsize, n>>bsize) int32, with the same leading
    dimensions as inb; thresh: int32 per block, whose leading dimensions
    broadcast against inb's (a trailing batch of thresholds filters each
    superblock once per threshold).  Returns the filtered (n, n) int16
    blocks, with the broadcast leading dimensions."""
    b = 1 << bsize
    n = x_orig.shape[-1]
    B = OD_FILT_BORDER
    s = n + 2 * B
    dev = inb.device
    src = inb.to(torch.int32)
    x0 = src[..., B:B + n, B:B + n]
    pdir = _per_pixel(dirs.to(torch.int64), b)
    pthr = _per_pixel(thresh.to(torch.int32), b)
    yy = torch.arange(n, device=dev)[:, None]
    xx = torch.arange(n, device=dev)[None, :]
    centre = (B + yy) * s + B + xx
    flat = src.flatten(-2)
    dy_t, dx_t = _const(_DIR_DY, dev), _const(_DIR_DX, dev)

    def tap(offset):
        idx = (centre + offset).flatten(-2)
        return torch.gather(flat, -1, idx).reshape(offset.shape)

    # Pass 1: 7-tap along the direction (reference: src/dering.c:132-170).
    acc = torch.zeros((), dtype=torch.int32, device=dev)
    for k, weight in enumerate((3, 2, 1)):
        offset = dy_t[pdir, k] * s + dx_t[pdir, k]
        for sgn in (1, -1):
            p = _wrap16(tap(sgn * offset) - x0)
            p = torch.where(p.abs() < pthr, p, 0)
            acc = acc + _wrap16(weight * p)
    out1 = _wrap16(x0 + ((_wrap16(acc) + 8) >> 4))
    # Pass 2: 4-tap orthogonal with tighter threshold (reference:
    # src/dering.c:172-210), over the bordered input with pass-1 results
    # inside.
    src2 = src.expand(*out1.shape[:-2], s, s).clone()
    src2[..., B:B + n, B:B + n] = out1
    horiz = (0 < pdir) & (pdir < 4)
    athr = torch.minimum(
        pthr, pthr // 3 + (out1 - x_orig.to(torch.int32)).abs())
    acc2 = torch.zeros((), dtype=torch.int32, device=dev)
    for mult in (1, 2, -1, -2):
        vert = src2[..., B + mult:B + mult + n, B:B + n]
        side = src2[..., B:B + n, B + mult:B + mult + n]
        p = _wrap16(torch.where(horiz, vert, side) - out1)
        acc2 = acc2 + torch.where(p.abs() < athr, p, 0)
    return _wrap16(out1 + ((3 * _wrap16(acc2) + 8) >> 4)).to(torch.int16)


def _luma_thresholds(var, t0, skip):
    """Per-block luma thresholds from the direction variance (reference:
    src/dering.c:241-248): t0 scaled by the variance's table entry;
    0 where the variance wrapped negative or the block is skipped.
    Arguments broadcast."""
    v1 = torch.clamp(var >> 6, max=32767)
    bits = torch.zeros_like(v1)
    for p in range(15):
        bits = bits + (v1 >= (1 << p)).to(v1.dtype)
    tt = _const(np.asarray(_THRESH_TABLE_Q8, np.int32), var.device)
    th = (t0 * tt[bits.long()] + 128) >> 8
    th = torch.where(v1 < 0, 0, th)
    return torch.where(skip, 0, th).to(torch.int32)


def _skip_blocks(bskip, nvdr, nhdr, xdec):
    """Vectorized skip-window mask at dering-block granularity (8 blocks
    a superblock side, of 8 >> xdec pixels) for every superblock of a
    plane; at xdec 0, JAX's _skip_blocks_luma.  (od_dering's skip-window
    logic, reference:
    src/dering.c:301-327): a block is skipped when all 4px bskip cells
    in its window are set.  The window extension rows/columns (one cell
    beyond the block's own on each side) are included per SUPERBLOCK
    position -- every block of an edge superblock drops them, even
    interior blocks whose neighbors exist (a reference quirk replicated
    exactly)."""
    k = 2 >> xdec  # bskip cells a block side
    c = 16 >> xdec  # bskip cells a superblock side
    sk = np.asarray(bskip, np.uint8)
    h4 = nvdr * c
    w4 = nhdr * c
    sk = sk[:h4, :w4]
    p = np.ones((h4 + 2, w4 + 2), np.uint8)
    p[1:-1, 1:-1] = sk
    hb, wb = nvdr * 8, nhdr * 8

    def S(dy, dx):
        return p[dy:dy + h4:k, dx:dx + w4:k][:hb, :wb]

    core = range(1, k + 1)
    out = np.ones((hb, wb), np.uint8)
    for dy in core:
        for dx in core:
            out &= S(dy, dx)
    # SB-position row/col inclusion masks for the -1 / +k extensions.
    brow = np.arange(hb) // 8
    bcol = np.arange(wb) // 8
    top = (brow > 0)[:, None]
    bot = (brow < nvdr - 1)[:, None]
    left = (bcol > 0)[None, :]
    right = (bcol < nhdr - 1)[None, :]
    for dy, rows in ((0, top), (k + 1, bot)):
        for dx in core:
            out &= np.where(rows, S(dy, dx), 1).astype(np.uint8)
    for dx, cols in ((0, left), (k + 1, right)):
        for dy in core:
            out &= np.where(cols, S(dy, dx), 1).astype(np.uint8)
    for dy, rows in ((0, top), (k + 1, bot)):
        for dx, cols in ((0, left), (k + 1, right)):
            out &= np.where(rows & cols, S(dy, dx), 1).astype(np.uint8)
    return out  # (nvdr*8, nhdr*8)


def _per_superblock(blocks, nvdr, nhdr):
    """(nvdr*8, nhdr*8) per-block values -> (nvdr*nhdr, 8, 8) in raster
    superblock order."""
    return blocks.reshape(nvdr, 8, nhdr, 8).transpose(0, 2, 1, 3) \
        .reshape(nvdr * nhdr, 8, 8)


def _sb_windows(plane_i16, nvdr, nhdr, n, device):
    """The (nvdr*nhdr, n+6, n+6) bordered superblock windows of a plane,
    VERY_LARGE outside the plane, in raster order."""
    B = OD_FILT_BORDER
    h, w = nvdr * n, nhdr * n
    plane = np.full((h + 2 * B, w + 2 * B), OD_DERING_VERY_LARGE, np.int16)
    plane[B:B + h, B:B + w] = plane_i16[:h, :w]
    win = torch.from_numpy(plane).to(device).unfold(0, n + 2 * B, n) \
        .unfold(1, n + 2 * B, n)
    return win.reshape(nvdr * nhdr, n + 2 * B, n + 2 * B)


def dering(ctmp, bskips, levels, quantizer, plane_dec, device):
    """Dering the superblocks of nonzero level in place in the int32
    planes `ctmp` (numpy), every superblock reading the unfiltered
    int16 planes."""
    nvdr, nhdr = levels.shape
    sbs = np.flatnonzero(levels)
    if not len(sbs):
        return
    B = OD_FILT_BORDER
    lv = levels.reshape(-1)
    base_threshold = float(quantizer) ** 0.84182
    etmp = [c.astype(np.int16) for c in ctmp]
    pick = torch.from_numpy(sbs.astype(np.int64)).to(device)
    dirs = None
    for pli, plane in enumerate(etmp):
        xdec = plane_dec[pli][0]
        n = 64 >> xdec
        inb = _sb_windows(plane, nvdr, nhdr, n, device)[pick]
        x_orig = inb[:, B:B + n, B:B + n]
        skip = torch.from_numpy(_per_superblock(_skip_blocks(
            bskips[pli], nvdr, nhdr, xdec), nvdr, nhdr)[sbs]).to(
            device).bool()
        t0 = torch.tensor(
            [int(OD_DERING_GAIN_TABLE[int(lv[i])] * base_threshold
                 * (1 if pli == 0 else 0.6)) for i in sbs],
            dtype=torch.int32, device=device)[:, None, None]
        if pli == 0:
            dirs, var = compute_dirs_var(x_orig, 4)
            th = _luma_thresholds(var, t0, skip)
        else:
            th = torch.where(skip, 0, t0).to(torch.int32)
        out = dering_filter(inb, x_orig, dirs, th, 3 - xdec).cpu().numpy()
        ln = 6 - xdec
        for k, i in enumerate(sbs):
            sby, sbx = divmod(int(i), nhdr)
            ctmp[pli][sby << ln:(sby << ln) + n,
                      sbx << ln:(sbx << ln) + n] = out[k]


def dering_candidates(luma_i16, bskip0, quantizer, nvdr, nhdr,
                      coeff_shift=4, device="cpu", wrap=_wrap32):
    """The encoder's dering RDO candidates: every luma superblock
    filtered at each of the 5 gains on the quantizer's base threshold.
    Returns (cands, dirs): (nvdr*nhdr, 5, 64, 64) int16 and the
    (nvdr*nhdr, 8, 8) int32 directions, in raster superblock order.
    `wrap`: as compute_dirs_var's."""
    B = OD_FILT_BORDER
    inb = _sb_windows(luma_i16, nvdr, nhdr, 64, device)
    x_orig = inb[:, B:B + 64, B:B + 64]
    skip = torch.from_numpy(_per_superblock(_skip_blocks(
        bskip0, nvdr, nhdr, 0), nvdr, nhdr)).to(device).bool()
    base_threshold = float(quantizer) ** 0.84182
    t0s = torch.tensor([int(g * base_threshold)
                        for g in OD_DERING_GAIN_TABLE[1:]],
                       dtype=torch.int32, device=device)
    dirs, var = compute_dirs_var(x_orig, coeff_shift, wrap)
    th = _luma_thresholds(var[:, None], t0s[None, :, None, None],
                          skip[:, None])
    return dering_filter(inb[:, None], x_orig[:, None], dirs[:, None], th,
                         3), dirs


def synthesize(d, bsize, fw, fh, pic_w, pic_h, xdec, ydec, device, dtype):
    """One plane's reconstructed (pre-dering) coefficients."""
    m = _torch_masks(analysis_masks(bsize, fw, fh, pic_w, pic_h, xdec),
                     device)
    c = torch.from_numpy(np.ascontiguousarray(d)).to(device).to(dtype)
    c = leaf_transform(c, m["leaf"], forward=False)
    for bsi in range(1, NBSIZES):
        n = 4 << (bsi - xdec)
        c = split_filter(c, m["split_h"][bsi], m["split_v"][bsi], n,
                         inverse=True)
    return lap_frame(c, 64 >> xdec, 64 >> ydec, forward=False)


def reconstruct(d_planes, bsize, bskips, levels, quantizer, pic_w, pic_h,
                plane_dec, device="cpu", dtype=torch.int32):
    """The output planes (uint8, the picture's size) of one frame from
    its parsed coefficient planes, block-size map, skip maps and
    dering levels."""
    fw, fh = (pic_w + 63) & ~63, (pic_h + 63) & ~63
    ctmp = [synthesize(d, bsize, fw, fh, pic_w, pic_h, *plane_dec[pli],
                       device, dtype).to(torch.int32).cpu().numpy()
            for pli, d in enumerate(d_planes)]
    if quantizer != 0:
        dering(ctmp, bskips, np.asarray(levels), quantizer, plane_dec,
               device)
    out = []
    for pli, c in enumerate(ctmp):
        xd, yd = plane_dec[pli]
        v = np.clip(((c + 8) >> 4) + 128, 0, 255).astype(np.uint8)
        out.append(v[:(pic_h + (1 << yd) - 1) >> yd,
                     :(pic_w + (1 << xd) - 1) >> xd])
    return out
