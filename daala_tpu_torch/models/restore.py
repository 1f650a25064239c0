"""Device dering on torch tensors: the directional deringing filter
(reference: src/dering.c:54-350) as batched passes over superblocks.

The counterpart of daala_tpu/models/restore.py, function for function,
bit-exact with the host filter (ops/dering.py od_dering) and with JAX's
(tests/test_torch_restore.py):

- compute_dirs_var: the 8 directional line sums of every 8x8 block are
  one float64 matmul against the constant 0/1 projection tensor (exact:
  |x >> 4| <= 2048 and a line holds at most 8 pixels; CUDA has no int32
  matmul), and the cost accumulation runs in int64 and wraps to int32,
  which equals the reference's wrapping int32_t math modulo 2^32;
- dering_filter: both conditional-replacement passes, as per-pixel
  gathers selected by each block's direction, over any batch of
  superblocks; every int16 wrap of the reference is computed in int32
  and wrapped explicitly (`_wrap16`).

Three entry points take host planes and an explicit `device`:

- od_dering_device: one superblock of one plane (the decoder's Python
  path parses the levels one superblock at a time);
- dering_candidates_device: every luma superblock x the 5 gains in one
  pass (the encoder's dering RDO);
- dering_frame_device: every superblock with a nonzero level, one
  batched pass per plane, chroma with the luma directions kept on the
  device (the decoder's native path; the original filters one
  superblock and plane at a time).

The superblock windows, their VERY_LARGE borders and the skip-window
masks are built on the host as in the original, from the same rules.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.device import resolve
from daala_tpu_torch.ops import dering as D
from daala_tpu_torch.ops.dering import (DIRECTION_OFFSETS, OD_FILT_BORDER,
                                        _DIV_TABLE, _THRESH_TABLE_Q8)
from daala_tpu_torch.utils import devstats


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


# Per-direction cost weights replicated as dense (8, 15) int32 tables so
# the cost reduction is one weighted square-sum (reference:
# src/dering.c:90-120).
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


def _wrap32(v):
    """int64 v wrapped to int32 (where the reference's int32_t math wraps)."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _wrap16(v):
    """int32 v wrapped to int16, kept as int32 (the reference's int16_t)."""
    return ((v + (1 << 15)) & 0xFFFF) - (1 << 15)


def _const(table, device):
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def compute_dirs_var(x_orig, coeff_shift=4):
    """Vectorized od_dir_find8 over all 8x8 blocks of (..., n, n) blocks.
    Returns (dirs, var) as (..., n//8, n//8) int32 tensors."""
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
    cost = _wrap32((partial * partial * w).sum(-1))
    best_dir = torch.argmax(cost, dim=-1)  # the first maximum, as JAX's
    best_cost = cost.amax(dim=-1)
    # The reference's scan starts from best_cost=0/dir=0 and uses strict
    # greater-than, so all-nonpositive costs give dir 0.
    best_dir = torch.where(best_cost > 0, best_dir, 0)
    best_cost = best_cost.clamp_min(0)
    opp = cost.gather(-1, ((best_dir + 4) & 7)[..., None])[..., 0]
    var = _wrap32(best_cost - opp) >> 10
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


def od_dering_device(plane_i16, sby, sbx, xdec, pli, bskip, threshold, n,
                     dirs=None, coeff_shift=4, *, device):
    """Drop-in counterpart of ops.dering.od_dering running the filters
    (and for luma, the direction search) on `device`.  Border assembly
    and the skip-window logic stay on the host (tiny, data-dependent)."""
    device = resolve(device)
    nhdr = plane_i16.shape[1] >> (6 - xdec)
    nvdr_ = plane_i16.shape[0] >> (6 - xdec)
    bsize = 3 - xdec
    nhb = nvb = n >> bsize
    inb = np.full((n + 2 * OD_FILT_BORDER, n + 2 * OD_FILT_BORDER),
                  D.OD_DERING_VERY_LARGE, np.int16)
    y0 = sby << (6 - xdec)
    x0 = sbx << (6 - xdec)
    i_lo = -OD_FILT_BORDER if sby != 0 else 0
    i_hi = n + (OD_FILT_BORDER if sby != nvdr_ - 1 else 0)
    j_lo = -OD_FILT_BORDER if sbx != 0 else 0
    j_hi = n + (OD_FILT_BORDER if sbx != nhdr - 1 else 0)
    inb[OD_FILT_BORDER + i_lo:OD_FILT_BORDER + i_hi,
        OD_FILT_BORDER + j_lo:OD_FILT_BORDER + j_hi] = \
        plane_i16[y0 + i_lo:y0 + i_hi, x0 + j_lo:x0 + j_hi]
    x_orig = devstats.upload(plane_i16[y0:y0 + n, x0:x0 + n], device)
    devstats.dispatch()
    if pli == 0:
        dirs_t, var_t = compute_dirs_var(x_orig, coeff_shift)
        dirs = devstats.fetch(dirs_t)
        v1 = np.minimum(32767, devstats.fetch(var_t) >> 6)
        bits = np.zeros_like(v1)
        for p in range(15):
            bits += (v1 >= (1 << p)).astype(np.int32)
        tt = np.asarray(_THRESH_TABLE_Q8, np.int64)
        thresh = ((threshold * tt[bits] + 128) >> 8).astype(np.int32)
        # Wrapped-negative variance -> unfiltered (the reference's
        # OD_ILOG(negative) table read is out of bounds; see
        # ops/dering.py for the emulation rationale).
        thresh = np.where(v1 < 0, 0, thresh).astype(np.int32)
    else:
        assert dirs is not None
        thresh = np.full((nvb, nhb), threshold, np.int32)
    # Skip-window masking (reference: src/dering.c:301-327).
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
    out = dering_filter(devstats.upload(inb, device), x_orig,
                        devstats.upload(np.asarray(dirs, np.int32), device),
                        devstats.upload(thresh, device), bsize)
    return devstats.fetch(out, None), dirs


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
    """The (nvdr*nhdr, n+6, n+6) int16 bordered superblock windows of a
    plane on `device`, in raster order: the plane's nvdr x nhdr
    superblocks with VERY_LARGE outside them, uploaded once and cut on
    the device."""
    B = OD_FILT_BORDER
    h, w = nvdr * n, nhdr * n
    plane = np.full((h + 2 * B, w + 2 * B), D.OD_DERING_VERY_LARGE,
                    np.int16)
    plane[B:B + h, B:B + w] = plane_i16[:h, :w]
    win = devstats.upload(plane, device).unfold(0, n + 2 * B, n) \
        .unfold(1, n + 2 * B, n)
    return win.reshape(nvdr * nhdr, n + 2 * B, n + 2 * B)


def dering_candidates_device(luma_i16, bskip0, quantizer, nvdr, nhdr,
                             coeff_shift=4, *, device):
    """Batched device dering for the encoder's RDO: all superblocks x
    the 5 gain levels in one pass, on `device`.

    Returns (cands, dirs): cands (NSB, 5, 64, 64) int16 filtered
    candidates (NSB = nvdr*nhdr, raster order), dirs (NSB, 8, 8) int32
    luma directions (consumed by the chroma filter of the chosen
    level).  Bit-exact with per-superblock ops.dering.od_dering."""
    device = resolve(device)
    B = OD_FILT_BORDER
    with devstats.span("dering_candidates"):
        inb = _sb_windows(luma_i16, nvdr, nhdr, 64, device)
        skipb = _per_superblock(_skip_blocks(bskip0, nvdr, nhdr, 0),
                                nvdr, nhdr)
        # Per-gain base thresholds (the only float math; 5 host ints).
        base_threshold = float(quantizer) ** 0.84182
        # t0 * tt[bits] <= ~3900 * 256: comfortably int32.
        t0s = np.array([int(g * base_threshold)
                        for g in (0.5, 0.707, 1, 1.41, 2)], np.int32)
        devstats.dispatch()
        cands, dirs = _dering_cands_fused(
            inb, inb[:, B:B + 64, B:B + 64],
            devstats.upload(skipb, device).bool(),
            devstats.upload(t0s, device), coeff_shift)
        devstats.prefetch(cands, dirs)
        return devstats.fetch(cands, None), devstats.fetch(dirs)


def _dering_cands_fused(inb, xorig, skipb, t0s, coeff_shift):
    """Direction search + per-block thresholds + all 5 gain-level
    filters as one device pass: the superblock windows upload once and
    the candidates come back in one fetch.  The pass-1 taps gather once
    per superblock and serve all 5 thresholds."""
    dirs, var = compute_dirs_var(xorig, coeff_shift)
    th = _luma_thresholds(var[:, None], t0s[None, :, None, None],
                          skipb[:, None])
    cands = dering_filter(inb[:, None], xorig[:, None], dirs[:, None], th, 3)
    return cands, dirs


def dering_frame_device(planes_i16, bskips, plane_xdec, nvdr, nhdr, sbs,
                        thresholds, *, device, coeff_shift=4):
    """Dering the superblocks `sbs` (raster indices) of every plane on
    `device`, one batched pass per plane: luma's directions, variance
    thresholds and filter, then each chroma plane with luma's directions
    (kept on the device) and its flat threshold.  Bit-exact with
    od_dering_device on each superblock and plane in turn, since every
    superblock reads the unfiltered planes.

    planes_i16: the unfiltered int16 planes; bskips: their 4x4 skip
    maps; thresholds: (nplanes, len(sbs)) host ints, each superblock's
    base threshold per plane.  Returns, per plane, the (len(sbs), n, n)
    int16 filtered superblocks (n = 64 >> xdec)."""
    device = resolve(device)
    B = OD_FILT_BORDER
    sbs = np.asarray(sbs, np.int64)
    out = []
    dirs = None
    with devstats.span("dering_frame"):
        pick = devstats.upload(sbs, device)
        for pli, plane in enumerate(planes_i16):
            xdec = plane_xdec[pli]
            n = 64 >> xdec
            inb = _sb_windows(plane, nvdr, nhdr, n, device)[pick]
            x_orig = inb[:, B:B + n, B:B + n]
            skip = devstats.upload(_per_superblock(_skip_blocks(
                bskips[pli], nvdr, nhdr, xdec), nvdr, nhdr)[sbs],
                device).bool()
            t0 = devstats.upload(np.asarray(thresholds[pli], np.int32),
                                 device)[:, None, None]
            devstats.dispatch()
            if pli == 0:
                dirs, var = compute_dirs_var(x_orig, coeff_shift)
                th = _luma_thresholds(var, t0, skip)
            else:
                th = torch.where(skip, 0, t0).to(torch.int32)
            out.append(dering_filter(inb, x_orig, dirs, th, 3 - xdec))
        devstats.prefetch(*out)
        return [devstats.fetch(o, None) for o in out]
