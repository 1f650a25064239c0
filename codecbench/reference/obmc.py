"""The OBMC prediction of the colour sweep's leaves and their 8x8-cell
SADs, in plain PyTorch.

A frozen copy of the plain versions in the port's ops/cuda/
obmc_kernels.py (the code its obmc_leaf_cells kernel equals bit for
bit), with the subpel filters and blend weights of codec/mc.py: each
leaf's four corner predictions through the 6-tap subpel filters (the
horizontal pass wrapped to int16, as the codec's buffers are), blended
by the split weights, then the visible-clipped absolute differences
against the current luma summed per 8x8 cell.  `control` wraps the
vertical filter's accumulator to int16, one precision below the int32
the codec states.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_PLAIN_CHUNK_PIXELS = 1 << 20

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


def leaf_args(pos, srcs, mvs, ocs, ss, pad, log_x, log_y, plane_shape):
    """Pack one size class of leaves for the kernels: (L, 16) int32 with
    [0:4] srcs, [4:8] window rows sy, [8:12] window columns sx, [12]
    oc * 4 + s, [13] py, [14] px, [15] the subpel phases (bits 6k..6k+2:
    mvx & 7 of corner k, bits 6k+3..6k+5: mvy & 7).

    pos (L, 2) [y, x] plane pixels, srcs (L, 4) slots, mvs (L, 4, 2)
    [mvx, mvy] plane 1/8-pel, ocs/ss (L,), as models/obmc.py
    build_leaf_lists gives them.  Raises unless every corner window
    [sy, sy + ny + 5) x [sx, sx + nx + 5) lies inside a plane of
    plane_shape (Hp, Wp)."""
    pos = np.asarray(pos, np.int64)
    srcs = np.asarray(srcs, np.int64)
    mvs = np.asarray(mvs, np.int64)
    ocs = np.asarray(ocs, np.int64)
    ss = np.asarray(ss, np.int64)
    mvx, mvy = mvs[:, :, 0], mvs[:, :, 1]
    sy = pad + pos[:, 0:1] + (mvy >> 3) - 2
    sx = pad + pos[:, 1:2] + (mvx >> 3) - 2
    hp, wp = plane_shape
    bad = ((sy < 0) | (sy + (1 << log_y) + 5 > hp) | (sx < 0)
           | (sx + (1 << log_x) + 5 > wp) | (srcs < 0) | (srcs > 3)).any(1)
    bad |= (ocs < 0) | (ocs > 3) | (ss < 0) | (ss > 3)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            "OBMC leaf %d: window rows %s, columns %s (n %dx%d), srcs %s, "
            "oc %d, s %d lie outside a %dx%d plane or the tables"
            % (i, sy[i].tolist(), sx[i].tolist(), 1 << log_y, 1 << log_x,
               srcs[i].tolist(), ocs[i], ss[i], hp, wp))
    scal = np.zeros((pos.shape[0], 16), np.int32)
    scal[:, 0:4] = srcs
    scal[:, 4:8] = sy
    scal[:, 8:12] = sx
    scal[:, 12] = ocs * 4 + ss
    scal[:, 13:15] = pos
    phases = (mvx & 7) | (mvy & 7) << 3
    scal[:, 15] = (phases << (6 * np.arange(4))).sum(1)
    return scal


@functools.lru_cache(maxsize=None)
def weight_table(log_x, log_y):
    """(4 oc, 4 s, 4 corner, ny, nx) int32 merged blend weight planes
    (_setup_s_split); the s=3 entry reproduces blend_full."""
    nx, ny = 1 << log_x, 1 << log_y
    i = np.arange(nx)[None, :]
    j = np.arange(ny)[:, None]
    tab = np.zeros((4, 4, 4, ny, nx), np.int32)
    for oc in range(4):
        for s in range(4):
            s0, dsdi, dsdj, dd = _setup_s_split(oc, s, log_x, log_y)
            for k in range(4):
                tab[oc, s, k] = (s0[k] + i * dsdi[k] + j * dsdj[k]
                                 + i * j * dd[k])
    return tab


def _wrap16(v):
    """Two's-complement int16 wrap of int32 values (the od_mc buffer
    width)."""
    return ((v + 32768) & 0xFFFF) - 32768


def _blend_chunk(planes4, scal, log_x, log_y, control):
    nx, ny = 1 << log_x, 1 << log_y
    dev = planes4.device
    sub = torch.as_tensor(SUBPEL_FILTER_SET, device=dev)
    srcs = scal[:, 0:4].long()
    sy, sx = scal[:, 4:8], scal[:, 8:12]
    shift = 6 * torch.arange(4, device=dev, dtype=torch.int32)
    fx = sub[((scal[:, 15:16] >> shift) & 7).long()]          # (L, 4, 6)
    fy = sub[((scal[:, 15:16] >> (shift + 3)) & 7).long()]
    rows = sy[:, :, None] + torch.arange(ny + 5, device=dev)
    cols = sx[:, :, None] + torch.arange(nx + 5, device=dev)
    win = planes4[srcs[:, :, None, None], rows[:, :, :, None],
                  cols[:, :, None, :]].int()             # (L, 4, ny+5, nx+5)
    buff = sum(win[:, :, :, m:m + nx] * fx[:, :, m, None, None]
               for m in range(6))
    buff = _wrap16(buff - (128 << 7))
    acc = sum(buff[:, :, m:m + ny, :] * fy[:, :, m, None, None]
              for m in range(6))
    if control:
        acc = _wrap16(acc)
    preds = ((acc + (1 << 13) + (128 << 14)) >> 14).clamp(0, 255)
    # Blend: out = (p0 << (lb2+1) + sum_k (pk - p0) * sw_k + rnd) >> ...
    lb2p1 = log_x + log_y + 1
    wtab = torch.as_tensor(weight_table(log_x, log_y), device=dev)
    sw = wtab.view(16, 4, ny, nx)[scal[:, 12].long()]        # (L, 4, ny, nx)
    p0 = preds[:, 0]
    accb = (p0 << lb2p1) + (1 << (lb2p1 - 1))
    for k in range(1, 4):
        accb = accb + (preds[:, k] - p0) * sw[:, k]
    return accb >> lb2p1


def obmc_blend(planes4, scal, log_x, log_y, control=False):
    """(L, ny, nx) uint8 blended leaves of 8-bit planes (stored modulo
    2^8: the blend of non-square leaves can leave the range)."""
    step = max(1, _PLAIN_CHUNK_PIXELS
               // (4 * ((1 << log_y) + 5) * ((1 << log_x) + 5)))
    return torch.cat([_blend_chunk(planes4, scal[a:a + step], log_x, log_y,
                                   control)
                      for a in range(0, scal.shape[0], step)]).to(torch.uint8)


def leaf_cells(planes4, cur, scal, log_n, control=False):
    """obmc_blend, then the visible-clipped per-8x8-cell SADs against cur
    (vh, vw): (L, n/8, n/8) int32."""
    n, nc = 1 << log_n, 1 << log_n >> 3
    vh, vw = cur.shape
    blocks = obmc_blend(planes4, scal, log_n, log_n, control).int()
    ar = torch.arange(n, device=cur.device)
    rows = scal[:, 13:14] + ar
    cols = scal[:, 14:15] + ar
    c = cur[rows.clamp(max=vh - 1)[:, :, None],
            cols.clamp(max=vw - 1)[:, None, :]].int()
    vis = (rows < vh)[:, :, None] & (cols < vw)[:, None, :]
    d = torch.where(vis, (blocks - c).abs(), 0)
    return d.view(-1, nc, 8, nc, 8).sum((2, 4), dtype=torch.int32)
