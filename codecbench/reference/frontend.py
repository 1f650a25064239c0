"""The encoder's analysis front end in plain PyTorch: from a frame's
pixels and its block-size map to the coefficient planes that the PVQ
band search reads.

A frozen copy of the port's models/keyframe.py plane functions (one
tile, no placement hook) and of the input padding of codec/state.py
img_plane_copy_pad:

  pixels -> padding -> coefficient lift -> frame lapped prefilter
  -> masked split prefilters, top level down -> per-size leaf DCTs
  -> keyframes: masked Haar DC merges, bottom up
  -> inter frames: the same on the OBMC prediction, and the input's
     padding replaced by the filtered prediction

`dtype` is the integer type of every lifting step: int32 as the codec
states it, int16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from codecbench.reference import lifting as L
from codecbench.reference.transform import dct_frame, lap_frame

NBSIZES = 5


def pad_plane(src, plane_w, plane_h):
    """od_img_plane_copy_pad's low-pass extension of a (pic_h, pic_w)
    uint8 plane to (plane_h, plane_w): each new column from the last
    three of the one before it, then each new row likewise."""
    pic_h, pic_w = src.shape
    dst = np.zeros((plane_h, plane_w), src.dtype)
    dst[:pic_h, :pic_w] = src
    for x in range(pic_w, plane_w):
        c = dst[:pic_h, x - 1].astype(np.int32)
        u = np.concatenate([c[:1], c[:-1]])
        d = np.concatenate([c[1:], c[-1:]])
        dst[:pic_h, x] = (2 * c + u + d + 2) >> 2
    for y in range(pic_h, plane_h):
        c = dst[y - 1].astype(np.int32)
        left = np.concatenate([c[:1], c[:-1]])
        right = np.concatenate([c[1:], c[-1:]])
        dst[y] = (2 * c + left + right + 2) >> 2
    return dst


def analysis_masks(bsize, fw, fh, pic_w, pic_h, xdec):
    """Walk the transform recursion on the block-size map (bsize: log2
    size - 2 of every 8x8 luma block) and return, per node level bsi in
    1..4, the split_h, split_v and merge masks, and per plane leaf size
    the leaf mask, as bool tensors (keyframe.build_analysis_masks)."""
    w, h = fw >> xdec, fh >> xdec
    masks = {"split_h": {}, "split_v": {}, "merge": {}, "leaf": {}}
    for bsi in range(1, NBSIZES):
        n = 4 << (bsi - xdec)
        for key in ("split_h", "split_v", "merge"):
            masks[key][bsi] = np.zeros((h // n, w // n), np.uint8)
    for bs_p in range(NBSIZES - xdec):
        n = 4 << bs_p
        masks["leaf"][bs_p] = np.zeros((h // n, w // n), np.uint8)

    def rec(bx, by, bsi):
        bs = max(int(bsize[(by << bsi) >> 1, (bx << bsi) >> 1]), xdec)
        if bs == bsi:
            masks["leaf"][bsi - xdec][by, bx] = 1
            return
        bs_p = bsi - xdec
        masks["split_h"][bsi][by, bx] = ((bx + 1) << (2 + bs_p)) <= pic_w
        masks["split_v"][bsi][by, bx] = ((by + 1) << (2 + bs_p)) <= pic_h
        masks["merge"][bsi][by, bx] = 1
        for sx, sy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            rec(2 * bx + sx, 2 * by + sy, bsi - 1)

    for sby in range(fh >> 6):
        for sbx in range(fw >> 6):
            rec(sbx, sby, NBSIZES - 1)
    return masks


def _torch_masks(masks, device):
    return {key: {k: torch.from_numpy(v).to(device).bool()
                  for k, v in group.items()}
            for key, group in masks.items()}


def _band_idx(count, n, device):
    starts = torch.arange(count, device=device) * n + n // 2 - 2
    return starts[:, None] + torch.arange(4, device=device)[None, :]


def split_filter(c, hmask, vmask, n, inverse=False):
    """The 4-pixel lapped filter across the midlines of every split node
    of size n: forward rows then columns (od_prefilter_split), inverse
    columns then rows (od_postfilter_split)."""
    fn = L.post_filter4 if inverse else L.pre_filter4
    h, w = c.shape
    c = c.clone()

    def rows():
        idx = _band_idx(h // n, n, c.device)
        band = c[idx]
        f = torch.stack(fn([band[:, k, :] for k in range(4)]), dim=1)
        c[idx] = torch.where(hmask.repeat_interleave(n, dim=1)[:, None, :],
                             f, band)

    def cols():
        idx = _band_idx(w // n, n, c.device)
        band = c[:, idx]
        f = torch.stack(fn([band[:, :, k] for k in range(4)]), dim=2)
        c[:, idx] = torch.where(vmask.repeat_interleave(n, dim=0)[:, :, None],
                                f, band)

    for step in ((cols, rows) if inverse else (rows, cols)):
        step()
    return c


def _dc_merge(d, mmask, n):
    """Haar-merge the four child DCs of each split node of size n."""
    half = n // 2
    a, b = d[0::n, 0::n], d[0::n, half::n]
    cc, dd = d[half::n, 0::n], d[half::n, half::n]
    k0 = a + b
    k3 = dd - cc
    k1 = ((k0 - k3) >> 1) - cc
    k2 = ((k0 - k3) >> 1) - b
    k0 = k0 - k1
    k3 = k3 + k2
    out = d.clone()
    out[0::n, 0::n] = torch.where(mmask, k0, a)
    out[0::n, half::n] = torch.where(mmask, k2, b)
    out[half::n, 0::n] = torch.where(mmask, k1, cc)
    out[half::n, half::n] = torch.where(mmask, k3, dd)
    return out


def leaf_transform(c, leaf, forward=True):
    """Each n x n leaf of the map takes the n-point DCT (or its inverse)
    of c."""
    out = torch.zeros_like(c)
    for bs_p in sorted(leaf):
        n = 4 << bs_p
        m = leaf[bs_p].repeat_interleave(n, 0).repeat_interleave(n, 1)
        out = torch.where(m, dct_frame(c, n, forward), out)
    return out


def _lift(plane_u8, device, dtype):
    x = torch.from_numpy(np.ascontiguousarray(plane_u8)).to(device)
    return (x.to(dtype) - 128) << 4


def analyze(planes, bsize, pic_w, pic_h, plane_dec, mc_planes=None,
            device="cpu", dtype=torch.int32):
    """The coefficient planes of one frame.

    planes: the source's (pic_h, pic_w) uint8 planes; bsize: the frame's
    block-size map; mc_planes: the OBMC prediction's frame-sized uint8
    planes for an inter frame, None for a keyframe.  Returns the list of
    `d` planes and, for an inter frame, the list of `md` planes."""
    fw, fh = (pic_w + 63) & ~63, (pic_h + 63) & ~63
    ds, mds = [], []
    for pli, plane in enumerate(planes):
        xdec, ydec = plane_dec[pli]
        pw, ph = fw >> xdec, fh >> ydec
        m = _torch_masks(analysis_masks(bsize, fw, fh, pic_w, pic_h, xdec),
                         device)
        c = lap_frame(_lift(pad_plane(plane, pw, ph), device, dtype),
                      64 >> xdec, 64 >> ydec)
        zs = [c]
        if mc_planes is not None:
            mc = lap_frame(_lift(mc_planes[pli], device, dtype),
                           64 >> xdec, 64 >> ydec)
            cw = (pic_w + (1 << xdec) - 1) >> xdec
            ch = (pic_h + (1 << ydec) - 1) >> ydec
            outside = ((torch.arange(pw, device=device)[None, :] >= cw)
                       | (torch.arange(ph, device=device)[:, None] >= ch))
            zs = [torch.where(outside, mc, c), mc]
        outs = []
        for z in zs:
            for bsi in range(NBSIZES - 1, 0, -1):
                n = 4 << (bsi - xdec)
                z = split_filter(z, m["split_h"][bsi], m["split_v"][bsi], n)
            outs.append(leaf_transform(z, m["leaf"]))
        if mc_planes is None:
            d = outs[0]
            for bsi in range(1, NBSIZES):
                d = _dc_merge(d, m["merge"][bsi], 4 << (bsi - xdec))
            ds.append(d)
        else:
            ds.append(outs[0])
            mds.append(outs[1])
    return ds if mc_planes is None else (ds, mds)
