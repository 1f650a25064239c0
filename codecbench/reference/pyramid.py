"""The block-size trial pass's luma transform pyramid in plain PyTorch.

A frozen copy of the port's models/keyframe.py rdo_pyramid_luma (one
tile), written from the front end's pieces (frontend.py): the trial
pass evaluates every node of the luma block tree, and the forward
transform of each node's hypothesis reads the frame before that node's
own split prefilter, so every level follows from the frame alone:

  pixels -> padding -> coefficient lift -> frame lapped prefilter
  -> inter frames: the input's padding replaced by the filtered OBMC
     prediction
  -> for each level l from 4 down to 0: the (4 << l)-point blockwise
     DCT of the plane, then the split prefilter of every node of size
     4 << l that the picture holds whole (all split)
  -> keyframes: level 0 with the Haar merge of every node's DCs

`dtype` is the integer type of every lifting step: int32 as the codec
states it, int16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from codecbench.reference.frontend import (NBSIZES, _dc_merge, _lift,
                                           _torch_masks, analysis_masks,
                                           pad_plane, split_filter)
from codecbench.reference.transform import dct_frame, lap_frame


def _levels(c, m):
    out = {}
    for bsi in range(NBSIZES - 1, -1, -1):
        n = 4 << bsi
        out[bsi] = dct_frame(c, n)
        if bsi > 0:
            c = split_filter(c, m["split_h"][bsi], m["split_v"][bsi], n)
    return out


def rdo_pyramid(luma, pic_w, pic_h, mc=None, device="cpu",
                dtype=torch.int32):
    """(d_levels, md_levels, d_merged) of one frame's luma.

    luma: the source's (pic_h, pic_w) uint8 luma; mc: the OBMC
    prediction's frame-sized uint8 luma on an inter frame, None on a
    keyframe.  d_levels and md_levels map each level 0..4 to its plane
    (md_levels None on a keyframe); d_merged is level 0 with every DC
    Haar-merged (None on an inter frame)."""
    fw, fh = (pic_w + 63) & ~63, (pic_h + 63) & ~63
    # A map of 4x4 blocks splits every node: the all-split masks.
    m = _torch_masks(analysis_masks(np.zeros((fh >> 3, fw >> 3), np.int32),
                                    fw, fh, pic_w, pic_h, 0), device)
    c = lap_frame(_lift(pad_plane(luma, fw, fh), device, dtype), 64, 64)
    if mc is None:
        d = _levels(c, m)
        merged = d[0]
        for bsi in range(1, NBSIZES):
            merged = _dc_merge(merged, m["merge"][bsi], 4 << bsi)
        return d, None, merged
    p = lap_frame(_lift(mc, device, dtype), 64, 64)
    outside = ((torch.arange(fw, device=device)[None, :] >= pic_w)
               | (torch.arange(fh, device=device)[:, None] >= pic_h))
    return _levels(torch.where(outside, p, c), m), _levels(p, m), None
