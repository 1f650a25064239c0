"""Device frame synthesis on torch tensors: the decoder's reconstruction
back end as one pass per plane.

The counterpart of daala_tpu/models/synthesis.py, and the mirror of the
port's analysis front end (models/keyframe.py): the per-block IDCT +
recursive split postfilters + frame lapped postfilter of the host
decoder (decoder.py _block_decode / _decode_recursive /
_decode_coefficients tails; reference: src/decode.c:482-598 block
synthesis, src/filter.c:1486-1610 postfilters):

  leaf coefficients `d` -> per-size masked blockwise IDCT (DCT kernel)
    -> masked split postfilters (bottom-up: children before parents,
       vertical midlines before horizontal, matching od_postfilter_split)
    -> frame lapped postfilter (lap kernel: vertical superblock edges
       then horizontal)

The host entropy decoder produces the leaf `d` plane and the block-size
map; everything after that is int32 lifting, bit-exact with the host
reconstruction on any device (tests/test_torch_synthesis.py).  It works
for intra and inter frames alike: both reconstruct as the IDCT of the
final leaf coefficients (inter leaves hold prediction + residual by the
time the parse finishes).  models/restore.py dering_frame_device then
applies the parsed dering levels.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.device import resolve
from daala_tpu_torch.models.keyframe import _band_idx, build_analysis_masks
from daala_tpu_torch.ops import _lifting as L
from daala_tpu_torch.ops.cuda.dct_kernels import dct_frame
from daala_tpu_torch.ops.cuda.lap_kernels import lap_frame
from daala_tpu_torch.utils import devstats

OD_NBSIZES = 5


def _masked_split_postfilter(c, hmask, vmask, n):
    """od_postfilter_split for every split node of size n, vectorized
    and masked (inverse of keyframe._masked_split_filter): vertical
    midlines first, then horizontal.  Masks are bool."""
    h, w = c.shape
    # Vertical midlines (cols), gated by vmask.
    idx = _band_idx(w // n, n, c.device)
    band = c[:, idx]  # (h, nbx, 4)
    band_f = torch.stack(L.post_filter4([band[:, :, k] for k in range(4)]),
                         dim=2)
    keep = vmask.repeat_interleave(n, dim=0)[:, :, None]
    c = c.clone()
    c[:, idx] = torch.where(keep, band_f, band)
    # Horizontal midlines (rows), gated by hmask.
    idx = _band_idx(h // n, n, c.device)
    band = c[idx]  # (nby, 4, w)
    band_f = torch.stack(L.post_filter4([band[:, k, :] for k in range(4)]),
                         dim=1)
    keep = hmask.repeat_interleave(n, dim=1)[:, None, :]
    c[idx] = torch.where(keep, band_f, band)
    return c


def _postfilter_frame_dec(c, xdec, ydec):
    """Frame lapped postfilter (filter.py apply_postfilter_frame_sbs):
    vertical superblock edges first, then horizontal, through the lap
    kernel on a CUDA tensor."""
    return lap_frame(c, sb_x=64 >> xdec, sb_y=64 >> ydec, forward=False)


def synthesis_plane(d, mask_args, xdec=0, ydec=0):
    """Device synthesis of one plane: leaf coefficient plane `d` (int32,
    as the host entropy decode leaves it) -> reconstructed coefficient
    plane `c` (int32, pre-dering), bit-exact with the host path.

    mask_args: (split_h, split_v, merge, leaf) dicts of bool tensors, as
    keyframe.build_analysis_masks gives them (merge is unused here: the
    decoder un-merges the DC tree during symbol decode; a leaf size
    missing from `leaf` has no leaf)."""
    (split_h, split_v, _merge, leaf) = mask_args
    # Per-size leaf IDCTs, mask-combined.
    c = torch.zeros_like(d)
    for bs_p in sorted(leaf.keys()):
        n = 4 << bs_p
        cn = dct_frame(d, n, forward=False)
        m = leaf[bs_p].repeat_interleave(n, dim=0).repeat_interleave(n, dim=1)
        c = torch.where(m, cn, c)
    # Split postfilters, bottom level up (children before parents).
    for bsi in range(1, OD_NBSIZES):
        n = 4 << (bsi - xdec)
        c = _masked_split_postfilter(c, split_h[bsi], split_v[bsi], n)
    return _postfilter_frame_dec(c, xdec, ydec)


def synthesize_frame(state, info, d_planes, device):
    """Run the device synthesis for every plane on `device`; returns the
    reconstructed (pre-dering) coefficient planes as numpy int32, one
    fetch per plane.  Leaf sizes absent from a plane's map are not
    transformed."""
    device = resolve(device)
    out = []
    with devstats.span("synthesize_frame"):
        for pli in range(info.nplanes):
            xdec, ydec = info.plane_dec[pli]
            masks = build_analysis_masks(state, info, pli)
            masks["leaf"] = {k: v for k, v in masks["leaf"].items()
                             if v.any()}
            split_h, split_v, leaf = (
                {k: devstats.upload(v, device).bool()
                 for k, v in masks[key].items()}
                for key in ("split_h", "split_v", "leaf"))
            d = devstats.upload(np.asarray(d_planes[pli], np.int32), device)
            devstats.dispatch()
            out.append(synthesis_plane(d, (split_h, split_v, None, leaf),
                                       xdec=xdec, ydec=ydec))
        devstats.prefetch(*out)
        return [devstats.fetch(c) for c in out]
