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

synthesize_frame places each `d` plane with a placement hook
(`device_put_fn`, parallel/sharding.py named_put; without one, the
plane is one tile on `device`), which cuts it into tiles on superblock
boundaries, one per device of the mesh.  The IDCTs and split postfilters run on
every tile's interior (its nodes and blocks are the plane's); then each
tile takes a halo of 2 pixels, corners included, from its neighbours'
results (ShardedPlane.exchange_halo: the one exchange between devices),
the lap kernel runs the frame postfilter from the tile's origin, and
the halo is cut off.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.device import resolve
from daala_tpu_torch.models.keyframe import (_band_idx, _cut,
                                             build_analysis_masks)
from daala_tpu_torch.ops import _lifting as L
from daala_tpu_torch.ops.cuda.dct_kernels import dct_frame
from daala_tpu_torch.ops.cuda.lap_kernels import lap_tile
from daala_tpu_torch.parallel.sharding import fetch_all, stage_hook
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


def _postfilter_frame_dec(c, xdec, ydec, tile=None):
    """Frame lapped postfilter (filter.py apply_postfilter_frame_sbs):
    vertical superblock edges first, then horizontal, through the lap
    kernel on a CUDA tensor.  On a tile (c laid out as its data, the
    halo filled) the plane's edges in the tile are filtered and the
    tile's interior returned."""
    return lap_tile(c, 64 >> xdec, 64 >> ydec, False, tile)


def _leaf_synthesis(d, mask_args, xdec, at=(0, 0)):
    """The leaf IDCTs, mask-combined, then the split postfilters bottom
    level up (children before parents): synthesis_plane before its frame
    postfilter.  `at`: d's place in the plane."""
    (split_h, split_v, _merge, leaf) = mask_args
    c = torch.zeros_like(d)
    for bs_p in sorted(leaf.keys()):
        n = 4 << bs_p
        cn = dct_frame(d, n, forward=False, origin=at)
        m = leaf[bs_p].repeat_interleave(n, dim=0).repeat_interleave(n, dim=1)
        c = torch.where(m, cn, c)
    for bsi in range(1, OD_NBSIZES):
        n = 4 << (bsi - xdec)
        c = _masked_split_postfilter(c, split_h[bsi], split_v[bsi], n)
    return c


def synthesis_plane(d, mask_args, xdec=0, ydec=0):
    """Device synthesis of one plane: leaf coefficient plane `d` (int32,
    as the host entropy decode leaves it) -> reconstructed coefficient
    plane `c` (int32, pre-dering), bit-exact with the host path.

    mask_args: (split_h, split_v, merge, leaf) dicts of bool tensors, as
    keyframe.build_analysis_masks gives them (merge is unused here: the
    decoder un-merges the DC tree during symbol decode; a leaf size
    missing from `leaf` has no leaf)."""
    return _postfilter_frame_dec(_leaf_synthesis(d, mask_args, xdec), xdec,
                                 ydec)


def _synthesis_masks(masks, xdec, tile):
    """(split_h, split_v, None, leaf) bool tensors on the tile's device,
    cut to its interior."""
    split_h, split_v = (
        {k: devstats.upload(_cut(v, 4 << (k - xdec), tile),
                            tile.device).bool()
         for k, v in masks[key].items()}
        for key in ("split_h", "split_v"))
    leaf = {k: devstats.upload(_cut(v, 4 << k, tile), tile.device).bool()
            for k, v in masks["leaf"].items()}
    return split_h, split_v, None, leaf


def synthesize_frame(state, info, d_planes, device, device_put_fn=None):
    """Run the device synthesis for every plane on `device` (one tile
    each), or in tiles over the mesh of `device_put_fn` (whose first
    device must be `device`); returns the reconstructed (pre-dering)
    coefficient planes as numpy int32, every fetch started before the
    first is waited for.  Leaf sizes absent from a plane's map are not
    transformed."""
    put_fn = stage_hook(device_put_fn, resolve(device))
    out = []
    with devstats.span("synthesize_frame"):
        for pli in range(info.nplanes):
            xdec, ydec = info.plane_dec[pli]
            masks = build_analysis_masks(state, info, pli)
            masks["leaf"] = {k: v for k, v in masks["leaf"].items()
                             if v.any()}
            d_np = np.asarray(d_planes[pli], np.int32)
            sp = put_fn(d_np, pli, unit=(64 >> ydec, 64 >> xdec))
            cs = []
            for t in sp.tiles:
                devstats.dispatch()
                cs.append(_leaf_synthesis(
                    t.data, _synthesis_masks(masks, xdec, t), xdec,
                    t.start))
            halo = sp.replace(cs).exchange_halo(2)
            out.append(halo.replace([
                _postfilter_frame_dec(t.data, xdec, ydec, t)
                for t in halo.tiles]))
        return fetch_all(out)
