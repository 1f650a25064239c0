"""Device analysis front end on torch tensors: the encoder's transform
front end as one pass per plane.

The counterpart of daala_tpu/models/keyframe.py, function for function:

  pixels -> coefficient lift -> frame lapped prefilter (lap kernel)
  -> per-level masked split prefilters -> per-size blockwise DCT (DCT
  kernel), mask-combined -> masked Haar DC merges (bottom up)

plus the block-size-RDO transform pyramid of the trial pass.  The
block-size map is host data, turned into per-level masks on the host
(build_analysis_masks walks the exact recursion).  All arithmetic is
int32 lifting, bit-exact with the host path on any device; the native
entropy pass consumes the returned planes unchanged and produces
byte-identical packets (tests/test_torch_encoder.py).

Functions that take tensors compute on the tensors' device; the
analyze_* entry points take numpy planes and an explicit `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.ops import _lifting as L
from daala_tpu_torch.device import resolve
from daala_tpu_torch.ops.cuda.dct_kernels import dct_frame
from daala_tpu_torch.ops.cuda.lap_kernels import lap_frame
from daala_tpu_torch.utils import devstats

OD_NBSIZES = 5


def build_analysis_masks(state, info, pli):
    """Walk the _compute_dcts recursion on the host block-size map and
    emit per-level masks for the device pass (a copy of
    daala_tpu.models.keyframe.build_analysis_masks, which lives in a
    module that imports jax).

    Returns a dict with, per node level bsi in 1..4 (plane node size
    n = 4 << (bsi - xdec)):
      split_h[bsi], split_v[bsi]: (nvnodes, nhnodes) uint8 — apply the
          horizontal-midline / vertical-midline lapped filter,
      merge[bsi]: same shape — Haar-merge the node's 4 child DCs,
    and leaf[bs_p] for plane leaf sizes bs_p in 0..4-xdec:
      (nvb, nhb) uint8 — this n x n block is a transform leaf.
    """
    xdec, ydec = info.plane_dec[pli]
    w = state.frame_width >> xdec
    h = state.frame_height >> ydec
    masks = {"split_h": {}, "split_v": {}, "merge": {}, "leaf": {}}
    for bsi in range(1, OD_NBSIZES):
        n = 4 << (bsi - xdec)
        shape = (h // n, w // n)
        masks["split_h"][bsi] = np.zeros(shape, np.uint8)
        masks["split_v"][bsi] = np.zeros(shape, np.uint8)
        masks["merge"][bsi] = np.zeros(shape, np.uint8)
    for bs_p in range(0, OD_NBSIZES - xdec):
        n = 4 << bs_p
        masks["leaf"][bs_p] = np.zeros((h // n, w // n), np.uint8)

    def rec(bx, by, bsi):
        obs = state.bsize4(bx << bsi, by << bsi)
        bs = max(obs, xdec)
        if bs == bsi:
            masks["leaf"][bsi - xdec][by, bx] = 1
            return
        bs_p = bsi - xdec
        hfilter = ((bx + 1) << (2 + bs_p)) <= info.pic_width
        vfilter = ((by + 1) << (2 + bs_p)) <= info.pic_height
        masks["split_h"][bsi][by, bx] = 1 if hfilter else 0
        masks["split_v"][bsi][by, bx] = 1 if vfilter else 0
        masks["merge"][bsi][by, bx] = 1
        for sub in ((0, 0), (1, 0), (0, 1), (1, 1)):
            rec(2 * bx + sub[0], 2 * by + sub[1], bsi - 1)

    for sby in range(state.nvsb):
        for sbx in range(state.nhsb):
            rec(sbx, sby, OD_NBSIZES - 1)
    return masks


def _band_idx(count, n, device):
    """(count, 4) indices of the 4-pixel band straddling the midline of
    each of `count` nodes of size n."""
    starts = torch.arange(count, device=device) * n + n // 2 - 2
    return starts[:, None] + torch.arange(4, device=device)[None, :]


def _masked_split_filter(c, hmask, vmask, n):
    """Apply od_prefilter_split midline filters to every split node of
    size n, vectorized: full-width/height 4-px bands filtered once, kept
    only where the node is split (daala_tpu/ops/filter.py
    prefilter_split semantics, rows then cols).  Masks are bool."""
    h, w = c.shape
    # Horizontal midlines: rows y0 + n/2 - 2 .. + 2 of each node row.
    idx = _band_idx(h // n, n, c.device)
    band = c[idx]  # (nby, 4, w)
    band_f = torch.stack(L.pre_filter4([band[:, k, :] for k in range(4)]),
                         dim=1)
    keep = hmask.repeat_interleave(n, dim=1)[:, None, :]
    c = c.clone()
    c[idx] = torch.where(keep, band_f, band)
    # Vertical midlines.
    idx = _band_idx(w // n, n, c.device)
    band = c[:, idx]  # (h, nbx, 4)
    band_f = torch.stack(L.pre_filter4([band[:, :, k] for k in range(4)]),
                         dim=2)
    keep = vmask.repeat_interleave(n, dim=0)[:, :, None]
    c[:, idx] = torch.where(keep, band_f, band)
    return c


def _masked_dc_merge(d, mmask, n):
    """Haar-merge the four child DCs of each split node of size n
    (encoder.py _compute_dcts tail; note the b/c swap).  mmask is bool."""
    half = n // 2
    a = d[0::n, 0::n]
    b = d[0::n, half::n]
    cc = d[half::n, 0::n]
    dd = d[half::n, half::n]
    # haar_kernel(a, cc, b, dd) -> (k0, k1, k2, k3); writes: (0,0)=k0,
    # (0,half)=k2, (half,0)=k1, (half,half)=k3.
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


def _prefilter_frame_dec(c, xdec, ydec):
    """Frame lapped prefilter with per-axis superblock sizes
    (filter.py apply_prefilter_frame_sbs for a decimated plane), through
    the lap kernel on a CUDA tensor."""
    return lap_frame(c, sb_x=64 >> xdec, sb_y=64 >> ydec, forward=True)


def _lift_input(plane, fpr_mode, lossless):
    """Input lift to the coefficient domain (od_ref_buf_to_coeff,
    reference: src/state.c:1219-1256): 8-bit is (x - 128) << 4 (<< 0
    lossless); full-precision 12-bit buffers recenter on 2048, with the
    lossless shift running at the input depth.  `plane` is uint8, or
    int16 holding the values of a 12-bit uint16 buffer (_upload_plane)."""
    x = plane.to(torch.int32)
    if fpr_mode:
        s = (4 - 2 * (fpr_mode - 1)) if lossless else 0
        return (x - 2048 + (1 << s >> 1)) >> s
    return (x - 128) << (0 if lossless else 4)


def _leaf_dcts(c, leaf):
    """Per-size leaf DCTs, mask-combined: each n x n leaf of the map
    takes the n-point blockwise DCT of c."""
    d = torch.zeros_like(c)
    for bs_p in sorted(leaf.keys()):
        n = 4 << bs_p
        dn = dct_frame(c, n, forward=True)
        m = leaf[bs_p].repeat_interleave(n, dim=0).repeat_interleave(n, dim=1)
        d = torch.where(m, dn, d)
    return d


def keyframe_analysis_plane(plane, mask_args, xdec=0, ydec=0,
                            lossless=False, fpr_mode=0):
    """Device analysis of one keyframe plane: returns the `d` coefficient
    plane exactly as the host _compute_dcts pass produces it (before the
    Haar DC tree quantization, which is host-side sequential coding).

    mask_args: (split_h, split_v, merge, leaf) dicts of bool tensors."""
    (split_h, split_v, merge, leaf) = mask_args
    c = _lift_input(plane, fpr_mode, lossless)
    c = _prefilter_frame_dec(c, xdec, ydec)
    # Split prefilters, top level down.
    for bsi in range(OD_NBSIZES - 1, 0, -1):
        n = 4 << (bsi - xdec)
        c = _masked_split_filter(c, split_h[bsi], split_v[bsi], n)
    d = _leaf_dcts(c, leaf)
    # Haar DC merges, bottom up.
    for bsi in range(1, OD_NBSIZES):
        n = 4 << (bsi - xdec)
        d = _masked_dc_merge(d, merge[bsi], n)
    return d


def _upload_plane(plane, device):
    """A numpy plane on `device`, without widening: uint8 stays uint8,
    and a 12-bit uint16 buffer travels as int16 (torch's uint16 supports
    few ops; 12-bit values fit int16 unchanged)."""
    plane = np.asarray(plane)
    if plane.dtype == np.uint16:
        plane = np.ascontiguousarray(plane).view(np.int16)
    return devstats.upload(plane, device)


def _mask_tensors(masks, device):
    return tuple({k: devstats.upload(v, device).bool()
                  for k, v in masks[key].items()}
                 for key in ("split_h", "split_v", "merge", "leaf"))


def analyze_keyframe(state, info, padded_planes, lossless, device):
    """Run the device analysis for every plane of a keyframe; returns
    (d_dev, finish): the `d` planes as tensors on `device` (the PVQ band
    search reads them there) and a zero-argument finish() that fetches
    them as numpy int32 arrays (the host EC consumes those)."""
    device = resolve(device)
    out = []
    with devstats.span("analyze_keyframe"):
        for pli in range(info.nplanes):
            xdec, ydec = info.plane_dec[pli]
            mask_args = _mask_tensors(
                build_analysis_masks(state, info, pli), device)
            fpr_mode = (info.bitdepth_mode
                        if np.asarray(padded_planes[pli]).dtype == np.uint16
                        else 0)
            plane = _upload_plane(padded_planes[pli], device)
            devstats.dispatch()
            out.append(keyframe_analysis_plane(
                plane, mask_args, xdec=xdec, ydec=ydec,
                lossless=bool(lossless), fpr_mode=fpr_mode))

    def finish():
        with devstats.span("analyze_keyframe"):
            devstats.prefetch(*out)
            return [devstats.fetch(d) for d in out]
    return out, finish


def _pad_follows_prediction(c, mc, pic_w, pic_h):
    """Padding tracks the prediction so no bits are spent there
    (reference: src/encode.c:2662-2686); the substitution happens in the
    frame-prefiltered domain, matching the host order."""
    h, w = c.shape
    if pic_w is None or (pic_w >= w and pic_h >= h):
        return c
    col = torch.arange(w, device=c.device)[None, :] >= pic_w
    row = torch.arange(h, device=c.device)[:, None] >= pic_h
    return torch.where(col | row, mc, c)


def inter_analysis_plane(plane, mc_plane, mask_args, xdec=0, ydec=0,
                         lossless=False, fpr_mode=0, mc_fpr_mode=0,
                         pic_w=None, pic_h=None):
    """Device analysis of one inter-frame plane: (d, md) coefficient
    planes for the input and its OBMC prediction, exactly as the host
    per-block recursion produces them (frame lapped prefilter, input
    padding replaced by the filtered prediction, masked split
    prefilters, per-leaf DCT on both planes; no DC Haar tree on inter
    frames).  The host entropy pass consumes both unchanged
    (reference: od_encode_coefficients inter path,
    src/encode.c:2630-2686)."""
    (split_h, split_v, _merge, leaf) = mask_args  # no DC Haar tree
    c = _prefilter_frame_dec(_lift_input(plane, fpr_mode, lossless),
                             xdec, ydec)
    mc = _prefilter_frame_dec(_lift_input(mc_plane, mc_fpr_mode, lossless),
                              xdec, ydec)
    c = _pad_follows_prediction(c, mc, pic_w, pic_h)
    planes = []
    for z in (c, mc):
        for bsi in range(OD_NBSIZES - 1, 0, -1):
            n = 4 << (bsi - xdec)
            z = _masked_split_filter(z, split_h[bsi], split_v[bsi], n)
        planes.append(_leaf_dcts(z, leaf))
    return planes[0], planes[1]


def analyze_inter(state, info, padded_planes, mc_planes, lossless, device):
    """Device (d, md) analysis for every plane of an inter frame; the
    prediction planes come from the OBMC stage (OD_FRAME_SELF).  Returns
    (d_dev, md_dev, finish): the per-plane tensors on `device` (for the
    PVQ band search) and a zero-argument finish() that fetches them as
    the lists of numpy int32 `d` and `md` planes, so that the caller can
    queue dependent device work before paying the device->host copy."""
    device = resolve(device)
    d_out, md_out = [], []
    with devstats.span("analyze_inter"):
        for pli in range(info.nplanes):
            xdec, ydec = info.plane_dec[pli]
            mask_args = _mask_tensors(
                build_analysis_masks(state, info, pli), device)
            pic_w = (info.pic_width + (1 << xdec) - 1) >> xdec
            pic_h = (info.pic_height + (1 << ydec) - 1) >> ydec
            fpr_mode = (info.bitdepth_mode
                        if np.asarray(padded_planes[pli]).dtype == np.uint16
                        else 0)
            mc_fpr_mode = (info.bitdepth_mode
                           if info.full_precision_references else 0)
            plane = _upload_plane(padded_planes[pli], device)
            mc = _upload_plane(mc_planes[pli], device)
            devstats.dispatch()
            d, md = inter_analysis_plane(
                plane, mc, mask_args, xdec=xdec, ydec=ydec,
                lossless=bool(lossless), fpr_mode=fpr_mode,
                mc_fpr_mode=mc_fpr_mode, pic_w=pic_w, pic_h=pic_h)
            d_out.append(d)
            md_out.append(md)

    def finish():
        with devstats.span("analyze_inter"):
            devstats.prefetch(*(d_out + md_out))
            return ([devstats.fetch(d) for d in d_out],
                    [devstats.fetch(md) for md in md_out])
    return d_out, md_out, finish


# ---------------------------------------------------------------------------
# Block-size-RDO transform pyramid.
#
# During the trial-encode RDO pass (reference: od_encode_recursive with
# rdo_only, src/encode.c:1660-1850) every node of the luma block tree is
# evaluated: the "nosplit" hypothesis transforms the node span *before*
# its own split prefilter is applied, and the recursion always applies
# the split prefilter and descends.  So the forward-transform input of
# every hypothesis is fully determined by the original frame and the
# fixed all-split lapping structure, and the whole pyramid is one device
# pass: level l's tensor is the blockwise (4 << l)-point DCT of the frame
# after the frame prefilter and the split prefilters of all levels > l.
# The host trial pass consumes the tensors instead of re-running fdcts
# (native/frame_enc.inc block_encode_impl).


def _rdo_level_masks(state, info):
    """Full (all-split) hfilter/vfilter masks per luma level 1..4, with
    the reference's picture-edge conditions (src/encode.c:1760-1763).
    A copy of daala_tpu.models.keyframe._rdo_level_masks."""
    w = state.frame_width
    h = state.frame_height
    out = {}
    for bsi in range(1, OD_NBSIZES):
        n = 4 << bsi
        nby, nbx = h // n, w // n
        bxs = np.arange(nbx)[None, :]
        bys = np.arange(nby)[:, None]
        hm = ((bxs + 1) << (2 + bsi)) <= info.pic_width
        vm = ((bys + 1) << (2 + bsi)) <= info.pic_height
        out[bsi] = (np.broadcast_to(hm, (nby, nbx)).astype(np.uint8),
                    np.broadcast_to(vm, (nby, nbx)).astype(np.uint8))
    return out


def _pyramid_levels(c, level_masks):
    """Emit the per-level DCT tensors top-down while applying the
    all-split prefilters; level_masks[bsi] = (hmask, vmask) bool tensors."""
    out = {}
    for bsi in range(OD_NBSIZES - 1, -1, -1):
        n = 4 << bsi
        out[bsi] = dct_frame(c, n, forward=True)
        if bsi > 0:
            hm, vm = level_masks[bsi]
            c = _masked_split_filter(c, hm, vm, n)
    return out


def _allsplit_haar_merge(d):
    """Haar-merge the DC tree of an all-split 4x4 DCT plane bottom-up
    (the keyframe rdo pass's compute_dcts output; every node merges)."""
    h, w = d.shape
    for bsi in range(1, OD_NBSIZES):
        n = 4 << bsi
        ones = torch.ones((h // n, w // n), dtype=torch.bool, device=d.device)
        d = _masked_dc_merge(d, ones, n)
    return d


def rdo_pyramid_luma(plane, mc_plane, level_masks, lossless=False,
                     fpr_mode=0, mc_fpr_mode=0, is_keyframe=True,
                     pic_w=None, pic_h=None):
    """Device RDO pyramid for the luma plane.

    Returns (d_levels, md_levels, d_rdo_merged):
      d_levels[l], l=0..4: blockwise (4 << l) DCT of the input after the
          frame prefilter and the all-split prefilters of levels > l;
      md_levels: same for the OBMC prediction (inter frames; else None);
      d_rdo_merged: keyframes only — level-0 tensor with the full DC
          Haar merge tree applied (what compute_dcts produces on the
          all-4x4 map for the haar-DC quantization prep)."""
    c = _prefilter_frame_dec(_lift_input(plane, fpr_mode, lossless), 0, 0)
    if is_keyframe:
        d_levels = _pyramid_levels(c, level_masks)
        return d_levels, None, _allsplit_haar_merge(d_levels[0])
    mc = _prefilter_frame_dec(_lift_input(mc_plane, mc_fpr_mode, lossless),
                              0, 0)
    c = _pad_follows_prediction(c, mc, pic_w, pic_h)
    return (_pyramid_levels(c, level_masks),
            _pyramid_levels(mc, level_masks), None)


def analyze_rdo_pyramid(state, info, padded_planes, mc_planes, lossless,
                        device):
    """Run the device RDO pyramid for luma; returns
    (d_levels, md_levels_or_None, d_rdo_merged_or_None) as numpy int32
    dicts keyed by level.  mc_planes is None on keyframes."""
    device = resolve(device)
    is_keyframe = mc_planes is None
    with devstats.span("analyze_rdo_pyramid"):
        level_masks = {k: (devstats.upload(h, device).bool(),
                           devstats.upload(v, device).bool())
                       for k, (h, v) in _rdo_level_masks(state, info).items()}
        plane_np = np.asarray(padded_planes[0])
        fpr_mode = info.bitdepth_mode if plane_np.dtype == np.uint16 else 0
        plane = _upload_plane(plane_np, device)
        mc = None
        mc_fpr_mode = 0
        if not is_keyframe:
            mc = _upload_plane(mc_planes[0], device)
            mc_fpr_mode = (info.bitdepth_mode
                           if info.full_precision_references else 0)
        devstats.dispatch()
        d_l, md_l, d_m = rdo_pyramid_luma(
            plane, mc, level_masks, lossless=bool(lossless),
            fpr_mode=fpr_mode, mc_fpr_mode=mc_fpr_mode,
            is_keyframe=is_keyframe, pic_w=info.pic_width,
            pic_h=info.pic_height)
        d_out = {k: devstats.fetch(v) for k, v in d_l.items()}
        md_out = (None if md_l is None
                  else {k: devstats.fetch(v) for k, v in md_l.items()})
        dm_out = None if d_m is None else devstats.fetch(d_m)
        return d_out, md_out, dm_out
