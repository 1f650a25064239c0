"""Device OBMC prediction on torch tensors.

The counterpart of daala_tpu/models/obmc.py: the host walks the mesh
once and emits flat per-size-class leaf lists (build_leaf_lists); the
device then predicts every leaf of a class in one pass (the obmc_blend
kernel on a CUDA device, its plain version on the CPU):

  gather the 4 (n+5, n+5) corner windows from the 4 reference planes
  -> 6-tap horizontal filter -> int16 wrap (8-bit) -> 6-tap vertical
  filter -> clip -> merged-weight blend with the (oc, s) weights
  -> scatter of the disjoint leaves into the plane

bit-exact with the host predictor (codec/mc.py mc_predict_frame;
tests/test_torch_obmc.py).  The JAX version pads each class to a power
of two for its jit cache; here every class is one call of its own size.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.codec.mc import (OD_LOG_MVB_DELTA0, OD_MVB_DELTA0,
                                      OD_BUFFER_PADDING, OD_VERT_DX,
                                      OD_VERT_DY, VERT_SETUP_DX,
                                      VERT_SETUP_DY, div_pow2_re)
from daala_tpu_torch.device import resolve
from daala_tpu_torch.ops.cuda import obmc_kernels as OK
from daala_tpu_torch.utils import devstats


def build_leaf_lists(grid, info, pli):
    """Walk the mesh (pred_block recursion) and emit per-size-class leaf
    arrays for the device pass (a copy of
    daala_tpu.models.obmc.build_leaf_lists, which lives in a module that
    imports jax).

    Returns {log_mvb_sz: dict(pos=(L,2) [y,x] plane px, srcs=(L,4) uint8
    frame slots, mvs=(L,4,2) [mvx,mvy] plane 1/8-pel, ocs=(L,), ss=(L,))}
    in raster-scan leaf order."""
    xdec, ydec = info.plane_dec[pli]
    nh, nv = grid.nhmvbs, grid.nvmvbs
    valid = grid.valid
    ref = grid.ref
    mv = grid.mv
    mv1 = grid.mv1
    out = {}

    def leaf(vx, vy, lms, oc, s):
        dxp = VERT_SETUP_DX[oc][s]
        dyp = VERT_SETUP_DY[oc][s]
        srcs = np.empty(4, np.int32)
        mvs = np.empty((4, 2), np.int32)
        for k in range(4):
            gy = vy + dyp[k] * (1 << lms)
            gx = vx + dxp[k] * (1 << lms)
            r = ref[gy, gx]
            m = mv1 if r == 2 else mv
            srcs[k] = r
            mvs[k, 0] = div_pow2_re(int(m[gy, gx, 0]), xdec)
            mvs[k, 1] = div_pow2_re(int(m[gy, gx, 1]), ydec)
        cls = out.setdefault(lms, {"pos": [], "srcs": [], "mvs": [],
                                   "ocs": [], "ss": []})
        cls["pos"].append((vy << (3 - ydec), vx << (3 - xdec)))
        cls["srcs"].append(srcs)
        cls["mvs"].append(mvs)
        cls["ocs"].append(oc)
        cls["ss"].append(s)

    def rec(vx, vy, lms):
        half = 1 << lms >> 1
        if lms > 0 and valid[vy + half, vx + half]:
            rec(vx, vy, lms - 1)
            rec(vx + half, vy, lms - 1)
            rec(vx, vy + half, lms - 1)
            rec(vx + half, vy + half, lms - 1)
            return
        if lms < OD_LOG_MVB_DELTA0:
            mask = (1 << (lms + 1)) - 1
            oc = 1 if (vx & mask) else 0
            if vy & mask:
                oc = 3 - oc
            s1vx = vx + (OD_VERT_DX[(oc + 1) & 3] << lms)
            s1vy = vy + (OD_VERT_DY[(oc + 1) & 3] << lms)
            s3vx = vx + (OD_VERT_DX[(oc + 3) & 3] << lms)
            s3vy = vy + (OD_VERT_DY[(oc + 3) & 3] << lms)
            s = (int(valid[s1vy, s1vx]) | int(valid[s3vy, s3vx]) << 1)
        else:
            oc, s = 0, 3
        leaf(vx, vy, lms, oc, s)

    for vy in range(0, nv, OD_MVB_DELTA0):
        for vx in range(0, nh, OD_MVB_DELTA0):
            rec(vx, vy, OD_LOG_MVB_DELTA0)
    for lms, cls in out.items():
        cls["pos"] = np.asarray(cls["pos"], np.int32)
        cls["srcs"] = np.stack(cls["srcs"]).astype(np.int32)
        cls["mvs"] = np.stack(cls["mvs"]).astype(np.int32)
        cls["ocs"] = np.asarray(cls["ocs"], np.int32)
        cls["ss"] = np.asarray(cls["ss"], np.int32)
    return out


def _upload_leaves(planes4, pos, srcs, mvs, ocs, ss, log_x, log_y, pad):
    """One size class packed by leaf_args, on the planes' device."""
    scal = OK.leaf_args(pos, srcs, mvs, ocs, ss, pad, log_x, log_y,
                        planes4.shape[1:])
    devstats.dispatch()
    return devstats.upload(scal, planes4.device)


def predict_leaves(planes4, pos, srcs, mvs, ocs, ss, log_x, log_y, pad):
    """Predict all leaves of one size class: (L, ny, nx) blended blocks
    in the planes' type (uint8, or uint16 for 12-bit references), on the
    planes' device.  planes4: (4, Hp, Wp) tensor; the leaf arrays are
    numpy, as build_leaf_lists gives them.  Raises when a corner window
    leaves its plane (the JAX version's gather would clamp or wrap)."""
    scal = _upload_leaves(planes4, pos, srcs, mvs, ocs, ss, log_x, log_y,
                          pad)
    return OK.obmc_blend(planes4, scal, log_x, log_y)


def predict_frame_plane_device(grid, ref_imgs, ref_imgi, info, pli, device):
    """Whole-plane OBMC prediction on `device`: the (h, w) predicted
    plane as numpy (uint8, or uint16 for FPR references)."""
    device = resolve(device)
    xdec, ydec = info.plane_dec[pli]
    h = info.frame_height >> ydec
    w = info.frame_width >> xdec
    planes = []
    for r in range(4):
        idx = ref_imgi[r]
        if idx is None or idx < 0:
            idx = 0
        planes.append(np.asarray(ref_imgs[idx].planes[pli]))
    planes4 = devstats.upload(np.stack(planes), device)
    pad = OD_BUFFER_PADDING >> xdec
    dst = torch.zeros((h, w), dtype=OK.bits(planes4).dtype, device=device)
    for lms, cls in sorted(build_leaf_lists(grid, info, pli).items()):
        log_x = lms + 3 - xdec
        log_y = lms + 3 - ydec
        scal = _upload_leaves(planes4, cls["pos"], cls["srcs"], cls["mvs"],
                              cls["ocs"], cls["ss"], log_x, log_y, pad)
        blocks = OK.obmc_blend(planes4, scal, log_x, log_y)
        # Columns 13-14 of the leaf arguments are the leaves' (py, px).
        rows = scal[:, 13:14] + torch.arange(1 << log_y, device=device)
        cols = scal[:, 14:15] + torch.arange(1 << log_x, device=device)
        dst[rows[:, :, None], cols[:, None, :]] = OK.bits(blocks)
    return devstats.fetch(dst.view(planes4.dtype), dtype=None)
