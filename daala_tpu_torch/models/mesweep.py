"""Device colour-sweep MV refinement on torch tensors: the leaf and cell
SADs that codec/mvest.py refine_sweep evaluates.

The counterpart of daala_tpu/models/mesweep.py.  Vertices are 4-coloured
so that same-colour vertices share no OBMC leaf; every (vertex,
candidate) of a colour is evaluated against the frozen committed field
in one batched device pass per leaf size (the obmc_leaf_cells kernel on
a CUDA device, its plain version on the CPU), and only the small
per-cell SAD grids come back to the host.  Leaf spans are 8-px-cell
aligned, so a leaf's SAD is the sum of its cells.

SweepState keeps the four reference slot planes ((4, Hp, Wp) uint8) and
the visible current luma ((vh, vw) uint8) resident on its device; the
kernel reads both as they are.  The JAX version's int32 staging with DMA
margins (stage_planes_i32, the padded cur_i32) and its power-of-two
padding of each batch are TPU and jit-cache devices, and are not ported.
"""

from __future__ import annotations

import numpy as np

from daala_tpu_torch.codec import mc as MC
from daala_tpu_torch.device import resolve
from daala_tpu_torch.models import obmc as OB
from daala_tpu_torch.ops.cuda import obmc_kernels as OK
from daala_tpu_torch.parallel.sharding import stage_hook
from daala_tpu_torch.utils import devstats

_CELL = 8


def vertex_level(vx, vy):
    t = ((0, 6, 4, 6, 2, 6, 4, 6), (6, 5, 6, 5, 6, 5, 6, 5),
         (4, 6, 3, 6, 4, 6, 3, 6), (6, 5, 6, 5, 6, 5, 6, 5),
         (2, 6, 4, 6, 1, 6, 4, 6), (6, 5, 6, 5, 6, 5, 6, 5),
         (4, 6, 3, 6, 4, 6, 3, 6), (6, 5, 6, 5, 6, 5, 6, 5))
    return t[vy & 7][vx & 7]


class SweepState:
    """Per-frame device/host state for the colour sweeps.  With a
    placement hook (`device_put_fn`, parallel/sharding.py) the planes go
    whole to its first device, which must be `device`: every sweep
    reads OBMC windows anywhere in the reference planes (splitting the
    leaves by the tile that owns them is left for later)."""

    def __init__(self, grid, info, cur_luma, planes4, vis, device,
                 device_put_fn=None):
        self.grid = grid
        self.info = info
        self.vis_h, self.vis_w = vis
        self.ch = -(-self.vis_h // _CELL)
        self.cw = -(-self.vis_w // _CELL)
        self.pad = MC.OD_BUFFER_PADDING
        self.device = stage_hook(device_put_fn, resolve(device)).device
        p4 = np.stack([np.ascontiguousarray(p, np.uint8) for p in planes4])
        self.planes4 = devstats.upload(p4, self.device)
        self.cur_vis = devstats.upload(
            np.ascontiguousarray(cur_luma[:self.vis_h, :self.vis_w],
                                 np.uint8), self.device)
        self.rebuild_leaves()

    def rebuild_leaves(self):
        """(Re)walk the mesh into per-class leaf arrays, corner ids, and
        the affected-leaf instance arrays (vertex id -> leaves)."""
        grid, info = self.grid, self.info
        self.classes = OB.build_leaf_lists(grid, info, 0)
        stride = grid.nhmvbs + 1
        vsdx = np.asarray(MC.VERT_SETUP_DX, np.int64)  # (4, 4, 4)
        vsdy = np.asarray(MC.VERT_SETUP_DY, np.int64)
        self.aff = {}
        for lms, cls in self.classes.items():
            dxp = vsdx[cls["ocs"], cls["ss"]]           # (L, 4)
            dyp = vsdy[cls["ocs"], cls["ss"]]
            vy = (cls["pos"][:, 0] >> 3)[:, None]
            vx = (cls["pos"][:, 1] >> 3)[:, None]
            gy = vy + dyp * (1 << lms)
            gx = vx + dxp * (1 << lms)
            cids = (gy * stride + gx).astype(np.int64)
            cls["cids"] = cids
            L = cids.shape[0]
            leaf_idx = np.repeat(np.arange(L, dtype=np.int64), 4)
            pairs = np.unique(
                np.stack([cids.ravel(), leaf_idx], 1), axis=0)
            self.aff[lms] = (pairs[:, 0], pairs[:, 1])


def leaf_cells_batch(state, lms, pos, srcs, mvs, ocs, ss):
    """Batched per-8px-cell SADs of one class's (possibly
    corner-substituted) leaves: (L, n/8, n/8) int32 numpy."""
    log_n = lms + 3
    scal = OK.leaf_args(pos, srcs, mvs, ocs, ss, state.pad, log_n, log_n,
                        state.planes4.shape[1:])
    devstats.dispatch()
    return devstats.fetch(OK.obmc_leaf_cells(
        state.planes4, state.cur_vis, devstats.upload(scal, state.device),
        log_n))


def eval_leaf_batch(state, lms, pos, srcs, mvs, ocs, ss):
    """Batched total leaf SADs of one class (visible-clipped)."""
    return leaf_cells_batch(state, lms, pos, srcs, mvs, ocs,
                            ss).sum((1, 2)).astype(np.int64)


def committed_stats(state):
    """Cell SAD grid + per-leaf SADs of the committed field via the
    cells kernel (no frame assembly)."""
    cells = np.zeros((state.ch, state.cw), np.int64)
    leafsad = {}
    for lms, cls in state.classes.items():
        lc = leaf_cells_batch(state, lms, cls["pos"], cls["srcs"],
                              cls["mvs"], cls["ocs"], cls["ss"])
        leafsad[lms] = lc.sum((1, 2)).astype(np.int64)
        nc = 1 << lms
        cy0 = cls["pos"][:, 0] // 8
        cx0 = cls["pos"][:, 1] // 8
        rows = np.broadcast_to(
            cy0[:, None, None] + np.arange(nc)[None, :, None],
            lc.shape)
        cols = np.broadcast_to(
            cx0[:, None, None] + np.arange(nc)[None, None, :],
            lc.shape)
        m = (rows < state.ch) & (cols < state.cw)
        np.add.at(cells, (rows[m], cols[m]),
                  lc.astype(np.int64)[m])
    return cells, leafsad
