"""Device motion-search cost fields on torch tensors.

The counterpart of daala_tpu/models/mefield.py.  The encoder-side BMA
init (native/me_enc.inc estimate_multi; reference intent: the SAD
pyramid of od_mv_est_init_mvs, src/mcenc.c:1333-1613, :3031) evaluates
every level-0 vertex against a dense +/-R full-pel window, and the
global motion search evaluates the same window over the whole visible
frame.  Both are decision-independent of the raster-scan predictor
chain (only the *rate* addend and the argmin are sequential), so the
complete SAD fields batch as one device pass:

  for each offset (dy, dx) in the (2R+1)^2 window:
    D = |cur - ref shifted by (dy, dx)| over the visible area
    cell-sum D into the 8x8-cell grid
    window-sum the cells into the level-0 vertex windows
      (each vertex's window [y0-32, y0+32) x [x0-32, x0+32) clipped to
       the visible frame is exactly an 8x8-cell block of a zero-padded
       cell grid, and the windows tile the frame, so the global-search
       SAD is the sum of the per-vertex window SADs)

Where JAX maps over the 1,089 offsets one at a time, the port takes one
dy at a time with all 2R+1 dx at once (an `unfold` view of the
reference rows).  The host consumes the fields in the native
full_pel_search / global_mv_search as exact lookups, so its decisions
equal the direct computation's (tests/test_torch_mefield.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from daala_tpu_torch.device import resolve
from daala_tpu_torch.utils import devstats

# Level-0 vertex spacing: 64 px = 8 cells of 8 px (mc.py
# OD_LOG_MVBSIZE_MIN + OD_LOG_MVB_DELTA0).
_CELL = 8
_WIN_CELLS = 8  # 64-px window = 8 cells


def _fullpel_fields(cur_vis, ref_win, r, nvb, nhb):
    """cur_vis: (vh, vw) uint8 visible current luma; ref_win:
    (vh + 2r, vw + 2r) uint8 reference window starting at (-r, -r); both
    tensors on one device.  Returns (noff, nvb, nhb) int32 per-vertex
    window SADs on that device, offsets in row-major (dy, dx) order,
    dy, dx in [-r, r].

    The differences are int16 (a cell SAD is at most 64*255 < 2^15) and
    the cell sums exact integers; the window sums over all offsets
    happen once, at the end."""
    vh, vw = cur_vis.shape
    ch = -(-vh // _CELL)
    cw = -(-vw // _CELL)
    # Pad once to cell-aligned int16 buffers; the visibility mask zeroes
    # the partial-cell overhang.
    py, px = ch * _CELL - vh, cw * _CELL - vw
    cur16 = F.pad(cur_vis.to(torch.int16), (0, px, 0, py))
    ref16 = F.pad(ref_win.to(torch.int16), (0, px, 0, py))
    mask = F.pad(torch.ones((vh, vw), dtype=torch.int16,
                            device=cur_vis.device), (0, px, 0, py))
    noffd = 2 * r + 1
    hh, ww = ch * _CELL, cw * _CELL
    cells = torch.empty((noffd, noffd, ch, cw), dtype=torch.int32,
                        device=cur_vis.device)
    for dy in range(noffd):
        # (hh, noffd, ww): every dx of this dy at once.
        ref = ref16[dy:dy + hh].unfold(1, ww, 1)
        d = (cur16[:, None, :] - ref).abs_().mul_(mask[:, None, :])
        cells[dy] = d.reshape(ch, _CELL, noffd, cw, _CELL) \
            .sum((1, 4), dtype=torch.int32).transpose(0, 1)
    cells = cells.view(noffd * noffd, ch, cw)
    # Vertex windows: 4 zero cells of margin on each side turn every
    # clipped window into a uniform 8x8-cell block (vertex (i, j) covers
    # padded cell rows [8i, 8i+8)); both inputs are zero beyond the
    # visible area so the margin cells carry no SAD.  The start clamps
    # as JAX's dynamic_update_slice does.
    hp, wp = nvb * _WIN_CELLS, nhb * _WIN_CELLS
    y0 = max(0, min(4, hp - ch))
    x0 = max(0, min(4, wp - cw))
    cp = torch.zeros((cells.shape[0], hp, wp), dtype=torch.int32,
                     device=cur_vis.device)
    cp[:, y0:y0 + ch, x0:x0 + cw] = cells
    return cp.view(-1, nvb, _WIN_CELLS, nhb, _WIN_CELLS) \
        .sum((2, 4), dtype=torch.int32)


def fullpel_sad_fields(cur, refs_padded, pad, vis, nvmvbs, nhmvbs, r=16,
                       *, device):
    """Compute the full-pel SAD fields for every search reference on
    `device`.

    cur: (H, W) uint8 current luma (frame-sized); refs_padded: list of
    padded uint8 reference planes; vis = (vis_h, vis_w).  Returns a list
    of numpy int32 (noff, nvb, nhb) arrays, one per reference, where
    nvb = nvmvbs // 8 + 1, nhb = nhmvbs // 8 + 1.  The global-search SAD
    field is their sum over (nvb, nhb).  The planes travel as uint8 and
    widen on the device.  Runs in the devstats span
    "fullpel_sad_fields"; each reference's computation is a
    torch.profiler range of that name."""
    device = resolve(device)
    vis_h, vis_w = vis
    nvb = nvmvbs // 8 + 1
    nhb = nhmvbs // 8 + 1
    with devstats.span("fullpel_sad_fields"):
        cur_vis = devstats.upload(
            np.ascontiguousarray(cur[:vis_h, :vis_w], np.uint8), device)
        pending = []
        for rp in refs_padded:
            win = devstats.upload(np.ascontiguousarray(
                rp[pad - r:pad + vis_h + r, pad - r:pad + vis_w + r],
                np.uint8), device)
            devstats.dispatch()
            with torch.profiler.record_function("fullpel_sad_fields"):
                pending.append(_fullpel_fields(cur_vis, win, r, nvb, nhb))
        devstats.prefetch(*pending)
        return [devstats.fetch(t) for t in pending]
