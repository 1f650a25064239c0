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

Where JAX maps over the 1,089 offsets one at a time, the port computes
each tile's fields for one reference in one call of ops/cuda/
sad_kernels.py sad_fields: on the card a kernel with a block per vertex
window, on the CPU its plain version (one dy at a time with all 2R+1 dx
at once, an `unfold` view of the reference rows).  The host consumes
the fields in the native full_pel_search / global_mv_search as exact
lookups, so its decisions equal the direct computation's
(tests/test_torch_mefield.py).

The fields are cut by vertex windows over the mesh of a placement hook
(`device_put_fn`, parallel/sharding.py; without one, the whole field is
one tile on `device`): a tile owns the vertex rows and
columns that the hook's spec gives its device (split_units over the
vertices) and computes their windows' SADs from the cells under them.
Vertex j's window is the 8 cells from cell 8j - x0 (x0 the margin
below), so a tile of vertices [j0, j1) reads the current plane's
columns [8 (8 j0 - x0), 8 (8 j1 - x0)), clipped to the visible area,
and the reference window's same columns plus 2r more (the window
starts r to the left of the current plane); rows likewise.  The tiles'
cells are the plane's cells under them, so the fields are equal.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.device import resolve
from daala_tpu_torch.ops.cuda.sad_kernels import sad_fields
from daala_tpu_torch.parallel.sharding import stage_hook
from daala_tpu_torch.utils import devstats

# Level-0 vertex spacing: 64 px = 8 cells of 8 px (mc.py
# OD_LOG_MVBSIZE_MIN + OD_LOG_MVB_DELTA0).
_CELL = 8
_WIN_CELLS = 8  # 64-px window = 8 cells


def _margin(nv, ch):
    """The cell grid's offset in the windows' grid: 4 zero cells of
    margin turn every clipped window into a uniform 8x8-cell block
    (vertex (i, j) covers padded cell rows [8i, 8i+8)); both inputs are
    zero beyond the visible area so the margin cells carry no SAD.  The
    start clamps as JAX's dynamic_update_slice does."""
    return max(0, min(4, nv * _WIN_CELLS - ch))


def _vertex_cut(i0, i1, margin, ncells):
    """Vertices [i0, i1) of one axis: their cells [a, b) (clipped to the
    ncells of the visible area) and the offset of cell a in the tile's
    window grid."""
    a = max(0, _WIN_CELLS * i0 - margin)
    b = min(ncells, _WIN_CELLS * i1 - margin)
    return a, b, a + margin - _WIN_CELLS * i0


def _window_tiles(vis, nvb, nhb, sharding):
    """The tiles of vertex windows under `sharding`: per tile its device,
    its vertex slices, the offset of its first cell in its window grid,
    and the current plane's pixel box (py0, py1, px0, px1) under its
    windows, None when they hold no visible cell."""
    vis_h, vis_w = vis
    ch, cw = -(-vis_h // _CELL), -(-vis_w // _CELL)
    my, mx = _margin(nvb, ch), _margin(nhb, cw)
    spec = sharding.spec + (None,) * (2 - len(sharding.spec))
    rows, cols = sharding.bounds(nvb, spec[0]), sharding.bounds(nhb, spec[1])
    out = []
    for ki in range(len(rows) - 1):
        for kj in range(len(cols) - 1):
            i0, i1, j0, j1 = rows[ki], rows[ki + 1], cols[kj], cols[kj + 1]
            if i0 >= i1 or j0 >= j1:
                continue
            ya, yb, oy = _vertex_cut(i0, i1, my, ch)
            xa, xb, ox = _vertex_cut(j0, j1, mx, cw)
            box = (None if ya >= yb or xa >= xb else
                   (ya * _CELL, min(yb * _CELL, vis_h),
                    xa * _CELL, min(xb * _CELL, vis_w)))
            out.append((sharding.device_of((ki, kj)),
                        (slice(i0, i1), slice(j0, j1)), (oy, ox), box))
    return out


def tile_window(ref_padded, pad, r, box):
    """The reference window that sad_fields takes for a tile whose current
    pixels are `box` (py0, py1, px0, px1) of the plane: the padded
    reference plane (padding `pad` >= r) from r above and left of the
    box to r below and right of it, as contiguous uint8."""
    py0, py1, px0, px1 = box
    return np.ascontiguousarray(ref_padded[pad - r + py0:pad + r + py1,
                                           pad - r + px0:pad + r + px1],
                                np.uint8)


def fullpel_sad_fields(cur, refs_padded, pad, vis, nvmvbs, nhmvbs, r=16,
                       *, device, device_put_fn=None):
    """Compute the full-pel SAD fields for every search reference on
    `device` (one tile), or in tiles of vertex windows over the mesh of
    `device_put_fn` (whose first device must be `device`).

    cur: (H, W) uint8 current luma (frame-sized); refs_padded: list of
    padded uint8 reference planes; vis = (vis_h, vis_w).  Returns a list
    of numpy int32 (noff, nvb, nhb) arrays, one per reference, where
    nvb = nvmvbs // 8 + 1, nhb = nhmvbs // 8 + 1.  The global-search SAD
    field is their sum over (nvb, nhb).  The planes travel as uint8 and
    widen on the device; each tile's part of the current plane is
    uploaded once.  Runs in the devstats span "fullpel_sad_fields"; each
    reference's computation on a tile is a torch.profiler range of that
    name."""
    put_fn = stage_hook(device_put_fn, resolve(device))
    nvb = nvmvbs // 8 + 1
    nhb = nhmvbs // 8 + 1
    noff = (2 * r + 1) ** 2
    with devstats.span("fullpel_sad_fields"):
        tiles = _window_tiles(vis, nvb, nhb, put_fn.sharding)
        curs = [None if box is None else devstats.upload(
                    np.ascontiguousarray(cur[box[0]:box[1], box[2]:box[3]],
                                         np.uint8), dev)
                for dev, _, _, box in tiles]
        pending = []
        for rp in refs_padded:
            parts = []
            for (dev, (rows, cols), (oy, ox), box), cur_t in zip(tiles, curs):
                if box is None:
                    fields = torch.zeros(
                        (noff, rows.stop - rows.start,
                         cols.stop - cols.start),
                        dtype=torch.int32, device=dev)
                else:
                    win_t = devstats.upload(tile_window(rp, pad, r, box),
                                            dev)
                    devstats.dispatch()
                    with torch.profiler.record_function(
                            "fullpel_sad_fields"):
                        fields = sad_fields(
                            cur_t, win_t, r, rows.stop - rows.start,
                            cols.stop - cols.start, oy, ox)
                parts.append(((slice(None), rows, cols), fields))
            pending.append(parts)
        devstats.prefetch(*[f for parts in pending for _, f in parts])
        out = []
        for parts in pending:
            got = [(sl, devstats.fetch(f)) for sl, f in parts]
            if len(got) == 1:
                out.append(got[0][1])
                continue
            a = np.empty((noff, nvb, nhb), np.int32)
            for sl, f in got:
                a[sl] = f
            out.append(a)
        return out
