"""Colour-sweep MV refinement with its leaf evaluations on a torch
device.

The counterpart of daala_tpu/codec/mvest.py refine_sweep (:982), which
imports jax inside its body; the rest of that module is jax-free host
code and is used as it is (`_ref_slot_planes`, and the native
me_sweep_cands/me_sweep_rates helpers through daala_tpu.native).  Only
the leaf evaluations move: models/mesweep.py on `device`.  The colour
schedule, the strict-< acceptance in candidate order and the int64
delta accumulation are the JAX version's, so the same grid gives the
same MV field on any device.
"""

from __future__ import annotations

import numpy as np

from daala_tpu import native as native_mod
from daala_tpu.codec.mvest import _ref_slot_planes
from daala_tpu_torch.models import mesweep as MS
from daala_tpu_torch.utils import devstats


@devstats.span("refine_sweep")
def refine_sweep(grid, cur_luma, refs, info, lam, adapt, vis, frame_type,
                 iters, device, decimate=0):
    """Device colour-sweep MV refinement (models/mesweep.py): the Jacobi
    re-posing of the greedy refine_mvs coordinate descent.  Same cost
    semantics per evaluation (FieldCache cell SADs, exact rate model via
    the native me_sweep_cands/me_sweep_rates helpers); only the update
    schedule differs, so streams stay valid.  Returns the number of
    accepted MV changes.  Raises when the native engine is missing (the
    JAX version returns 0 and skips the refinement).  Runs in the
    devstats span `refine_sweep`."""
    lib = native_mod.get_lib()
    if lib is None:
        raise RuntimeError("refine_sweep needs the native engine "
                           "(me_sweep_cands / me_sweep_rates)")
    state = MS.SweepState(grid, info, cur_luma, _ref_slot_planes(refs, info),
                          vis, device)
    nh, nv = grid.nhmvbs, grid.nvmvbs
    stride = nh + 1
    vys, vxs = np.nonzero(grid.valid)
    levels = np.asarray([MS.vertex_level(vx, vy)
                         for vy, vx in zip(vys, vxs)], np.int32)
    # Colors: (level, delta0 parity, sublattice phase bit); same-color
    # vertices share no OBMC leaf (Jacobi sweeps commit jointly).
    ckey = (levels.astype(np.int64) << 4) \
        | (((vys // 8) & 1) << 3) | (((vxs // 8) & 1) << 2) \
        | (((vys % 8) != 0).astype(np.int64) << 1)
    colors = sorted(set(int(c) for c in ckey))
    gmv = getattr(grid, "global_mvs", []) or []
    maxc = 40

    def pack_cfg(verts, cands, ncand, rates, rate0):
        cfg = np.zeros(24, np.int64)
        cfg[0] = nh
        cfg[1] = nv
        cfg[2] = grid.valid.ctypes.data
        cfg[3] = grid.ref.ctypes.data
        cfg[4] = grid.mv.ctypes.data
        cfg[5] = grid.mv1.ctypes.data
        cfg[6] = adapt.mv_small_cdf.ctypes.data if adapt is not None \
            else 0
        cfg[7] = frame_type
        cfg[8] = len(gmv)
        for r, (gx, gy) in enumerate(gmv[:2]):
            cfg[9 + 2 * r] = gx
            cfg[10 + 2 * r] = gy
        cfg[13] = decimate
        cfg[14] = len(verts)
        cfg[15] = verts.ctypes.data
        cfg[16] = maxc
        cfg[17] = cands.ctypes.data
        cfg[18] = ncand.ctypes.data
        if rates is not None:
            cfg[19] = rates.ctypes.data
            cfg[20] = rate0.ctypes.data
        return cfg

    total_changed = 0
    if not iters or not colors:
        return total_changed
    # Committed field cell SADs + per-leaf SADs (cells kernel; no frame
    # assembly, only small grids come back).  The leaf lists are walked
    # once per call and accepted MVs go to the grid, not to them, so
    # these stay the same through every colour and iteration; the JAX
    # version recomputes the same numbers for each colour.
    cells, leafsad = MS.committed_stats(state)
    csum = np.zeros((state.ch + 1, state.cw + 1), np.int64)
    csum[1:, 1:] = cells.cumsum(0).cumsum(1)

    def rect(y0, x0, y1, x1):
        y1 = np.minimum(y1, state.ch)
        x1 = np.minimum(x1, state.cw)
        y0 = np.minimum(y0, state.ch)
        x0 = np.minimum(x0, state.cw)
        return (csum[y1, x1] - csum[y0, x1] - csum[y1, x0]
                + csum[y0, x0])

    for _ in range(iters):
        changed = 0
        for color in colors:
            sel = ckey == color
            if not sel.any():
                continue
            cvy = vys[sel]
            cvx = vxs[sel]
            n = len(cvy)
            # fc_region block sums per selected vertex (delta0 blocks
            # cover 8 cells each).
            by0 = np.maximum(cvy - 8, 0) // 8 * 8
            bx0 = np.maximum(cvx - 8, 0) // 8 * 8
            by1 = (np.minimum(cvy + 1, nv) + 7) // 8 * 8
            bx1 = (np.minimum(cvx + 1, nh) + 7) // 8 * 8
            base = rect(by0, bx0, by1, bx1)
            # Candidates + rates (exact native model, frozen field).
            verts = (cvy.astype(np.int32) << 16) \
                | cvx.astype(np.int32)
            verts = np.ascontiguousarray(verts, np.int32)
            cands = np.zeros((n, maxc, 2), np.int32)
            ncand = np.zeros(n, np.int32)
            lib.me_sweep_cands(pack_cfg(verts, cands, ncand, None,
                                        None).ctypes.data)
            rates = np.zeros((n, maxc), np.int64)
            rate0 = np.zeros(n, np.int64)
            lib.me_sweep_rates(pack_cfg(verts, cands, ncand, rates,
                                        rate0).ctypes.data)
            # Batched candidate leaf evaluations per class; rows are
            # built vectorized from the per-class instance arrays.
            delta = np.zeros((n, maxc), np.int64)
            vid_of = cvy.astype(np.int64) * stride + cvx
            vidx_lookup = {int(v): i for i, v in enumerate(vid_of)}
            for lms, cls in state.classes.items():
                a_vid, a_leaf = state.aff[lms]
                in_color = np.isin(a_vid, vid_of)
                if not in_color.any():
                    continue
                e_vid = a_vid[in_color]
                e_leaf = a_leaf[in_color]
                e_vi = np.asarray([vidx_lookup[int(v)] for v in e_vid],
                                  np.int64)
                counts = ncand[e_vi].astype(np.int64)
                rows_leaf = np.repeat(e_leaf, counts)
                rows_vi = np.repeat(e_vi, counts)
                tot = int(counts.sum())
                if not tot:
                    continue
                ends = counts.cumsum()
                rows_ci = (np.arange(tot, dtype=np.int64)
                           - np.repeat(ends - counts, counts))
                vid_arr = np.repeat(e_vid, counts)
                cnd = cands[rows_vi, rows_ci]          # (R, 2)
                mvs = cls["mvs"][rows_leaf].copy()
                sub = cls["cids"][rows_leaf] == vid_arr[:, None]
                mvs = np.where(sub[:, :, None], cnd[:, None, :], mvs)
                sads = MS.eval_leaf_batch(
                    state, lms, cls["pos"][rows_leaf],
                    cls["srcs"][rows_leaf], mvs, cls["ocs"][rows_leaf],
                    cls["ss"][rows_leaf])
                np.add.at(delta, (rows_vi, rows_ci),
                          sads.astype(np.int64)
                          - leafsad[lms][rows_leaf])
            # Acceptance: strict-<, candidate order (greedy-loop tie
            # semantics), committed jointly for the color.
            for i in range(n):
                vy, vx = int(cvy[i]), int(cvx[i])
                best_cost = (int(base[i]) << 5) + lam * int(rate0[i])
                best = None
                for c in range(int(ncand[i])):
                    cost = ((int(base[i]) + int(delta[i, c])) << 5) \
                        + lam * int(rates[i, c])
                    if cost < best_cost:
                        best_cost = cost
                        best = c
                if best is not None:
                    use1 = grid.ref[vy, vx] == 2
                    arr = grid.mv1 if use1 else grid.mv
                    arr[vy, vx, 0] = cands[i, best, 0]
                    arr[vy, vx, 1] = cands[i, best, 1]
                    changed += 1
        total_changed += changed
        if not changed:
            break
    return total_changed
