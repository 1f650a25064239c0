"""Motion estimation (encoder side, non-normative).

A TPU-friendly redesign of the reference's mesh ME (reference:
src/mcenc.c): instead of the sequential BMA + decimation heap + row/col
Viterbi refinement, we do a dense windowed block search per level-0 vertex,
fully vectorizable, followed by subpel refinement using the exact
normative interpolation (mc.predict1fmv), so the SAD we minimize is the
SAD the decoder's prediction will realize.

The mesh subdivides greedily down to level 3 by default at complexity
>= 6 (encoder knobs mv_level_max / mv_level_min; reference analogues
OD_SET_MV_LEVEL_MAX/MIN, src/encode.c:349-409): each subdivision
candidate is accepted when its rate-distortion gain clears the MV-rate
lambda, with per-vertex reference selection on B-frames and adaptive MV
resolution (select_mv_res_native).  The hot candidate evaluations (OBMC
prediction + SAD) run in the native engine (native/me_enc.inc) or as
batched device cost fields (models/mefield.py) when a TPU is present.

The port's copy of daala_tpu/codec/mvest.py; tests/test_torch_copies.py
holds it to the original.  Its `refine_sweep` is the port's: the leaf
evaluations run in models/mesweep.py on a torch `device` (the
original's reach jax).  The colour schedule, the strict-< acceptance
in candidate order and the int64 delta accumulation are the JAX
version's, so the same grid gives the same MV field on any device.
"""

from __future__ import annotations

import math

import numpy as np

from daala_tpu_torch.codec import mc as MC
from daala_tpu_torch.utils import devstats

# Subdivision level of a mesh vertex given its position mod 8
# (reference: src/mcenc.c:57-66).
OD_MC_LEVEL = ((0, 6, 4, 6, 2, 6, 4, 6), (6, 5, 6, 5, 6, 5, 6, 5),
               (4, 6, 3, 6, 4, 6, 3, 6), (6, 5, 6, 5, 6, 5, 6, 5),
               (2, 6, 4, 6, 1, 6, 4, 6), (6, 5, 6, 5, 6, 5, 6, 5),
               (4, 6, 3, 6, 4, 6, 3, 6), (6, 5, 6, 5, 6, 5, 6, 5))


def vertex_level(vx, vy):
    return OD_MC_LEVEL[vy & MC.OD_MVB_MASK][vx & MC.OD_MVB_MASK]


def _ge3_rate_q3(k):
    """Rate estimate (Q3 bits) for a generic-coded MV magnitude k =
    |offset| - 3; reproduces OD_MV_GE3_EST_RATE's exp-Golomb-shaped model
    (reference: src/mcenc.c:2105-2139): 1 bit for 0, else
    2*floor(log2(k+1)) + 2 bits."""
    if k <= 0:
        return 8
    return 8 * (2 * (int(k + 1).bit_length() - 1) + 2)


def mv_small_rate_est(adapt):
    """Per-symbol rate (Q3 bits) of the 4x4 small-MV CDF, evaluated on the
    frame-start (just reset) adaptation state
    (reference: src/mcenc.c:6419-6427)."""
    cdf = adapt.mv_small_cdf
    out = np.zeros((5, 16), np.int32)
    for i in range(5):
        tot = math.log2(float(cdf[i, 15]))
        for j in range(16):
            # Clamp to >= 1: the live adaptation state can in principle
            # carry a zero-width bin mid-sequence, and log2(0) would
            # abort the encode (a zero-probability bin just gets a large
            # estimated rate instead).
            p = max(1.0, float(cdf[i, j] - (cdf[i, j - 1] if j else 0)))
            out[i, j] = int(8 * (tot - math.log2(p)) + 0.5)
    return out


def cand_bits_q3(sre, equal_mvs, dx, dy, predx, predy, ref, ref_pred):
    """Estimated bits (Q3) to code the MV (dx, dy) against its predictor
    (reference: od_mv_est_cand_bits, src/mcenc.c:2142-2174)."""
    ox = dx - predx
    oy = dy - predy
    cost = ((ox != 0) + (oy != 0)) * 8
    cost += int(sre[equal_mvs, min(abs(oy), 3) * 4 + min(abs(ox), 3)])
    if abs(ox) >= 3:
        cost += _ge3_rate_q3(min(abs(ox) - 3, 255))
        if abs(ox) > 255:
            cost += abs(ox) - 255
    if abs(oy) >= 3:
        cost += _ge3_rate_q3(min(abs(oy) - 3, 255))
        if abs(oy) > 255:
            cost += abs(oy) - 255
    if ref_pred != ref:
        cost += 8
    return cost


def vertex_bits_q3(grid, sre, vx, vy, mv_res=0, frame_type=1):
    """Estimated bits (Q3) to code the grid vertex as currently set
    (reference: od_mv_est_bits, src/mcenc.c:2177-2198)."""
    level = vertex_level(vx, vy)
    ref = int(grid.ref[vy, vx])
    pred, equal_mvs = MC.get_predictor(grid, vx, vy, level, mv_res, ref)
    ref_pred = MC.get_ref_predictor(grid, frame_type, vx, vy, level)
    mvarr = grid.mv1 if ref == MC.OD_FRAME_NEXT else grid.mv
    dx = int(mvarr[vy, vx, 0]) >> mv_res
    dy = int(mvarr[vy, vx, 1]) >> mv_res
    return cand_bits_q3(sre, equal_mvs, dx, dy, pred[0], pred[1], ref,
                        ref_pred)


_DEP_OFFS = (-8, -4, -2, -1, 0, 1, 2, 4, 8)


def _dependents(grid, vx, vy):
    """Valid vertices (incl. (vy,vx) itself) whose MV predictor list can
    reference (vy, vx); changing this vertex changes their coding cost.
    Neighbor lists only ever look +-mvb_sz away (reference:
    src/mc.c:2036-2095), so the candidates live on power-of-two offsets."""
    out = []
    for dy in _DEP_OFFS:
        wy = vy + dy
        if not 0 <= wy <= grid.nvmvbs:
            continue
        for dx in _DEP_OFFS:
            wx = vx + dx
            if not 0 <= wx <= grid.nhmvbs or not grid.valid[wy, wx]:
                continue
            if dy == 0 and dx == 0:
                out.append((wy, wx))
                continue
            cn = MC._corner_neighbors(grid, wx, wy, vertex_level(wx, wy))
            if any(c is not None and c[0] == vy and c[1] == vx
                   for c in cn):
                out.append((wy, wx))
    return out


def grid_rate_q3(grid, sre, mv_res=0, frame_type=1):
    """Total estimated MV bits (Q3) of the current mesh at the given
    resolution."""
    total = 0
    for vy in range(grid.nvmvbs + 1):
        for vx in range(grid.nhmvbs + 1):
            if grid.valid[vy, vx]:
                total += vertex_bits_q3(grid, sre, vx, vy, mv_res,
                                        frame_type)
    return total


def _block_window(plane_pad, pad, y0, x0, n, h, w):
    """The search template: the n x n region centered on the vertex,
    clipped to the frame."""
    ya = max(0, y0 - n // 2)
    xa = max(0, x0 - n // 2)
    yb = min(h, y0 + n // 2)
    xb = min(w, x0 + n // 2)
    return ya, xa, yb, xb


def full_pel_search(cur, ref_pad, pad, y0, x0, n, search_range, h, w,
                    rd=None):
    """Exhaustive full-pel search of the clipped window centered at
    (y0, x0); returns (mvy, mvx) in pixels.  With rd = (lam, sre, pred8,
    equal_mvs) the objective is the reference BMA cost
    (sad << OD_ERROR_SCALE) + lambda * cand_bits (reference:
    od_mv_est_init_mvs, src/mcenc.c:2695-2697); without it, plain SAD
    with a small zero bias."""
    ya, xa, yb, xb = _block_window(None, pad, y0, x0, n, h, w)
    if yb <= ya or xb <= xa:
        return 0, 0
    tpl = cur[ya:yb, xa:xb].astype(np.int32)
    best = None
    best_mv = (0, 0)
    r = search_range
    # Vectorize over candidate rows: build SAD surface row by row.
    for dy in range(-r, r + 1):
        sy = pad + ya + dy
        row = ref_pad[sy:sy + (yb - ya), pad + xa - r:pad + xb + r]
        rowi = row.astype(np.int32)
        for dx in range(-r, r + 1):
            cand = rowi[:, r + dx:r + dx + (xb - xa)]
            sad = int(np.abs(cand - tpl).sum())
            if rd is None:
                # Bias toward the zero vector to stabilize flat areas.
                cost = sad + 2 * (abs(dx) + abs(dy))
            else:
                lam, sre, pred8, equal_mvs = rd
                cost = (sad << 5) + lam * cand_bits_q3(
                    sre, equal_mvs, dx * 8, dy * 8, pred8[0], pred8[1],
                    0, 0)
            if best is None or cost < best:
                best = cost
                best_mv = (dy, dx)
    return best_mv


def subpel_refine(cur, ref_pad, pad, y0, x0, n, mv8, h, w, rd=None):
    """Refine the 1/8-pel MV around the current candidate using the
    normative subpel interpolation; with rd, minimize the same
    rate-biased cost as full_pel_search (reference: od_mv_subpel_refine,
    src/mcenc.c:6438-6530)."""
    ya, xa, yb, xb = _block_window(None, pad, y0, x0, n, h, w)
    if yb <= ya or xb <= xa:
        return mv8
    tpl = cur[ya:yb, xa:xb].astype(np.int32)

    def cost_of(mv):
        pred = MC.predict1fmv(ref_pad, pad, ya, xa, mv[1], mv[0],
                              yb - ya, xb - xa)
        sad = int(np.abs(pred.astype(np.int32) - tpl).sum())
        if rd is None:
            return sad
        lam, sre, pred8, equal_mvs = rd
        return (sad << 5) + lam * cand_bits_q3(
            sre, equal_mvs, mv[1], mv[0], pred8[0], pred8[1], 0, 0)

    best_mv = mv8
    best = cost_of(mv8)
    if rd is not None:
        # The predictor is always worth a look: it is the cheapest MV.
        lam, sre, pred8, equal_mvs = rd
        pcand = (pred8[1], pred8[0])
        c = cost_of(pcand)
        if c < best:
            best = c
            best_mv = pcand
    for step in (4, 2, 1):
        improved = True
        while improved:
            improved = False
            for dmy, dmx in ((0, step), (0, -step), (step, 0), (-step, 0)):
                cand = (best_mv[0] + dmy, best_mv[1] + dmx)
                c = cost_of(cand)
                if c < best:
                    best = c
                    best_mv = cand
                    improved = True
    return best_mv


def global_mv_search(cur, ref_pad, pad, h, w, search_range):
    """Whole-frame dominant-motion estimate: exhaustive full-pel SAD over
    the frame followed by subpel hill-climbing.  Used to seed the
    per-vertex searches — window-clipped templates at mesh corners are
    easily fooled by reconstruction noise, while the frame-level SAD
    finds coherent translation robustly (the role EPZS predictor
    propagation plays in the reference, src/mcenc.c:2656-2940)."""
    tpl = cur[:h, :w].astype(np.int32)
    r = search_range
    best = None
    best_mv = (0, 0)
    for dy in range(-r, r + 1):
        row = ref_pad[pad + dy:pad + dy + h, pad - r:pad + w + r]
        rowi = row.astype(np.int32)
        for dx in range(-r, r + 1):
            sad = int(np.abs(rowi[:, r + dx:r + dx + w] - tpl).sum())
            if best is None or sad < best:
                best = sad
                best_mv = (dy, dx)
    mv8 = (best_mv[0] * 8, best_mv[1] * 8)
    # Subpel: template is the whole frame (window size 2*max dim clips
    # to the full picture).
    return subpel_refine(cur, ref_pad, pad, h // 2, w // 2,
                         2 * max(h, w), mv8, h, w)


def estimate(grid: MC.MVGrid, cur_luma, ref_img, info, search_range=16,
             ref_index=MC.OD_FRAME_PREV, lam=None, adapt=None, vis=None):
    """Fill the MV grid: level-0 vertices only (all valid), MVs against
    the given reference image, 1/8-pel precision."""
    estimate_multi(grid, cur_luma, [(ref_index, ref_img)], info,
                   search_range, lam=lam, adapt=adapt, vis=vis)


def estimate_multi(grid: MC.MVGrid, cur_luma, refs, info, search_range=16,
                   lam=None, adapt=None, vis=None):
    """Multi-reference level-0 estimation: refs is a list of
    (ref_index, RefImage); each vertex picks the reference with the best
    refined cost (B-frames pick between PREV and NEXT per vertex).

    With lam/adapt the per-candidate objective is the reference's BMA
    cost (sad << OD_ERROR_SCALE) + lambda * MV bits against the causal
    predictor (reference: od_mv_est_init_mvs, src/mcenc.c:2656-2940),
    which keeps the field coherent where the ref image is noisy."""
    grid.clear()
    # Only visible pixels participate in any SAD: replicated padding rows
    # would otherwise bias every search (notably whole-frame estimates).
    h, w = vis if vis is not None else cur_luma.shape
    pad = MC.OD_BUFFER_PADDING
    D0 = MC.OD_MVB_DELTA0
    clamp = MC.OD_UMV_CLAMP * 8
    sre = mv_small_rate_est(adapt) if adapt is not None and lam else None
    gmv = {ri: global_mv_search(cur_luma, img.planes[0], pad, h, w,
                                search_range)
           for ri, img in refs}
    grid.global_mvs = [(mv[1], mv[0]) for mv in gmv.values()]  # (x, y)
    for vy in range(0, grid.nvmvbs + 1, D0):
        for vx in range(0, grid.nhmvbs + 1, D0):
            y0 = vy << MC.OD_LOG_MVBSIZE_MIN
            x0 = vx << MC.OD_LOG_MVBSIZE_MIN
            best = None
            for ref_index, ref_img in refs:
                ref_pad = ref_img.planes[0]
                if sre is not None:
                    # Causal predictor: raster order means the level-0
                    # neighbors the decoder will use are already set.
                    pred8, eq = MC.get_predictor(grid, vx, vy, 0, 0,
                                                 ref_index)
                    rd = (lam, sre, (int(pred8[0]), int(pred8[1])), eq)
                else:
                    rd = None
                dy, dx = full_pel_search(cur_luma, ref_pad, pad, y0, x0,
                                         64, search_range, h, w, rd=rd)
                mv8 = subpel_refine(cur_luma, ref_pad, pad, y0, x0, 64,
                                    (dy * 8, dx * 8), h, w, rd=rd)
                # The frame-dominant MV competes as a second seed; this
                # keeps mesh corners from latching onto clipped-template
                # local optima.
                mv8g = subpel_refine(cur_luma, ref_pad, pad, y0, x0, 64,
                                     gmv[ref_index], h, w, rd=rd)
                if mv8g != mv8:
                    ya_, xa_, yb_, xb_ = _block_window(None, pad, y0, x0,
                                                       64, h, w)
                    if yb_ > ya_ and xb_ > xa_:
                        t = cur_luma[ya_:yb_, xa_:xb_].astype(np.int32)
                        sads = []
                        for cand in (mv8, mv8g):
                            pr = MC.predict1fmv(ref_pad, pad, ya_, xa_,
                                                cand[1], cand[0],
                                                yb_ - ya_, xb_ - xa_)
                            s = int(np.abs(pr.astype(np.int32) - t).sum())
                            if rd is not None:
                                s = (s << 5) + lam * cand_bits_q3(
                                    rd[1], rd[3], cand[1], cand[0],
                                    rd[2][0], rd[2][1], 0, 0)
                            sads.append(s)
                        if sads[1] < sads[0]:
                            mv8 = mv8g
                ya, xa, yb, xb = _block_window(None, pad, y0, x0, 64, h, w)
                if yb <= ya or xb <= xa:
                    cost = 0
                else:
                    pred = MC.predict1fmv(ref_pad, pad, ya, xa, mv8[1],
                                          mv8[0], yb - ya, xb - xa)
                    sad = int(np.abs(
                        pred.astype(np.int32)
                        - cur_luma[ya:yb, xa:xb].astype(np.int32)).sum())
                    if rd is not None:
                        cost = (sad << 5) + lam * cand_bits_q3(
                            rd[1], rd[3], mv8[1], mv8[0], rd[2][0],
                            rd[2][1], 0, 0)
                    else:
                        cost = sad
                if best is None or cost < best[0]:
                    best = (cost, ref_index, mv8)
            _, ref_index, mv8 = best
            grid.valid[vy, vx] = 1
            grid.ref[vy, vx] = ref_index
            mvx = int(np.clip(mv8[1], -clamp, clamp))
            mvy = int(np.clip(mv8[0], -clamp, clamp))
            if ref_index == MC.OD_FRAME_NEXT:
                grid.mv1[vy, vx, 0] = mvx
                grid.mv1[vy, vx, 1] = mvy
            else:
                grid.mv[vy, vx, 0] = mvx
                grid.mv[vy, vx, 1] = mvy


def _ref_slot_planes(refs_list, info, pli=0):
    """Resolve the per-ref-index padded planes used by the OBMC
    evaluators (the slot-fallback logic shared by refine_mesh /
    refine_mvs)."""
    ref_imgs = [None] * 4
    ref_imgi = [-1] * 4
    slots = {}
    for i, (ridx, rimg) in enumerate(refs_list):
        ref_imgs[i] = rimg
        slots[ridx] = i
    for ridx, i in slots.items():
        ref_imgi[ridx] = i
    if ref_imgi[MC.OD_FRAME_PREV] < 0 and MC.OD_FRAME_NEXT in slots:
        ref_imgi[MC.OD_FRAME_PREV] = slots[MC.OD_FRAME_NEXT]
    if ref_imgi[MC.OD_FRAME_NEXT] < 0 and MC.OD_FRAME_PREV in slots:
        ref_imgi[MC.OD_FRAME_NEXT] = slots[MC.OD_FRAME_PREV]
    if ref_imgi[MC.OD_FRAME_GOLD] < 0:
        ref_imgi[MC.OD_FRAME_GOLD] = ref_imgi[MC.OD_FRAME_PREV]
    planes = []
    for r in range(4):
        idx = ref_imgi[r]
        if idx is None or idx < 0:
            idx = 0
        img = ref_imgs[idx] if ref_imgs[idx] is not None else ref_imgs[0]
        planes.append(img.planes[pli])
    return planes


def estimate_all_native(grid, cur_luma, refs, info, search_range, lam,
                        adapt, vis, complexity, lam_sad, frame_type,
                        max_level=2, iters=2, mesh_search_range=8,
                        decimate=0, min_level=0, fp_fields=None,
                        telescope=0, use_satd=0, sel_gate_q4=0,
                        sel_disp_q8=0):
    """One native call covering estimate_multi + refine_mesh +
    refine_mvs (daala_tpu/native/me_enc.inc me_estimate), with decisions
    identical to the Python pipeline.  Returns True when the native
    engine ran.

    fp_fields: optional per-search-ref device SAD fields
    (models/mefield.py fullpel_sad_fields); consumed as exact lookups,
    decisions unchanged."""
    from daala_tpu_torch import native as native_mod
    lib = native_mod.get_lib()
    if lib is None:
        return False
    h, w = vis if vis is not None else cur_luma.shape
    pad = MC.OD_BUFFER_PADDING
    cur = np.ascontiguousarray(cur_luma, np.uint8)
    planes4 = _ref_slot_planes(refs, info)
    gout = np.zeros(4, np.int32)
    cfg = np.zeros(46, np.int64)
    # Selective-thorough subdivision gate (decimate=6), Q4 multiple of
    # the frame-mean cell SAD; 0 = native default (24 = 1.5x mean).
    cfg[44] = sel_gate_q4
    # Recoverability bypass gate (decimate=6): greedy fallback when
    # the mesh SAD gap over the BMA per-block floor is <=
    # sel_disp_q8/256 of the floor; 0 = native default (16 = 6.25%).
    cfg[45] = sel_disp_q8
    # Last frame's global vectors seed the whole-frame search's
    # early-abort limit (decision-neutral: the native search returns
    # the exact lexicographic (SAD, raster-index) minimum either way).
    prev_g = list(getattr(grid, "global_mvs", ()) or ())
    for i, (gx, gy) in enumerate(prev_g[:2]):
        cfg[40 + 2 * i] = int(gx)
        cfg[41 + 2 * i] = int(gy)
    keep_fp = []
    if fp_fields is not None:
        cfg[35] = search_range
        for i, t in enumerate(fp_fields[:2]):
            t = np.ascontiguousarray(t, np.int32)
            keep_fp.append(t)
            cfg[36 + i] = t.ctypes.data
    cfg[33] = decimate
    cfg[34] = min_level
    cfg[38] = telescope
    cfg[39] = use_satd
    cfg[0] = grid.nhmvbs
    cfg[1] = grid.nvmvbs
    cfg[2] = pad
    cfg[3] = planes4[0].strides[0]
    cfg[4] = cur.ctypes.data
    cfg[5] = cur.strides[0]
    cfg[6] = h
    cfg[7] = w
    cfg[8] = len(refs)
    for i, (ridx, rimg) in enumerate(refs[:2]):
        cfg[9 + 2 * i] = ridx
        cfg[10 + 2 * i] = rimg.planes[0].ctypes.data
    for i in range(4):
        cfg[13 + i] = planes4[i].ctypes.data
    cfg[17] = search_range
    cfg[18] = lam
    cfg[19] = complexity
    cfg[20] = frame_type
    cfg[21] = adapt.mv_small_cdf.ctypes.data if adapt is not None else 0
    cfg[22] = grid.valid.ctypes.data
    cfg[23] = grid.ref.ctypes.data
    cfg[24] = grid.mv.ctypes.data
    cfg[25] = grid.mv1.ctypes.data
    cfg[26] = lam_sad
    cfg[27] = cur.shape[0]
    cfg[28] = cur.shape[1]
    cfg[29] = mesh_search_range
    cfg[30] = max_level
    cfg[31] = iters
    cfg[32] = gout.ctypes.data
    lib.me_estimate(cfg.ctypes.data)
    grid.global_mvs = [(int(gout[2 * i]), int(gout[2 * i + 1]))
                       for i in range(len(refs))]
    return True


def select_mv_res_native(grid, cur_luma, refs, info, lam, adapt, vis,
                         frame_type, res_min=0):
    """Native MV-resolution selection (me_enc.inc me_select_mv_res);
    rounds the grid MVs in place and returns the chosen resolution, or
    None when the native engine is unavailable."""
    from daala_tpu_torch import native as native_mod
    lib = native_mod.get_lib()
    if lib is None:
        return None
    h, w = vis if vis is not None else cur_luma.shape
    pad = MC.OD_BUFFER_PADDING
    cur = np.ascontiguousarray(cur_luma, np.uint8)
    planes4 = _ref_slot_planes(refs, info)
    cfg = np.zeros(34, np.int64)
    cfg[0] = grid.nhmvbs
    cfg[1] = grid.nvmvbs
    cfg[2] = pad
    cfg[3] = planes4[0].strides[0]
    cfg[4] = cur.ctypes.data
    cfg[5] = cur.strides[0]
    cfg[6] = h
    cfg[7] = w
    for i in range(4):
        cfg[13 + i] = planes4[i].ctypes.data
    cfg[18] = lam
    cfg[20] = frame_type
    cfg[21] = adapt.mv_small_cdf.ctypes.data
    cfg[22] = grid.valid.ctypes.data
    cfg[23] = grid.ref.ctypes.data
    cfg[24] = grid.mv.ctypes.data
    cfg[25] = grid.mv1.ctypes.data
    cfg[27] = cur.shape[0]
    cfg[28] = cur.shape[1]
    cfg[29] = res_min
    return int(lib.me_select_mv_res(cfg.ctypes.data))


def _block_sad(cur, pred_plane, y0, x0, n_y, n_x):
    a = cur[y0:y0 + n_y, x0:x0 + n_x].astype(np.int32)
    b = pred_plane[y0:y0 + n_y, x0:x0 + n_x].astype(np.int32)
    return int(np.abs(a - b).sum())


def _affected_l0_blocks(vx, vy, mvb_sz, nh, nv):
    """Level-0 (64px) mesh blocks overlapping the squares adjacent to the
    vertex; pred_block is re-run on these to evaluate a candidate."""
    D0 = MC.OD_MVB_DELTA0
    bx0 = max(0, (vx - mvb_sz) // D0 * D0)
    by0 = max(0, (vy - mvb_sz) // D0 * D0)
    bx1 = min(nh, vx + mvb_sz)
    by1 = min(nv, vy + mvb_sz)
    out = []
    by = by0
    while by < by1:
        bx = bx0
        while bx < bx1:
            out.append((bx, by))
            bx += D0
        by += D0
    return out


def _majority_ref(grid, vx, vy, mvb_sz, nh, nv):
    refs = []
    for dy, dx in ((-1, -1), (-1, 1), (1, 1), (1, -1), (-1, 0), (1, 0),
                   (0, -1), (0, 1)):
        cy = vy + dy * mvb_sz
        cx = vx + dx * mvb_sz
        if 0 <= cy <= nv and 0 <= cx <= nh and grid.valid[cy, cx]:
            refs.append(int(grid.ref[cy, cx]))
    if not refs:
        return MC.OD_FRAME_PREV
    return max(set(refs), key=refs.count)


def refine_mesh(grid: MVGrid, cur_luma, ref_images, info, lam_sad,
                search_range=8, max_level=2, vis=None, lam=0,
                adapt=None, frame_type=1, min_level=0):
    """Encoder-side adaptive mesh subdivision.

    TPU-friendly replacement for the reference's decimation-heap + Viterbi
    refinement (reference: src/mcenc.c:4019,5211): instead of starting
    from the finest mesh and merging, we start from the level-0 mesh
    (already estimated) and greedily SPLIT where the true OBMC prediction
    SAD improves by more than lam_sad (an RD threshold covering the split
    flag + MV delta cost).  Candidate order and validity exactly mirror
    the bitstream's mesh coding order, so every accepted vertex is
    codeable.

    ref_images: {ref_index: RefImage} — used both for MV search and for
    the OBMC re-prediction.
    """
    h, w = vis if vis is not None else cur_luma.shape
    pad = MC.OD_BUFFER_PADDING
    nv, nh = grid.nvmvbs, grid.nhmvbs
    clamp = MC.OD_UMV_CLAMP * 8
    ref_imgs = [None] * 4
    ref_imgi = [-1] * 4
    slots = {}
    for i, (ridx, rimg) in enumerate(ref_images.items()):
        ref_imgs[i] = rimg
        slots[ridx] = i
    for ridx, i in slots.items():
        ref_imgi[ridx] = i
    if ref_imgi[MC.OD_FRAME_PREV] < 0 and MC.OD_FRAME_NEXT in slots:
        ref_imgi[MC.OD_FRAME_PREV] = slots[MC.OD_FRAME_NEXT]
    if ref_imgi[MC.OD_FRAME_NEXT] < 0 and MC.OD_FRAME_PREV in slots:
        ref_imgi[MC.OD_FRAME_NEXT] = slots[MC.OD_FRAME_PREV]
    if ref_imgi[MC.OD_FRAME_GOLD] < 0:
        ref_imgi[MC.OD_FRAME_GOLD] = ref_imgi[MC.OD_FRAME_PREV]
    scratch = np.zeros(cur_luma.shape, np.uint8)

    cur_u8 = np.ascontiguousarray(cur_luma, np.uint8)

    def eval_blocks(blocks):
        sad = 0
        for bx, by in blocks:
            r = MC.pred_l0_native(grid, ref_imgs, ref_imgi, info, scratch,
                                  0, bx, by, cur=cur_u8, vis=(h, w))
            if r is not None:
                sad += r
                continue
            MC.pred_block(grid, ref_imgs, ref_imgi, info, scratch, 0,
                          bx, by, MC.OD_LOG_MVB_DELTA0)
            y0 = by << MC.OD_LOG_MVBSIZE_MIN
            x0 = bx << MC.OD_LOG_MVBSIZE_MIN
            n = MC.OD_MVB_DELTA0 << MC.OD_LOG_MVBSIZE_MIN
            sad += _block_sad(cur_luma, scratch, y0, x0,
                              min(n, h - y0), min(n, w - x0))
        return sad

    sre = mv_small_rate_est(adapt) if adapt is not None else None

    def _deps_rate(vx, vy):
        if sre is None:
            return 0
        return sum(vertex_bits_q3(grid, sre, wx, wy, 0, frame_type)
                   for wy, wx in _dependents(grid, vx, vy))

    def try_vertex(vx, vy, mvb_sz, force=False):
        blocks = _affected_l0_blocks(vx, vy, mvb_sz, nh, nv)
        rate0 = _deps_rate(vx, vy)
        sad0 = eval_blocks(blocks)
        ridx = _majority_ref(grid, vx, vy, mvb_sz, nh, nv)
        # Both references compete for the vertex (when the frame codes
        # two): at motion boundaries — an occluder revealing
        # background — the majority ref of the neighbours is exactly
        # the wrong one for the revealed strip, and a block search
        # over the mixed-motion window on the wrong plane lands on
        # garbage.  The reference initializes every BMA block on every
        # active ref (od_mv_est_init_mvs, src/mcenc.c:3031).  Majority
        # ref first so earlier-candidate tie-breaking keeps the
        # single-ref behavior when both refs tie.
        ref_list = list(ref_images.items())
        if len(ref_list) > 1:
            if ref_list[0][0] != ridx:
                ref_list = ref_list[::-1]
        else:
            rimg0 = ref_images.get(ridx)
            if rimg0 is None:
                ridx = next(iter(ref_images))
                rimg0 = ref_images[ridx]
            ref_list = [(ridx, rimg0)]
        y0 = max(0, vy - mvb_sz) << MC.OD_LOG_MVBSIZE_MIN
        x0 = max(0, vx - mvb_sz) << MC.OD_LOG_MVBSIZE_MIN
        n = (2 * mvb_sz) << MC.OD_LOG_MVBSIZE_MIN
        level_v = vertex_level(vx, vy)
        best_cost = None
        best_xy = (0, 0)
        best_r = ridx
        for use_ridx, rimg in ref_list:
            # Candidate MV from a block search over the vertex's OBMC
            # influence window (centered:
            # [vy-mvb, vy+mvb] x [vx-mvb, vx+mvb]).
            dy, dx = full_pel_search(cur_luma, rimg.planes[0], pad, y0,
                                     x0, n, search_range, h, w)
            mv8 = subpel_refine(cur_luma, rimg.planes[0], pad, y0, x0, n,
                                (dy * 8, dx * 8), h, w)
            grid.valid[vy, vx] = 1
            grid.ref[vy, vx] = use_ridx
            # Candidate list: searched MV, median predictor, and the
            # mesh corner MVs this vertex interpolates between, judged
            # by the true OBMC RD cost (mirrors the native engine's
            # try_vertex).
            cands = []

            def add_cand(x, y):
                x = int(np.clip(x, -clamp, clamp))
                y = int(np.clip(y, -clamp, clamp))
                if (x, y) not in cands:
                    cands.append((x, y))

            add_cand(int(mv8[1]), int(mv8[0]))
            pred8, _eq = MC.get_predictor(grid, vx, vy, level_v, 0,
                                          use_ridx)
            add_cand(int(pred8[0]), int(pred8[1]))
            mvarr = grid.mv1 if use_ridx == MC.OD_FRAME_NEXT else grid.mv
            offs = (((-1, -1), (-1, 1), (1, 1), (1, -1)) if level_v & 1
                    else ((-1, 0), (0, -1), (1, 0), (0, 1)))
            for oy, ox in offs:
                cy2, cx2 = vy + oy * mvb_sz, vx + ox * mvb_sz
                if (0 <= cy2 <= nv and 0 <= cx2 <= nh
                        and grid.valid[cy2, cx2] and len(cands) < 8):
                    add_cand(int(mvarr[cy2, cx2, 0]),
                             int(mvarr[cy2, cx2, 1]))
            for cx2, cy2 in cands:
                mvarr[vy, vx] = (cx2, cy2)
                sad_c = eval_blocks(blocks)
                rate_c = _deps_rate(vx, vy)
                cost_c = (sad_c << 5) + lam * rate_c
                if best_cost is None or cost_c < best_cost:
                    best_cost = cost_c
                    best_xy = (cx2, cy2)
                    best_r = use_ridx
            # Reset the trial MV before the next ref pass.
            mvarr[vy, vx] = (0, 0)
        grid.ref[vy, vx] = best_r
        mvarr = grid.mv1 if best_r == MC.OD_FRAME_NEXT else grid.mv
        mvarr[vy, vx] = best_xy
        # Rate-aware split decision: the SAD gain must pay for the new
        # vertex's MV bits (and its effect on the neighbours'
        # predictors), with lam_sad as the acceptance margin.
        if force or (sad0 << 5) + lam * rate0 > best_cost + (lam_sad << 5):
            return True
        grid.valid[vy, vx] = 0
        grid.ref[vy, vx] = 0
        grid.mv[vy, vx] = (0, 0)
        grid.mv1[vy, vx] = (0, 0)
        return False

    level = 1
    log_mvb_sz = MC.OD_LOG_MVB_DELTA0 - 1
    while log_mvb_sz >= 0 and level <= max_level:
        mvb_sz = 1 << log_mvb_sz
        force = level <= min_level
        # Odd level: square centers, all 4 diagonal corners must be valid.
        for vy in range(mvb_sz, nv + 1, 2 * mvb_sz):
            for vx in range(mvb_sz, nh + 1, 2 * mvb_sz):
                if (grid.valid[vy - mvb_sz, vx - mvb_sz]
                        and grid.valid[vy - mvb_sz, vx + mvb_sz]
                        and grid.valid[vy + mvb_sz, vx + mvb_sz]
                        and grid.valid[vy + mvb_sz, vx - mvb_sz]):
                    try_vertex(vx, vy, mvb_sz, force)
        level += 1
        if level > max_level:
            break
        force = level <= min_level
        # Even level: edge midpoints, axial neighbors (clipped) valid.
        for vy in range(0, nv + 1, mvb_sz):
            vx0 = mvb_sz if not (vy & mvb_sz) else 0
            for vx in range(vx0, nh + 1, 2 * mvb_sz):
                ok = ((vy - mvb_sz < 0 or grid.valid[vy - mvb_sz, vx])
                      and (vx - mvb_sz < 0 or grid.valid[vy, vx - mvb_sz])
                      and (vy + mvb_sz > nv or grid.valid[vy + mvb_sz, vx])
                      and (vx + mvb_sz > nh
                           or grid.valid[vy, vx + mvb_sz]))
                if ok:
                    try_vertex(vx, vy, mvb_sz, force)
        level += 1
        log_mvb_sz -= 1


def refine_mvs(grid: MVGrid, cur_luma, ref_images, info, lam,
               adapt=None, iters=2, frame_type=1, vis=None):
    """Iterated rate-aware local MV refinement against the true OBMC
    objective.

    Counterpart of the reference's row/column Viterbi passes
    (reference: od_mv_est_refine_row/col, src/mcenc.c:5211,5875), greedy
    instead of DP but with the same cost function: visit every valid
    vertex in raster order and try a candidate set — neighbors' MVs, the
    MV predictor, the zero MV, and +-{1,2} 1/8-pel perturbations — and
    keep the candidate minimizing

        (OBMC SAD over influenced blocks << OD_ERROR_SCALE)
        + lambda * (MV bits of this vertex and every vertex whose
                    predictor references it)

    exactly the reference's units (reference: src/mcenc.c:2782,
    src/encint.h:50-53).  When adapt is None, falls back to a flat
    rate margin.
    """
    h, w = vis if vis is not None else cur_luma.shape
    nv, nh = grid.nvmvbs, grid.nhmvbs
    clamp = MC.OD_UMV_CLAMP * 8
    ref_imgs = [None] * 4
    ref_imgi = [-1] * 4
    slots = {}
    for i, (ridx, rimg) in enumerate(ref_images.items()):
        ref_imgs[i] = rimg
        slots[ridx] = i
    for ridx, i in slots.items():
        ref_imgi[ridx] = i
    if ref_imgi[MC.OD_FRAME_PREV] < 0 and MC.OD_FRAME_NEXT in slots:
        ref_imgi[MC.OD_FRAME_PREV] = slots[MC.OD_FRAME_NEXT]
    if ref_imgi[MC.OD_FRAME_NEXT] < 0 and MC.OD_FRAME_PREV in slots:
        ref_imgi[MC.OD_FRAME_NEXT] = slots[MC.OD_FRAME_PREV]
    if ref_imgi[MC.OD_FRAME_GOLD] < 0:
        ref_imgi[MC.OD_FRAME_GOLD] = ref_imgi[MC.OD_FRAME_PREV]
    scratch = np.zeros(cur_luma.shape, np.uint8)
    D0 = MC.OD_MVB_DELTA0
    cur32 = cur_luma.astype(np.int32)

    cur_u8 = np.ascontiguousarray(cur_luma, np.uint8)

    def eval_blocks(blocks):
        sad = 0
        for bx, by in blocks:
            r = MC.pred_l0_native(grid, ref_imgs, ref_imgi, info, scratch,
                                  0, bx, by, cur=cur_u8, vis=(h, w))
            if r is not None:
                sad += r
                continue
            MC.pred_block(grid, ref_imgs, ref_imgi, info, scratch, 0,
                          bx, by, MC.OD_LOG_MVB_DELTA0)
            y0 = by << MC.OD_LOG_MVBSIZE_MIN
            x0 = bx << MC.OD_LOG_MVBSIZE_MIN
            n = D0 << MC.OD_LOG_MVBSIZE_MIN
            ny = min(n, h - y0)
            nx = min(n, w - x0)
            a = cur32[y0:y0 + ny, x0:x0 + nx]
            b = scratch[y0:y0 + ny, x0:x0 + nx].astype(np.int32)
            sad += int(np.abs(a - b).sum())
        return sad

    def affected(vx, vy):
        out = []
        for by in range((max(0, vy - D0) // D0) * D0, min(vy + 1, nv), D0):
            for bx in range((max(0, vx - D0) // D0) * D0,
                            min(vx + 1, nh), D0):
                out.append((bx, by))
        return out

    sre = mv_small_rate_est(adapt) if adapt is not None else None

    verts = [(vy, vx) for vy in range(0, nv + 1)
             for vx in range(0, nh + 1) if grid.valid[vy, vx]]

    if sre is not None:
        # Whole-field candidates: greedy per-vertex moves cannot execute a
        # coordinated switch of the entire mesh (changing one vertex while
        # its blend partners disagree looks locally worse), so try setting
        # every vertex to one coherent MV — the frame-dominant vector(s)
        # and zero — and keep the best field as the starting point.
        all_blocks = [(bx, by) for by in range(0, nv, D0)
                      for bx in range(0, nh, D0)]

        def field_cost():
            rate = sum(vertex_bits_q3(grid, sre, wx, wy, 0, frame_type)
                       for wy, wx in verts)
            return (eval_blocks(all_blocks) << 5) + lam * rate

        best_cost = field_cost()
        best_field = (grid.mv.copy(), grid.mv1.copy())
        for g in list(getattr(grid, "global_mvs", ())) + [(0, 0)]:
            for vy, vx in verts:
                if grid.ref[vy, vx] == MC.OD_FRAME_NEXT:
                    grid.mv1[vy, vx] = g
                else:
                    grid.mv[vy, vx] = g
            c = field_cost()
            if c < best_cost:
                best_cost = c
                best_field = (grid.mv.copy(), grid.mv1.copy())
        np.copyto(grid.mv, best_field[0])
        np.copyto(grid.mv1, best_field[1])
    # Dirty-vertex worklist (mirrored by the native engine): an
    # evaluation reads MV/ref state only within Chebyshev distance
    # 2*D0 (neighbour candidates and predictors reach +-D0; rate
    # dependents chain one more predictor hop; the affected delta0
    # blocks blend corners within the same bound), so a vertex whose
    # dependency neighbourhood is unchanged since its last evaluation
    # provably re-selects its current MV.  Skipping it keeps the greedy
    # sequence — and the final field — bit-identical while later
    # iterations only revisit the converging frontier.
    dirty = np.ones((nv + 1, nh + 1), bool)
    _R = 2 * D0

    def mark_dirty(mvx, mvy):
        dirty[max(0, mvy - _R):min(nv, mvy + _R) + 1,
              max(0, mvx - _R):min(nh, mvx + _R) + 1] = True

    for _ in range(iters):
        changed = 0
        for vy, vx in verts:
            if not dirty[vy, vx]:
                continue
            dirty[vy, vx] = False
            use1 = grid.ref[vy, vx] == MC.OD_FRAME_NEXT
            mvarr = grid.mv1 if use1 else grid.mv
            cur_mv = (int(mvarr[vy, vx, 0]), int(mvarr[vy, vx, 1]))
            blocks = affected(vx, vy)
            if sre is not None:
                deps = _dependents(grid, vx, vy)

                def local_rate():
                    return sum(vertex_bits_q3(grid, sre, wx, wy, 0,
                                              frame_type)
                               for wy, wx in deps)
            else:
                deps = None
            level = vertex_level(vx, vy)
            ref = int(grid.ref[vy, vx])
            pred8 = None
            # Ordered, deduplicated candidate list (insertion order is
            # the tie-breaker, shared with the native port).
            cands = {(0, 0): True}
            for g in getattr(grid, "global_mvs", ()):
                cands[tuple(g)] = True
            neigh_cands = set()
            for dy, dx in ((-D0, 0), (D0, 0), (0, -D0), (0, D0)):
                ny_, nx_ = vy + dy, vx + dx
                if 0 <= ny_ <= nv and 0 <= nx_ <= nh \
                        and grid.valid[ny_, nx_]:
                    narr = grid.mv1 if use1 else grid.mv
                    c = (int(narr[ny_, nx_, 0]), int(narr[ny_, nx_, 1]))
                    cands[c] = True
                    neigh_cands.add(c)
            if sre is not None:
                # The predictor itself is the cheapest codable MV.
                p, _ = MC.get_predictor(grid, vx, vy, level, 0, ref)
                pred8 = (int(p[0]), int(p[1]))
                cands[pred8] = True
            for step in (1, 2):
                for ddy, ddx in ((0, step), (0, -step), (step, 0),
                                 (-step, 0)):
                    cands[(cur_mv[0] + ddx, cur_mv[1] + ddy)] = True
            cands.pop(cur_mv, None)
            if sre is not None:
                # Candidates carry their reference index so a vertex can
                # switch refs during refinement (mirrors the native
                # engine; the occlusion fix — a revealed-background
                # vertex seeded on PREV can flip to GOLD).
                cands3 = {(c[0], c[1], ref): True for c in cands}
                ref_idx_list = list(ref_images.keys())
                if len(ref_idx_list) > 1:
                    oref = (ref_idx_list[1] if ref_idx_list[0] == ref
                            else ref_idx_list[0])
                    cands3[(cur_mv[0], cur_mv[1], oref)] = True
                    oarr = (grid.mv1 if oref == MC.OD_FRAME_NEXT
                            else grid.mv)
                    for dy, dx in ((-D0, 0), (D0, 0), (0, -D0), (0, D0)):
                        ny_, nx_ = vy + dy, vx + dx
                        if 0 <= ny_ <= nv and 0 <= nx_ <= nh \
                                and grid.valid[ny_, nx_]:
                            cands3[(int(oarr[ny_, nx_, 0]),
                                    int(oarr[ny_, nx_, 1]), oref)] = True
                    p2, _ = MC.get_predictor(grid, vx, vy, level, 0,
                                             oref)
                    cands3[(int(p2[0]), int(p2[1]), oref)] = True
                cands3.pop((cur_mv[0], cur_mv[1], ref), None)
                o_mv = (int(grid.mv[vy, vx, 0]), int(grid.mv[vy, vx, 1]))
                o_mv1 = (int(grid.mv1[vy, vx, 0]),
                         int(grid.mv1[vy, vx, 1]))
                best_cost = ((eval_blocks(blocks) << 5)
                             + lam * local_rate())
                best_mv = cur_mv
                best_r = ref
                for cand in cands3:
                    cx = int(np.clip(cand[0], -clamp, clamp))
                    cy = int(np.clip(cand[1], -clamp, clamp))
                    cr = cand[2]
                    grid.mv[vy, vx] = o_mv
                    grid.mv1[vy, vx] = o_mv1
                    grid.ref[vy, vx] = cr
                    carr = (grid.mv1 if cr == MC.OD_FRAME_NEXT
                            else grid.mv)
                    carr[vy, vx] = (cx, cy)
                    cost = ((eval_blocks(blocks) << 5)
                            + lam * local_rate())
                    if cost < best_cost:
                        best_cost = cost
                        best_mv = (cx, cy)
                        best_r = cr
                        changed += 1
                grid.mv[vy, vx] = o_mv
                grid.mv1[vy, vx] = o_mv1
                grid.ref[vy, vx] = best_r
                carr = (grid.mv1 if best_r == MC.OD_FRAME_NEXT
                        else grid.mv)
                carr[vy, vx] = best_mv
                if best_mv != cur_mv or best_r != ref:
                    mark_dirty(vx, vy)
                continue
            best_sad = eval_blocks(blocks)
            best_mv = cur_mv
            for cand in cands:
                cx = int(np.clip(cand[0], -clamp, clamp))
                cy = int(np.clip(cand[1], -clamp, clamp))
                mvarr[vy, vx] = (cx, cy)
                sad = eval_blocks(blocks)
                # Require the prediction gain to clear the same RD bar
                # as subdivision (MV-delta bits), with a small bonus for
                # candidates copied from neighbors (cheaper to code and
                # they smooth the field).
                margin = lam
                if cand in neigh_cands:
                    margin = -(lam >> 1)
                if sad + margin < best_sad:
                    best_sad = sad
                    best_mv = (cx, cy)
                    changed += 1
            mvarr[vy, vx] = best_mv
            if best_mv != cur_mv:
                mark_dirty(vx, vy)
        if not changed:
            break


@devstats.span("refine_sweep")
def refine_sweep(grid, cur_luma, refs, info, lam, adapt, vis, frame_type,
                 iters, device, decimate=0, device_put_fn=None):
    """Device colour-sweep MV refinement (models/mesweep.py): the Jacobi
    re-posing of the greedy refine_mvs coordinate descent.  Same cost
    semantics per evaluation (FieldCache cell SADs, exact rate model via
    the native me_sweep_cands/me_sweep_rates helpers); only the update
    schedule differs, so streams stay valid.  Returns the number of
    accepted MV changes.  Raises when the native engine is missing (the
    JAX version returns 0 and skips the refinement).  A placement hook
    (`device_put_fn`) puts the sweep's planes on its first device, which
    must be `device` (models/mesweep.py SweepState).  Runs in the
    devstats span `refine_sweep`."""
    from daala_tpu_torch import native as native_mod
    from daala_tpu_torch.models import mesweep as MS
    lib = native_mod.get_lib()
    if lib is None:
        raise RuntimeError("refine_sweep needs the native engine "
                           "(me_sweep_cands / me_sweep_rates)")
    state = MS.SweepState(grid, info, cur_luma, _ref_slot_planes(refs, info),
                          vis, device, device_put_fn=device_put_fn)
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
