"""Open-loop block-size decision (encoder side, non-normative).

Vectorized port of the variance/activity-masking splitter (reference:
src/block_size_enc.c): overlapping 4x4/8x8 variance pyramids, noise floors,
psy masking, and coding-gain comparisons decide 4x4/8x8/16x16/32x32 per
32x32 quadrant.  All the windowed sums are numpy slides, so this maps
directly onto the TPU as reductions over shifted views.

The port's copy of daala_tpu/codec/blocksize.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import numpy as np

OD_MAX_OVERLAP = 3
OD_MAX_OVERLAP_8 = 1
OD_SIZE2_SUMS = 16 + 2 * OD_MAX_OVERLAP      # 22
OD_SIZE4_SUMS = 15 + 2 * OD_MAX_OVERLAP      # 21
OD_SIZE8_SUMS = 7 + 2 * OD_MAX_OVERLAP_8     # 9

OD_CG4 = 15.943 / 6
OD_CG8 = 16.7836 / 6
OD_CG16 = 16.9986 / 6
OD_CG32 = 17.1 / 6
PSY8_FUDGE = 0.5

_OVERLAP4 = [1, 1, 2, 3]
_OVERLAP8 = [0, 0, 1, 1]


def _box2(a):
    """Sum of non-overlapping ... actually 2x2-strided sliding windows used
    by the stats; a is 2-D."""
    return a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]


def compute_stats(res):
    """od_compute_stats (reference: src/block_size_enc.c:57-131).
    res: (44, 44) int array (pixel residuals, top-left at -2*OVERLAP)."""
    r = res.astype(np.int64)
    # Sx2[i][j]: sums over the 2x2 block at (2i, 2j).
    Sx2 = _box2(r)[:OD_SIZE2_SUMS, :OD_SIZE2_SUMS]
    Sxx2 = _box2(r * r)[:OD_SIZE2_SUMS, :OD_SIZE2_SUMS]
    # Sx4: 2x2 sliding sums of Sx2.
    Sx4 = (Sx2[:-1, :-1] + Sx2[:-1, 1:] + Sx2[1:, :-1] + Sx2[1:, 1:])
    Sxx4 = (Sxx2[:-1, :-1] + Sxx2[:-1, 1:] + Sxx2[1:, :-1] + Sxx2[1:, 1:])
    off8 = OD_MAX_OVERLAP - 2 * OD_MAX_OVERLAP_8  # == 1
    idx = off8 + 2 * np.arange(OD_SIZE8_SUMS)
    Sx8 = (Sx4[np.ix_(idx, idx)] + Sx4[np.ix_(idx, idx + 2)]
           + Sx4[np.ix_(idx + 2, idx)] + Sx4[np.ix_(idx + 2, idx + 2)])
    Sxx8 = (Sxx4[np.ix_(idx, idx)] + Sxx4[np.ix_(idx, idx + 2)]
            + Sxx4[np.ix_(idx + 2, idx)] + Sxx4[np.ix_(idx + 2, idx + 2)])
    Var4 = (Sxx4 - (Sx4 * Sx4 >> 4)) >> 5
    var_floor4 = 4 + ((Sx4 + (128 << 4)) >> 8)
    Var4 = np.maximum(Var4, var_floor4)
    invVar4 = 16384 // Var4
    Var8 = (Sxx8 - (Sx8 * Sx8 >> 6)) >> 5
    var_floor8 = 4 + ((Sx8 + (128 << 6)) >> 8)
    Var8 = np.maximum(Var8, var_floor8)
    invVar8 = 16384 // Var8
    return {"Var4": Var4, "invVar4": invVar4, "Var8": Var8,
            "invVar8": invVar8}


def _noise_var4(stats, bsize, y, x):
    length = 2 * (1 << bsize) - 1
    ov = _OVERLAP4[bsize]
    count = length + 2 * ov
    w = stats["Var4"][OD_MAX_OVERLAP + y // 2 - ov:
                      OD_MAX_OVERLAP + y // 2 + length + ov,
                      OD_MAX_OVERLAP + x // 2 - ov:
                      OD_MAX_OVERLAP + x // 2 + length + ov]
    return int(w.sum()) // (count * count)


def _psy_var4(stats, bsize, y, x, noise):
    length = 2 * (1 << bsize) - 1
    ov = _OVERLAP4[bsize]
    count = length + 2 * ov
    w = stats["invVar4"][OD_MAX_OVERLAP + y // 2 - ov:
                         OD_MAX_OVERLAP + y // 2 + length + ov,
                         OD_MAX_OVERLAP + x // 2 - ov:
                         OD_MAX_OVERLAP + x // 2 + length + ov]
    psy = np.log2(1 + noise * w / 16384.0).sum()
    return max(psy / (count * count) - 1.0, 0.0)


def _noise_var8(stats, bsize, y, x):
    length = 2 * (1 << (bsize - 1)) - 1
    ov = _OVERLAP8[bsize]
    count = length + 2 * ov
    w = stats["Var8"][OD_MAX_OVERLAP_8 + y // 4 - ov:
                      OD_MAX_OVERLAP_8 + y // 4 + length + ov,
                      OD_MAX_OVERLAP_8 + x // 4 - ov:
                      OD_MAX_OVERLAP_8 + x // 4 + length + ov]
    return int(w.sum()) // (count * count)


def _psy_var8(stats, bsize, y, x, noise):
    length = 2 * (1 << (bsize - 1)) - 1
    ov = _OVERLAP8[bsize]
    count = length + 2 * ov
    w = stats["invVar8"][OD_MAX_OVERLAP_8 + y // 4 - ov:
                         OD_MAX_OVERLAP_8 + y // 4 + length + ov,
                         OD_MAX_OVERLAP_8 + x // 4 - ov:
                         OD_MAX_OVERLAP_8 + x // 4 + length + ov]
    psy = np.log2(1 + noise * w / 16384.0).sum()
    return max(psy / (count * count) - 1.0, 0.0)


def split_superblock32(img44, pred44, q):
    """Decide the block sizes of one 32x32 quadrant.

    img44: (44, 44) uint8 window starting 6 pixels above/left of the
    quadrant; pred44: same for the prediction (or None for intra).
    Returns a (4, 4) int array of per-8x8 decisions (0..3)."""
    psy_lambda = 6 * np.sqrt((1 << 4) / q) if q else 6.0
    res = img44.astype(np.int32) - 128
    cg4 = OD_CG4
    cg8 = OD_CG8
    psy_stats = compute_stats(res)
    if pred44 is None:
        img_stats = psy_stats
    else:
        cg4 -= 0.01 * max((q >> 4) - 40, 0)
        cg8 -= 0.005 * max((q >> 4) - 40, 0)
        res = np.clip(img44.astype(np.int32) - pred44.astype(np.int32),
                      -128, 127)
        img_stats = compute_stats(res)
    bsize = np.zeros((4, 4), np.int32)
    psy4 = np.zeros((8, 8))
    for i in range(8):
        for j in range(8):
            noise = _noise_var4(img_stats, 0, 4 * i, 4 * j)
            psy4[i, j] = _psy_var4(psy_stats, 0, 4 * i, 4 * j, noise)
    dec_gain8 = np.zeros((4, 4))
    for i in range(4):
        for j in range(4):
            noise = _noise_var4(img_stats, 1, 8 * i, 8 * j)
            psy8 = _psy_var4(psy_stats, 1, 8 * i, 8 * j, noise)
            psy4_avg = 0.25 * (psy4[2 * i, 2 * j] + psy4[2 * i, 2 * j + 1]
                               + psy4[2 * i + 1, 2 * j]
                               + psy4[2 * i + 1, 2 * j + 1])
            gain4 = cg4 - psy_lambda * psy4_avg
            gain8 = cg8 - psy_lambda * psy8
            if gain8 >= gain4:
                bsize[i, j] = 1
                dec_gain8[i, j] = gain8
            else:
                bsize[i, j] = 0
                dec_gain8[i, j] = gain4
    dec_gain16 = np.zeros((2, 2))
    for i in range(2):
        for j in range(2):
            noise = _noise_var4(img_stats, 2, 16 * i, 16 * j)
            psy16 = _psy_var4(psy_stats, 2, 16 * i, 16 * j, noise)
            noise8 = _noise_var8(img_stats, 2, 16 * i, 16 * j)
            psy16 = max(psy16, PSY8_FUDGE *
                        _psy_var8(psy_stats, 2, 16 * i, 16 * j, noise8))
            gain8_avg = 0.25 * (dec_gain8[2 * i, 2 * j]
                                + dec_gain8[2 * i, 2 * j + 1]
                                + dec_gain8[2 * i + 1, 2 * j]
                                + dec_gain8[2 * i + 1, 2 * j + 1])
            gain16 = OD_CG16 - psy_lambda * psy16
            if gain16 >= gain8_avg:
                bsize[2 * i:2 * i + 2, 2 * j:2 * j + 2] = 2
                dec_gain16[i, j] = gain16
            else:
                dec_gain16[i, j] = gain8_avg
    noise = _noise_var4(img_stats, 3, 0, 0)
    psy32 = _psy_var4(psy_stats, 3, 0, 0, noise)
    noise8 = _noise_var8(img_stats, 3, 0, 0)
    psy32 = max(psy32, PSY8_FUDGE * _psy_var8(psy_stats, 3, 0, 0, noise8))
    gain16_avg = 0.25 * dec_gain16.sum()
    gain32 = OD_CG32 - psy_lambda * psy32
    if gain32 >= gain16_avg:
        bsize[:, :] = 3
    return bsize


def split_superblocks(state, padded_luma, pred_luma, q):
    """Fill state.bsize from the open-loop splitter: each 64x64 superblock
    is decided as four 32x32 quadrants (the reference's splitter predates
    64x64 superblocks and only covers 32x32, reference:
    src/block_size_enc.c:330-460)."""
    from daala_tpu_torch import native as native_mod
    lib = native_mod.get_lib()
    if lib is not None:
        # Whole-frame native pass (bs_enc.inc); same statistics and
        # decision rules, ~100x the per-quadrant numpy loop below.
        luma = np.ascontiguousarray(padded_luma)
        pred = None if pred_luma is None \
            else np.ascontiguousarray(pred_luma)
        cfg = np.array([
            state.nvsb, state.nhsb, luma.shape[0], luma.shape[1],
            luma.ctypes.data, 0 if pred is None else pred.ctypes.data,
            int(q), state.bsize.ctypes.data,
            state.bsize.strides[0]], np.int64)
        lib.bs_split_superblocks(cfg.ctypes.data)
        return
    fh, fw = padded_luma.shape
    # Edge-extend by the 6-pixel analysis margin.
    m = 8
    ext = np.pad(padded_luma, m, mode="edge")
    extp = np.pad(pred_luma, m, mode="edge") if pred_luma is not None \
        else None
    for sby in range(state.nvsb):
        for sbx in range(state.nhsb):
            for qy in range(2):
                for qx in range(2):
                    y0 = sby * 64 + qy * 32
                    x0 = sbx * 64 + qx * 32
                    win = ext[m + y0 - 6:m + y0 + 38, m + x0 - 6:m + x0 + 38]
                    winp = None
                    if extp is not None:
                        winp = extp[m + y0 - 6:m + y0 + 38,
                                    m + x0 - 6:m + x0 + 38]
                    dec = split_superblock32(win, winp, q)
                    by = sby * 8 + qy * 4
                    bx = sbx * 8 + qx * 4
                    state.bsize[by:by + 4, bx:bx + 4] = dec
