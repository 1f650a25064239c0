"""Frequency-domain intra prediction helpers.

od_hv_intra_pred: keyframe luma copies the first row/col of coefficients
from the same-size top/left neighbors, with an energy gate on the lowest
three coefficients (reference: src/intra.c:37-61).

od_resample_luma_coeffs: Chroma-from-Luma predictor resampling
(reference: src/intra.c:72-110) using TF up-conversion (reference:
src/tf.c:36-110).

The port's copy of daala_tpu/ops/intra.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

import numpy as np

from daala_tpu_torch.ops import _tables as T
from daala_tpu_torch.ops.intrin import dct_rshift


def hv_intra_pred(pred, d, w, bx, by, bsize4, bs):
    """pred: (n, n) int array to fill (already zeroed); d: flat coeff plane
    of width w; bsize4: function(bx4, by4) -> block size at 4x4 coords."""
    n = 1 << (bs + 2)
    top = by > 0 and bsize4(bx, by - 1) == bs
    left = bx > 0 and bsize4(bx - 1, by) == bs
    tb = (by << 2) * w + (bx << 2)
    g1 = 0.0
    g2 = 0.0
    if top:
        for i in range(1, 4):
            v = float(d[tb - n * w + i])
            g1 += v * v
    if left:
        for i in range(1, 4):
            v = float(d[tb - n + i * w])
            g2 += v * v
    if top:
        for i in range(4, n):
            pred[i] = d[tb - n * w + i]
    if left:
        for i in range(4, n):
            pred[i * n] = d[tb - n + i * w]
    if g1 > g2:
        if top:
            for i in range(1, 4):
                pred[i] = d[tb - n * w + i]
    else:
        if left:
            for i in range(1, 4):
                pred[i * n] = d[tb - n + i * w]


def tf_up_hv_lp(src, dx, dy, n):
    """od_tf_up_hv_lp (reference: src/tf.c:80-110): src flat-indexable 2-D
    (at least (n//2+dy, n//2+dx)); returns (n, n) upsampled LF block."""
    from daala_tpu_torch.ops.haar import haar_kernel
    dst = np.zeros((n, n), src.dtype)
    for y in range(n >> 1):
        vswap = y & 1
        for x in range(n >> 1):
            ll = int(src[y, x])
            lh = int(src[y, x + dx])
            hl = int(src[y + dy, x])
            hh = int(src[y + dy, x + dx])
            # lh and hl are swapped for od_tf_up_hv compatibility.
            ll, hl, lh, hh = haar_kernel(ll, hl, lh, hh)
            hswap = x & 1
            dst[2 * y + vswap, 2 * x + hswap] = ll
            dst[2 * y + vswap, 2 * x + 1 - hswap] = lh
            dst[2 * y + 1 - vswap, 2 * x + hswap] = hl
            dst[2 * y + 1 - vswap, 2 * x + 1 - hswap] = hh
    return dst


def resample_luma_coeffs(decoded_luma, xdec, ydec, bs, chroma_bs, n):
    """od_resample_luma_coeffs: build the (n, n) CfL chroma predictor from
    the decoded luma block (reference: src/intra.c:72-110).

    decoded_luma: 2-D array view of at least (n + pad) with the luma block
    at origin; for the chroma_bs==0 4:2:0 case it must cover (n, n) * 2."""
    if chroma_bs == 0 and (xdec or ydec):
        assert xdec and ydec, "4:2:2 not yet supported"
        pred = tf_up_hv_lp(decoded_luma, n, n, n)
        for i in range(4):
            for j in range(4):
                pred[i, j] = (int(T.CFL_SCALING4[j][i]) * int(pred[i, j])
                              + 64) >> 7
        return pred
    # Chroma transform smaller than luma: copy upper-left quarter coeffs.
    return np.array(decoded_luma[:n, :n], copy=True)
