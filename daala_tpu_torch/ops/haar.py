"""Reversible 2-D Haar transform (lossless / wavelet mode).

Mirrors od_haar / od_haar_inv (reference: src/dct.c:4822-4900) and the
shared OD_HAAR_KERNEL (reference: src/tf.h:34-45).  Vectorized: each level
processes all 2x2 groups of the active quadrant at once, and batches over
leading dimensions.

The port's copy of daala_tpu/ops/haar.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

import numpy as np


def haar_kernel(ll, lh, hl, hh):
    """OD_HAAR_KERNEL: in-place orthonormal Haar butterfly; returns the
    transformed (ll, lh, hl, hh)."""
    ll = ll + hl
    hh = hh - lh
    llmhh_2 = (ll - hh) >> 1
    lh = llmhh_2 - lh
    hl = llmhh_2 - hl
    ll = ll - lh
    hh = hh + hl
    return ll, lh, hl, hh


def haar2d(x):
    """Forward 2-D Haar of (..., n, n) int32 blocks (od_haar)."""
    n = x.shape[-1]
    ln = n.bit_length() - 1
    y = np.empty_like(x)
    tmp = np.array(x, copy=True)
    for level in range(ln):
        npairs = n >> level >> 1
        a = tmp[..., 0:2 * npairs:2, 0:2 * npairs:2]
        b = tmp[..., 1:2 * npairs:2, 0:2 * npairs:2]
        c = tmp[..., 0:2 * npairs:2, 1:2 * npairs:2]
        d = tmp[..., 1:2 * npairs:2, 1:2 * npairs:2]
        a, b, c, d = haar_kernel(a, b, c, d)
        tmp[..., :npairs, :npairs] = a
        y[..., :npairs, npairs:2 * npairs] = b
        y[..., npairs:2 * npairs, :npairs] = c
        y[..., npairs:2 * npairs, npairs:2 * npairs] = d
    y[..., 0, 0] = tmp[..., 0, 0]
    return y


def haar2d_inv(y):
    """Inverse 2-D Haar (od_haar_inv)."""
    n = y.shape[-1]
    ln = n.bit_length() - 1
    x = np.empty_like(y)
    x[..., 0, 0] = y[..., 0, 0]
    for level in range(ln - 1, -1, -1):
        npairs = 1 << (ln - 1 - level)
        a = np.array(x[..., :npairs, :npairs], copy=True)
        b = y[..., :npairs, npairs:2 * npairs]
        c = y[..., npairs:2 * npairs, :npairs]
        d = y[..., npairs:2 * npairs, npairs:2 * npairs]
        a, b, c, d = haar_kernel(a, b, c, d)
        x[..., 0:2 * npairs:2, 0:2 * npairs:2] = a
        x[..., 1:2 * npairs:2, 0:2 * npairs:2] = b
        x[..., 0:2 * npairs:2, 1:2 * npairs:2] = c
        x[..., 1:2 * npairs:2, 1:2 * npairs:2] = d
    return x
