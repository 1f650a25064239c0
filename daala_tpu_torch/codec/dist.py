"""Activity-weighted frequency-domain distortion for encoder RDO.

Behavioral port of od_compute_dist / od_compute_dist_8x8 /
od_compute_var_4x4 (reference: src/encode.c:1082-1228): the error signal
is low-passed with a separable [1, mid, 1] filter (mid=5, reflected
edges doubled), summed per 8x8 block, combined with a variance-matching
term, and scaled by a perceptual activity factor derived from 4x4
variances of the *source*.  Non-normative (encoder decisions only), so
this is plain vectorized numpy with no bit-exactness requirement.

The port's copy of daala_tpu/codec/dist.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

import math

import numpy as np

OD_DIST_LP_MID = 5
OD_DIST_LP_NORM = OD_DIST_LP_MID + 2
_COEFF_SHIFT = 4


def _var_4x4_grid(x):
    """od_compute_var_4x4 at the 9 overlapping (stride-2) positions of
    each 8x8 block: x is (nby, nbx, 8, 8); returns (nby, nbx, 3, 3).

    Each 4x4 window at a stride-2 offset is the sum of a 2x2 patch of
    2x2-aggregated cells — exact integer decomposition, no cumsums."""
    t = (x >> 2).astype(np.int64)
    t2 = t * t
    # 2x2 cell aggregation -> (..., 4, 4)
    c = t.reshape(t.shape[:-2] + (4, 2, 4, 2)).sum(axis=(-3, -1))
    c2 = t2.reshape(t.shape[:-2] + (4, 2, 4, 2)).sum(axis=(-3, -1))
    s = (c[..., :3, :3] + c[..., 1:, :3]
         + c[..., :3, 1:] + c[..., 1:, 1:])
    s2 = (c2[..., :3, :3] + c2[..., 1:, :3]
          + c2[..., :3, 1:] + c2[..., 1:, 1:])
    return s2 - (s * s >> 4)


def _lp_filter(e, n):
    """Separable [1, mid, 1] low-pass with doubled reflected edges
    (reference: src/encode.c:1183-1210)."""
    mid = OD_DIST_LP_MID
    tmp = np.empty_like(e, dtype=np.float64)
    tmp[:, 1:n - 1] = mid * e[:, 1:n - 1] + e[:, :n - 2] + e[:, 2:]
    tmp[:, 0] = mid * e[:, 0] + 2 * e[:, 1]
    tmp[:, n - 1] = mid * e[:, n - 1] + 2 * e[:, n - 2]
    out = np.empty_like(tmp)
    out[1:n - 1, :] = mid * tmp[1:n - 1, :] + tmp[:n - 2, :] + tmp[2:, :]
    out[0, :] = mid * tmp[0, :] + 2 * tmp[1, :]
    out[n - 1, :] = mid * tmp[n - 1, :] + 2 * tmp[n - 2, :]
    return out


def compute_dist(x, y, n, use_activity_masking, coded_quantizer,
                 flat_qm=False):
    """od_compute_dist (reference: src/encode.c:1170-1228).

    x, y: (n, n) int32 source / reconstruction (lapped domain)."""
    x = np.asarray(x, np.int32)[:n, :n]
    y = np.asarray(y, np.int32)[:n, :n]
    if flat_qm:
        d = (x - y).astype(np.float64)
        return float(np.sum(d * d))
    e = (x - y).astype(np.int64)
    e_lp = _lp_filter(e, n)
    # Per-8x8 processing (reference: od_compute_dist_8x8).
    nb = n // 8
    xb = x.reshape(nb, 8, nb, 8).transpose(0, 2, 1, 3)
    yb = y.reshape(nb, 8, nb, 8).transpose(0, 2, 1, 3)
    eb = e_lp.reshape(nb, 8, nb, 8).transpose(0, 2, 1, 3)
    varx = _var_4x4_grid(xb).astype(np.float64)
    vary = _var_4x4_grid(yb).astype(np.float64)
    vardist = np.sum(varx - 2 * np.sqrt(varx * vary) + vary, axis=(-2, -1))
    if use_activity_masking:
        calibration = 1.95
        var_stat = 9.0 / np.sum(1.0 / (1 + varx), axis=(-2, -1))
    else:
        calibration = 1.62
        var_stat = np.min(varx, axis=(-2, -1))
    # libm pow per element, NOT numpy's vectorized ** — numpy 2.x uses a
    # SIMD pow that differs from libm by 1 ulp on some inputs, which
    # would break bit-parity with the native engine (and the reference C,
    # which also calls libm pow: src/encode.c:1144).
    base = 0.25 + var_stat / (1 << 2 * _COEFF_SHIFT)
    activity = calibration * np.array(
        [math.pow(b, -1.0 / 6) for b in base.ravel()],
        dtype=np.float64).reshape(base.shape)
    lp_sum = np.sum(eb * eb, axis=(-2, -1)) * \
        (0.92 / float(OD_DIST_LP_NORM) ** 4)
    total = float(np.sum(activity * activity * (lp_sum + vardist)))
    # QM compensation interpolated on the coded quantizer
    # (reference: src/encode.c:1221-1226).
    if coded_quantizer >= 47:
        total *= 1.2
    elif coded_quantizer <= 36:
        total *= 1.7
    else:
        total *= 1.7 + (1.2 - 1.7) * (coded_quantizer - 36) / (47 - 36)
    return total
