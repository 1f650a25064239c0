"""Batched reversible integer DCTs (4..64 point) for TPU.

TPU-first layout: the reference transforms one block at a time
(reference: src/dct.c:152-163 od_bin_fdct4x4); here a whole batch of blocks
(..., n, n) is transformed at once.  The 1-D lifting chains from
daala_tpu/ops/_lifting.py are elementwise across the batch and across the
orthogonal axis, so each lifting step is one VPU op over every block of a
frame simultaneously.  Bit-exact with the reference (proven by
tests/test_lifting.py + tests/test_dct2d.py against a C oracle).

The 2-D transform follows the reference's composition exactly
(reference: src/dct.c:152-163): forward does columns then columns-of-the-
transpose; inverse mirrors it.

The port's copy of daala_tpu/ops/dct.py; tests/test_torch_copies.py
holds it to the original.  The copy's array namespace is numpy or torch
(`_xp`, `_stack`): the generated lifting networks run unchanged on torch
int32 tensors (elementwise ops that wrap like C's int32), which is the
plain version of the port's dct_frame kernel (ops/cuda/dct_kernels.py).
It loads the native engine at first use (`_native_dct2d`), not at
import, and adds `blocks_of`/`unblocks`, the frame tilings of the
device analysis.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from daala_tpu_torch.ops import _lifting as L

# Numeric sanitizer (analog of the reference's OD_DCT_CHECK_OVERFLOW
# compile-time instrumentation, reference: src/dct.c / configure
# --enable-dct-check-overflow): when DAALA_TPU_CHECK_OVERFLOW=1, every
# numpy 2-D transform is recomputed with int64 lanes and compared; a
# mismatch means an int32 lifting intermediate wrapped (out-of-headroom
# input).  Development aid; off by default.
_CHECK_OVERFLOW = os.environ.get("DAALA_TPU_CHECK_OVERFLOW", "0") == "1"

_FDCT_1D = {4: L.fdct4, 8: L.fdct8, 16: L.fdct16, 32: L.fdct32, 64: L.fdct64}
_IDCT_1D = {4: L.idct4, 8: L.idct8, 16: L.idct16, 32: L.idct32, 64: L.idct64}


def _native_dct2d(x, forward):
    """Single-call native transform for numpy batches (the host codec's
    per-block path); returns None when not applicable."""
    if not isinstance(x, np.ndarray):
        return None
    try:
        from daala_tpu_torch import native as _native
        lib = _native.get_lib()
    except Exception:  # pragma: no cover
        lib = None
    if lib is None:
        return None
    n = x.shape[-1]
    if n not in (4, 8, 16, 32, 64) or x.shape[-2] != n:
        return None
    blk = np.ascontiguousarray(x, np.int32)
    if blk is x or blk.base is x:
        blk = blk.copy()  # preserve value semantics (callers keep x)
    flat = blk.reshape(-1, n, n)
    lib.ec_dct2d_batch(flat.ctypes.data, flat.shape[0], n,
                         1 if forward else 0)
    return blk.reshape(x.shape)


def _xp(a):
    """Return the array namespace (numpy or torch) for a."""
    return np if isinstance(a, np.ndarray) else torch


def _stack(lanes, axis):
    if isinstance(lanes[0], np.ndarray):
        return np.stack(lanes, axis=axis)
    return torch.stack(lanes, dim=axis)


def _overflow_check(x, forward):
    """Recompute the transform with int64 lanes; any difference from the
    int32 result means an intermediate wrapped (DAALA_TPU_CHECK_OVERFLOW
    sanitizer; analog of OD_DCT_CHECK_OVERFLOW)."""
    n = x.shape[-1]
    f = (_FDCT_1D if forward else _IDCT_1D)[n]
    stack_axis = -1 if forward else -2
    lane_axis = (lambda v, k: v[..., k, :]) if forward \
        else (lambda v, k: v[..., :, k])

    def pass_T(v):
        out = f([lane_axis(v, k) for k in range(n)])
        return np.stack(out, axis=stack_axis)

    r32 = pass_T(pass_T(x.astype(np.int32)))
    r64 = pass_T(pass_T(x.astype(np.int64)))
    if not np.array_equal(r32, r64.astype(np.int64)):
        raise OverflowError(
            "DCT int32 lifting overflow detected (n=%d, %s)"
            % (n, "fdct" if forward else "idct"))


def fdct2d(x):
    """Forward 2-D DCT of a batch of blocks: (..., n, n) int32 -> same shape.

    Mirrors od_bin_fdct{n}x{n} (reference: src/dct.c:152-157): the first pass
    transforms columns writing transposed, the second pass does the same, so
    the result lands back in natural orientation.
    """
    if _CHECK_OVERFLOW and isinstance(x, np.ndarray):
        _overflow_check(x, True)
    r = _native_dct2d(x, True)
    if r is not None:
        return r
    n = x.shape[-1]
    f = _FDCT_1D[n]

    def cols_T(v):
        # z[..., i, j] = fdct(v[..., :, i])[j]
        lanes = [v[..., k, :] for k in range(n)]
        out = f(lanes)
        return _stack(out, axis=-1)

    return cols_T(cols_T(x))


def idct2d(y):
    """Inverse 2-D DCT: (..., n, n) int32 -> same shape.

    Mirrors od_bin_idct{n}x{n} (reference: src/dct.c:159-163).
    """
    if _CHECK_OVERFLOW and isinstance(y, np.ndarray):
        _overflow_check(y, False)
    r = _native_dct2d(y, False)
    if r is not None:
        return r
    n = y.shape[-1]
    f = _IDCT_1D[n]

    def rows_T(v):
        # z[..., j, i] = idct(v[..., i, :])[j]
        lanes = [v[..., :, k] for k in range(n)]
        out = f(lanes)
        return _stack(out, axis=-2)

    return rows_T(rows_T(y))


def fdct1d(x, axis=-1):
    """1-D forward DCT along the given axis of a batched tensor."""
    xp = _xp(x)
    n = x.shape[axis]
    xm = xp.moveaxis(x, axis, -1)
    lanes = [xm[..., k] for k in range(n)]
    res = _stack(_FDCT_1D[n](lanes), axis=-1)
    return xp.moveaxis(res, -1, axis)


def idct1d(y, axis=-1):
    """1-D inverse DCT along the given axis of a batched tensor."""
    xp = _xp(y)
    n = y.shape[axis]
    ym = xp.moveaxis(y, axis, -1)
    lanes = [ym[..., k] for k in range(n)]
    res = _stack(_IDCT_1D[n](lanes), axis=-1)
    return xp.moveaxis(res, -1, axis)


def blocks_of(c, n):
    """(H, W) -> (H//n * W//n, n, n) block tensor."""
    h, w = c.shape
    return (c.reshape(h // n, n, w // n, n)
             .permute(0, 2, 1, 3)
             .reshape(-1, n, n))


def unblocks(blocks, h, w):
    """(H//n * W//n, n, n) -> (H, W), the inverse of blocks_of."""
    n = blocks.shape[-1]
    return (blocks.reshape(h // n, w // n, n, n)
                  .permute(0, 2, 1, 3)
                  .reshape(h, w))
