"""Lapped filter application: frame-level superblock boundaries and
split-level interior boundaries.

TPU-first layout: each boundary is a (4<<f)-lane band across the full
frame width/height, filtered with one vectorized application of the lifting
kernels from _lifting.py (reference loops one 4-tap column at a time:
src/filter.c:1459-1538 od_apply_prefilter_frame_sbs, :1128-1190
od_prefilter_split/od_postfilter_split).

The port's copy of daala_tpu/ops/filter.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

import numpy as np

from daala_tpu_torch.ops import _lifting as L

_PRE = {0: L.pre_filter4, 1: L.pre_filter8, 2: L.pre_filter16,
        3: L.pre_filter32}
_POST = {0: L.post_filter4, 1: L.post_filter8, 2: L.post_filter16,
         3: L.post_filter32}

OD_BSIZE_MAX = 64


def _filter_rows(c, y0, f, inv):
    """Filter vertically across a horizontal edge: rows y0..y0+(4<<f)-1,
    all columns (vectorized)."""
    n = 4 << f
    fn = _POST[f] if inv else _PRE[f]
    lanes = [c[y0 + k, :] for k in range(n)]
    out = fn(lanes)
    for k in range(n):
        c[y0 + k, :] = out[k]


def _filter_cols(c, x0, f, inv):
    """Filter horizontally across a vertical edge: cols x0..x0+(4<<f)-1,
    all rows (vectorized)."""
    n = 4 << f
    fn = _POST[f] if inv else _PRE[f]
    lanes = [c[:, x0 + k] for k in range(n)]
    out = fn(lanes)
    for k in range(n):
        c[:, x0 + k] = out[k]


def apply_prefilter_frame_sbs(c, nhsb, nvsb, xdec, ydec):
    """od_apply_prefilter_frame_sbs (reference: src/filter.c:1529-1560).

    c: 2-D int32 array (frame_height>>ydec, frame_width>>xdec), in place.
    Filter size f = 0 (4-point) at superblock boundaries."""
    f = 0
    sb = OD_BSIZE_MAX >> ydec
    for sby in range(1, nvsb):
        _filter_rows(c, sby * sb - (2 << f), f, inv=False)
    sb = OD_BSIZE_MAX >> xdec
    for sbx in range(1, nhsb):
        _filter_cols(c, sbx * sb - (2 << f), f, inv=False)


def apply_postfilter_frame_sbs(c, nhsb, nvsb, xdec, ydec):
    """od_apply_postfilter_frame_sbs (reference: src/filter.c:1561-1610).

    Inverse order: vertical-edge filters first, then horizontal."""
    f = 0
    sb = OD_BSIZE_MAX >> xdec
    for sbx in range(1, nhsb):
        _filter_cols(c, sbx * sb - (2 << f), f, inv=True)
    sb = OD_BSIZE_MAX >> ydec
    for sby in range(1, nvsb):
        _filter_rows(c, sby * sb - (2 << f), f, inv=True)


def prefilter_split(c, y0, x0, bs, f, hfilter, vfilter):
    """od_prefilter_split on the block at (y0, x0) of size 4<<bs
    (reference: src/filter.c:1459-1484).  Note the reference's naming:
    `hfilter` gates the filter across the horizontal midline (vertical
    filtering) and is derived from the picture width."""
    n = 4 << bs
    mid = 2 << bs
    if hfilter:
        sub = c[y0 + mid - (2 << f):y0 + mid + (2 << f), x0:x0 + n]
        _filter_rows(sub, 0, f, inv=False)
    if vfilter:
        sub = c[y0:y0 + n, x0 + mid - (2 << f):x0 + mid + (2 << f)]
        _filter_cols(sub, 0, f, inv=False)


def postfilter_split(c, y0, x0, bs, f, hfilter, vfilter):
    """od_postfilter_split (reference: src/filter.c:1486-1527), non-
    deblocking build: vfilter first, then hfilter."""
    n = 4 << bs
    mid = 2 << bs
    if vfilter:
        sub = c[y0:y0 + n, x0 + mid - (2 << f):x0 + mid + (2 << f)]
        _filter_cols(sub, 0, f, inv=True)
    if hfilter:
        sub = c[y0 + mid - (2 << f):y0 + mid + (2 << f), x0:x0 + n]
        _filter_rows(sub, 0, f, inv=True)
