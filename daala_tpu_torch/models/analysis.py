"""Frame analysis and synthesis on torch tensors: the coefficient lift,
the frame and split lapped filters, the blockwise DCT of a frame, and
the uniform-quantizer pipeline built from them.

The counterpart of daala_tpu/models/analysis.py.  The frame filters go
through ops/cuda/lap_kernels.py and the frame DCTs through
ops/cuda/dct_kernels.py: the CUDA kernels for a tensor on a CUDA
device, their plain versions on the CPU.  The split filters
(`split_filter`, `split_unfilter`) were XLA in JAX, not Pallas, and stay
plain PyTorch on `_filter_rows_at` / `_filter_cols_at`: `lap_frame`
filters every multiple of its superblock, rows first, where they filter
the odd multiples of size/2 one level at a time, and row and column
filters that meet at a corner do not commute.  The block tiling lives in
ops/dct.py and is re-exported here, where the JAX package has it.

`analysis_transform`, `synthesis_transform` and `encode_step` take one
(H, W) frame: the lapped filters must not be run over a stack of frames,
which would filter across the seam between two of them.  Every integer
operation wraps as JAX's int32 does, and `encode_step`'s `sse` and `nz`
are int32 sums that wrap as JAX's do (x64 is off there).
"""

from __future__ import annotations

import torch

from daala_tpu_torch.ops.intrin import OD_COEFF_SHIFT
from daala_tpu_torch.ops.cuda.dct_kernels import dct_frame
from daala_tpu_torch.ops.cuda.lap_kernels import (
    filter_cols_at as _filter_cols_at, filter_rows_at as _filter_rows_at,
    lap_frame)
from daala_tpu_torch.ops.dct import blocks_of, unblocks

__all__ = ["OD_BSIZE_MAX", "lift_to_coeff", "coeff_to_u8",
           "prefilter_frame", "postfilter_frame", "split_filter",
           "split_unfilter", "blocks_of", "unblocks", "fdct_frame",
           "idct_frame", "analysis_transform", "synthesis_transform",
           "encode_step", "wrap32", "_filter_rows_at", "_filter_cols_at"]

OD_BSIZE_MAX = 64


def wrap32(v):
    """An integer tensor (or int) truncated to int32, as an int32 sum or a
    cast to int32 wraps it, computed in int64 (models/pvqsearch.py and
    models/restore.py wrap with it too)."""
    if isinstance(v, torch.Tensor):
        v = v.to(torch.int64)
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def lift_to_coeff(frame_u8):
    """(..., H, W) uint8 -> int32 coefficient domain."""
    return (frame_u8.to(torch.int32) - 128) << OD_COEFF_SHIFT


def coeff_to_u8(coeffs):
    """int32 coefficients -> uint8 pixels, rounded, with JAX's int32 wrap
    of the rounding offset."""
    v = wrap32(coeffs.to(torch.int64) + (1 << OD_COEFF_SHIFT >> 1))
    return torch.clamp((v >> OD_COEFF_SHIFT) + 128, 0, 255).to(torch.uint8)


def prefilter_frame(c, sb=OD_BSIZE_MAX):
    """Frame-level lapped prefilter at superblock boundaries
    (reference: src/filter.c:1529-1560): horizontal edges then vertical."""
    return lap_frame(c, sb_x=sb, sb_y=sb, forward=True)


def postfilter_frame(c, sb=OD_BSIZE_MAX):
    """The inverse of prefilter_frame: vertical edges then horizontal."""
    return lap_frame(c, sb_x=sb, sb_y=sb, forward=False)


def _edge_filter(filt, c, starts, dim, inv):
    """filt (`_filter_rows_at` or `_filter_cols_at`) at `starts` along
    `dim` of c with JAX's gather and scatter at the far edge: a band that
    runs past the plane reads its last row (or column) again and drops
    its writes beyond it.  A band that starts past the plane writes
    nothing; for the others the plane is extended by 3 copies of its
    last line and cut back."""
    size = c.shape[dim]
    starts = [s for s in starts if s < size]
    if not starts or max(starts) + 4 <= size:
        return filt(c, starts, inv)
    last = c.narrow(dim, size - 1, 1)
    ext = torch.cat([c, last.expand(*[3 if d == dim else n
                                      for d, n in enumerate(last.shape)])],
                    dim)
    return filt(ext, starts, inv).narrow(dim, 0, size).contiguous()


def _split_level(c, size, inv):
    """The lapped filters inside every block of `size` (at size/2 - 2 of
    each block): rows then columns, or for the inverse columns then rows."""
    half = size // 2
    h, w = c.shape[-2], c.shape[-1]
    rows = [y + half - 2 for y in range(0, h, size)]
    cols = [x + half - 2 for x in range(0, w, size)]
    if inv:
        c = _edge_filter(_filter_cols_at, c, cols, 1, True)
        return _edge_filter(_filter_rows_at, c, rows, 0, True)
    c = _edge_filter(_filter_rows_at, c, rows, 0, False)
    return _edge_filter(_filter_cols_at, c, cols, 1, False)


def split_filter(c, bs_from, bs_to):
    """Interior lapped filters for all split boundaries from superblock
    level down to blocks of size (4 << bs_to): equivalent to running
    od_prefilter_split over the whole frame for a uniform block-size map.
    Like JAX's, it starts at the superblock whatever `bs_from` says."""
    size = OD_BSIZE_MAX
    while size > (4 << bs_to):
        c = _split_level(c, size, inv=False)
        size //= 2
    return c


def split_unfilter(c, bs_to):
    """The inverse of split_filter(c, _, bs_to): the levels bottom up."""
    size = 8 << bs_to
    while size <= OD_BSIZE_MAX:
        c = _split_level(c, size, inv=True)
        size *= 2
    return c


def fdct_frame(c, bs):
    """Blockwise forward DCT of the whole (H, W) frame at uniform size
    4 << bs (the dct_frame kernel on a CUDA tensor)."""
    return dct_frame(c.contiguous(), 4 << bs, forward=True)


def idct_frame(d, bs):
    """Blockwise inverse DCT of the whole (H, W) frame at size 4 << bs."""
    return dct_frame(d.contiguous(), 4 << bs, forward=False)


def analysis_transform(frame_u8, bs=1):
    """Full forward analysis of one (H, W) uint8 frame: pixels -> lapped,
    transformed int32 coefficients at the uniform block size 4 << bs."""
    c = lift_to_coeff(frame_u8)
    c = prefilter_frame(c)
    c = split_filter(c, 4, bs)
    return fdct_frame(c, bs)


def synthesis_transform(coeffs, bs=1):
    """Inverse of analysis_transform: coefficients -> uint8 pixels."""
    c = idct_frame(coeffs, bs)
    c = split_unfilter(c, bs)
    c = postfilter_frame(c)
    return coeff_to_u8(c)


def encode_step(frame_u8, bs=1, quant=3840):
    """One device-side 'encode step' of one (H, W) uint8 frame: analysis,
    uniform rounding quantization of the coefficients, reconstruction,
    and distortion statistics.  Returns (rec uint8 (H, W), sse, nz), the
    last two 0-d int32 tensors on the frame's device: the squared error
    and the nonzero quantized coefficients, summed in int32 with JAX's
    wrap."""
    d = analysis_transform(frame_u8, bs=bs).to(torch.int64)
    q = int(wrap32(quant))
    h = q >> 1
    # JAX's int32 arithmetic, done in int64 and wrapped where it could
    # overflow; `//` is floor division in both frameworks.
    dq = torch.where(d >= 0, wrap32(d + h) // q, -(wrap32(-d + h) // q))
    dq = wrap32(dq)
    rec = synthesis_transform(wrap32(dq * q).to(torch.int32), bs=bs)
    err = rec.to(torch.int64) - frame_u8.to(torch.int64)
    sse = wrap32((err * err).sum()).to(torch.int32)
    nz = wrap32((dq != 0).sum()).to(torch.int32)
    return rec, sse, nz
