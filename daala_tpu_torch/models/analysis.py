"""Frame analysis building blocks on torch tensors: the coefficient
lift, the frame lapped filters and the block tiling.

The counterpart of daala_tpu/models/analysis.py (:35-138).  The frame
filters go through ops/cuda/lap_kernels.py: the CUDA kernel for a
tensor on a CUDA device, the plain version (`_filter_rows_at` /
`_filter_cols_at`) on the CPU.  The block tiling lives in ops/dct.py
and is re-exported here, where the JAX package has it.  `encode_step`,
`analysis_transform` and `synthesis_transform`, the JAX package's
uniform-quantizer pipeline, are not part of the port (ROADMAP.md).
"""

from __future__ import annotations

import torch

from daala_tpu_torch.ops.intrin import OD_COEFF_SHIFT
from daala_tpu_torch.ops.cuda.lap_kernels import (
    filter_cols_at as _filter_cols_at, filter_rows_at as _filter_rows_at,
    lap_frame)
from daala_tpu_torch.ops.dct import blocks_of, unblocks

__all__ = ["OD_BSIZE_MAX", "lift_to_coeff", "prefilter_frame",
           "postfilter_frame", "blocks_of", "unblocks",
           "_filter_rows_at", "_filter_cols_at"]

OD_BSIZE_MAX = 64


def lift_to_coeff(frame_u8):
    """(..., H, W) uint8 -> int32 coefficient domain."""
    return (frame_u8.to(torch.int32) - 128) << OD_COEFF_SHIFT


def prefilter_frame(c, sb=OD_BSIZE_MAX):
    """Frame-level lapped prefilter at superblock boundaries
    (reference: src/filter.c:1529-1560): horizontal edges then vertical."""
    return lap_frame(c, sb_x=sb, sb_y=sb, forward=True)


def postfilter_frame(c, sb=OD_BSIZE_MAX):
    """The inverse of prefilter_frame: vertical edges then horizontal."""
    return lap_frame(c, sb_x=sb, sb_y=sb, forward=False)
