"""The blockwise lifting DCT of a frame: the CUDA kernel
(csrc/dct_frame.cu) and its plain PyTorch version.

Replaces dct_frame_pallas (daala_tpu/ops/pallas/dct_kernels.py:83): the
n x n reversible integer lifting DCT, forward or inverse, of every tile
of an (H, W) int32 frame, n in {4, 8, 16, 32, 64}.  It computes exactly
unblocks(fdct2d(blocks_of(frame, n))) (daala_tpu/models/keyframe.py
:194, :288, :396).

On the card the kernel is bound by bytes at small n and by int32 lifting
operations at n = 64: a block does the whole 2-D transform of a strip
of tiles in shared memory, so the frame is read once and written once.
See the note in csrc/dct_frame.cu and the launch plan per shape in
csrc/frame_plan.cuh.  The CUDA wrapper takes frames whose base is
16-byte aligned (rows are, since w is a multiple of n >= 4).

`dct_frame` launches the kernel for a tensor on a CUDA device and runs
the plain version only for a tensor on the CPU; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from daala_tpu_torch.ops import dct
from daala_tpu_torch.ops.cuda import _build
from daala_tpu_torch.utils import devstats

NAME = "dct_frame"
# The source's __global__ functions (dct_tile_kernel: the shapes that keep
# the first design).
KERNELS = ("dct_frame_kernel", "dct_tile_kernel")
SIZES = (4, 8, 16, 32, 64)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def dct_frame_plain(frame, n, forward=True):
    """The plain PyTorch version: what the kernel computes."""
    h, w = frame.shape
    f = dct.fdct2d if forward else dct.idct2d
    return dct.unblocks(f(dct.blocks_of(frame, n)), h, w)


def _check(frame, n, origin=(0, 0)):
    if n not in SIZES:
        raise ValueError("dct_frame: n must be one of %s, got %r"
                         % (SIZES, n))
    if frame.dtype != torch.int32 or frame.dim() != 2:
        raise ValueError("dct_frame takes an (H, W) int32 tensor, got %s %s"
                         % (frame.dtype, tuple(frame.shape)))
    h, w = frame.shape
    if h % n or w % n:
        raise ValueError("dct_frame: %d x %d is not a multiple of n=%d"
                         % (h, w, n))
    if not frame.is_contiguous():
        raise ValueError("dct_frame takes a contiguous tensor")
    if origin[0] % n or origin[1] % n:
        raise ValueError("dct_frame: a tile at %s is off the n=%d grid"
                         % (tuple(origin), n))


def build():
    """Build (first use) and load csrc/dct_frame.cu; returns the library."""
    return _build.load(NAME, {NAME: _ARGTYPES})


def dct_frame_cuda(frame, n, forward=True, origin=(0, 0)):
    """Launch csrc/dct_frame.cu on a CUDA tensor; returns a new tensor."""
    _check(frame, n, origin)
    if frame.device.type != "cuda":
        raise ValueError("dct_frame_cuda takes a CUDA tensor")
    if frame.data_ptr() % 16:
        raise ValueError("dct_frame_cuda takes a frame whose base is 16-byte "
                         "aligned, got address %#x" % frame.data_ptr())
    lib = build()
    h, w = frame.shape
    out = torch.empty_like(frame)
    with torch.cuda.device(frame.device):
        stream = torch.cuda.current_stream(frame.device).cuda_stream
        err = lib.dct_frame(frame.data_ptr(), out.data_ptr(), h, w, n,
                            1 if forward else 0, stream)
    devstats.launch(NAME)
    _build.check(err, NAME)
    return out


def dct_frame(frame, n, forward=True, origin=(0, 0)):
    """Blockwise n x n forward or inverse DCT of an (H, W) int32 frame,
    or of the tile of one whose first row and column are `origin` in
    the frame (parallel/sharding.py): its blocks are the frame's when
    the origin lies on the n grid, and the call raises when it does not.
    The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if frame.device.type == "cuda":
        return dct_frame_cuda(frame, n, forward, origin)
    if frame.device.type == "cpu":
        _check(frame, n, origin)
        return dct_frame_plain(frame, n, forward)
    raise ValueError("dct_frame: unsupported device %s" % frame.device)
