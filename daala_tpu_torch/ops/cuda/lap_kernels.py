"""The frame lapped pre/post filter: the CUDA kernel (csrc/lap_frame.cu)
and its plain PyTorch version.

Replaces lap_frame_pallas (daala_tpu/ops/pallas/lap_kernels.py:78): the
reversible 4-tap lifting (pre_filter4 / post_filter4) across the 4 rows
or columns straddling every superblock edge.  Forward does rows then
columns; inverse does columns then rows.

On the card the kernel is bound by bytes, not arithmetic: it copies the
plane once and lifts a few percent of its pixels, in one launch of
tiles held in shared memory with a halo that holds every band and
corner they touch.  See the note in csrc/lap_frame.cu and the launch
plan in csrc/frame_plan.cuh.

A tile of a sharded plane (parallel/sharding.py) is filtered in place
of the plane it came from: `origin` is the tensor's first row and
column in the plane and `plane` the plane's (H, W), and the filter
lifts exactly the plane's superblock edges whose whole 4-pixel band
lies in the tensor, at their places in it.  A tile cut on superblock
boundaries with a halo of 2 on each side that has a neighbour holds
every band that touches its interior, and its interior comes out as the
plane's filter gives it.  Without `origin` and `plane` the tensor is
the plane.

`lap_frame` launches the kernel for a tensor on a CUDA device and runs
the plain version only for a tensor on the CPU; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from daala_tpu_torch.ops import _lifting as L
from daala_tpu_torch.ops.cuda import _build
from daala_tpu_torch.utils import devstats

NAME = "lap_frame"
KERNELS = ("lap_frame_kernel",)  # the source's __global__ functions
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]


def filter_rows_at(c, row_starts, inv):
    """Apply the 4-point lapped filter vertically at each row start
    (vectorized across all boundaries and all columns)."""
    if not row_starts:
        return c
    fn = L.post_filter4 if inv else L.pre_filter4
    idx = (torch.tensor(row_starts, device=c.device)[:, None]
           + torch.arange(4, device=c.device)[None, :])
    band = c[idx]  # (nb, 4, W)
    out = torch.stack(fn([band[:, k, :] for k in range(4)]), dim=1)
    c = c.clone()
    c[idx] = out
    return c


def filter_cols_at(c, col_starts, inv):
    """Apply the 4-point lapped filter horizontally at each column start."""
    if not col_starts:
        return c
    fn = L.post_filter4 if inv else L.pre_filter4
    idx = (torch.tensor(col_starts, device=c.device)[:, None]
           + torch.arange(4, device=c.device)[None, :])
    band = c[:, idx]  # (H, nb, 4)
    out = torch.stack(fn([band[:, :, k] for k in range(4)]), dim=2)
    c = c.clone()
    c[:, idx] = out
    return c


def _starts(size, sb, origin=0, plane=None):
    """Band starts in a tensor of `size` rows (or columns) that begins at
    `origin` of a plane of `plane` (default: the tensor is the plane):
    the plane's edges k * sb, 1 <= k < plane // sb, whose whole band
    k * sb - 2 .. k * sb + 1 lies in the tensor."""
    plane = size if plane is None else plane
    return [k * sb - 2 - origin for k in range(1, plane // sb)
            if origin <= k * sb - 2 and k * sb + 2 <= origin + size]


def lap_frame_plain(frame, sb_x=64, sb_y=64, forward=True, origin=(0, 0),
                    plane=None):
    """The plain PyTorch version: what the kernel computes."""
    h, w = frame.shape
    ph, pw = (h, w) if plane is None else plane
    rows = _starts(h, sb_y, origin[0], ph)
    cols = _starts(w, sb_x, origin[1], pw)
    if forward:
        return filter_cols_at(filter_rows_at(frame, rows, False), cols,
                              False)
    return filter_rows_at(filter_cols_at(frame, cols, True), rows, True)


def _check(frame, sb_x, sb_y, origin, plane):
    if frame.dtype != torch.int32 or frame.dim() != 2:
        raise ValueError("lap_frame takes an (H, W) int32 tensor, got %s %s"
                         % (frame.dtype, tuple(frame.shape)))
    if not frame.is_contiguous():
        raise ValueError("lap_frame takes a contiguous tensor")
    if sb_x < 4 or sb_y < 4:
        raise ValueError("superblock sizes must be >= 4 (bands of 4 "
                         "may not overlap), got %d x %d" % (sb_x, sb_y))
    if origin[0] % 2 or origin[1] % 2:
        raise ValueError("lap_frame: a tile's origin must be even, got %s"
                         % (tuple(origin),))
    if plane is not None and min(plane) <= 0:
        raise ValueError("lap_frame: plane size %s" % (tuple(plane),))


def build():
    """Build (first use) and load csrc/lap_frame.cu; returns the library."""
    return _build.load(NAME, {NAME: _ARGTYPES})


def lap_frame_cuda(frame, sb_x=64, sb_y=64, forward=True, origin=(0, 0),
                   plane=None):
    """Launch csrc/lap_frame.cu on a CUDA tensor; returns a new tensor."""
    _check(frame, sb_x, sb_y, origin, plane)
    if frame.device.type != "cuda":
        raise ValueError("lap_frame_cuda takes a CUDA tensor")
    lib = build()
    h, w = frame.shape
    ph, pw = (h, w) if plane is None else plane
    out = torch.empty_like(frame)
    with torch.cuda.device(frame.device):
        stream = torch.cuda.current_stream(frame.device).cuda_stream
        err = lib.lap_frame(frame.data_ptr(), out.data_ptr(), h, w, sb_x,
                            sb_y, origin[0], origin[1], ph, pw,
                            1 if forward else 0, stream)
    devstats.launch(NAME)
    _build.check(err, NAME)
    return out


def lap_frame(frame, sb_x=64, sb_y=64, forward=True, origin=(0, 0),
              plane=None):
    """Frame lapped pre (forward) or post filter of an (H, W) int32
    plane, or of a tile of one (`origin`, `plane`: see the module
    docstring); sb_x/sb_y: superblock size per axis (64 >> xdec/ydec).
    The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if frame.device.type == "cuda":
        return lap_frame_cuda(frame, sb_x, sb_y, forward, origin, plane)
    if frame.device.type == "cpu":
        _check(frame, sb_x, sb_y, origin, plane)
        return lap_frame_plain(frame, sb_x, sb_y, forward, origin, plane)
    raise ValueError("lap_frame: unsupported device %s" % frame.device)


def lap_tile(frame, sb_x, sb_y, forward, tile=None):
    """lap_frame of a plane, or of a tile of one (parallel/sharding.py
    Tile; `frame` laid out as its data, halo included), whose interior
    it returns."""
    if tile is None:
        return lap_frame(frame, sb_x, sb_y, forward)
    return tile.crop(lap_frame(frame, sb_x, sb_y, forward, tile.origin,
                               tile.plane))
