"""The frame lapped pre/post filter: the CUDA kernel (csrc/lap_frame.cu)
and its plain PyTorch version.

Replaces lap_frame_pallas (daala_tpu/ops/pallas/lap_kernels.py:78): the
reversible 4-tap lifting (pre_filter4 / post_filter4) across the 4 rows
or columns straddling every superblock edge.  Forward does rows then
columns; inverse does columns then rows.

On the card the kernel is bound by bytes and launch cost, not
arithmetic: it copies the plane once and lifts a few percent of its
pixels, in two launches (the second pass reads the corners the first
wrote).  See the note in csrc/lap_frame.cu.

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
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def _starts(size, sb):
    return [k * sb - 2 for k in range(1, size // sb)]


def lap_frame_plain(frame, sb_x=64, sb_y=64, forward=True):
    """The plain PyTorch version: what the kernel computes."""
    h, w = frame.shape
    rows, cols = _starts(h, sb_y), _starts(w, sb_x)
    if forward:
        return filter_cols_at(filter_rows_at(frame, rows, False), cols,
                              False)
    return filter_rows_at(filter_cols_at(frame, cols, True), rows, True)


def _check(frame, sb_x, sb_y):
    if frame.dtype != torch.int32 or frame.dim() != 2:
        raise ValueError("lap_frame takes an (H, W) int32 tensor, got %s %s"
                         % (frame.dtype, tuple(frame.shape)))
    if not frame.is_contiguous():
        raise ValueError("lap_frame takes a contiguous tensor")
    if sb_x < 4 or sb_y < 4:
        raise ValueError("superblock sizes must be >= 4 (bands of 4 "
                         "may not overlap), got %d x %d" % (sb_x, sb_y))


def build():
    """Build (first use) and load csrc/lap_frame.cu; returns the library."""
    return _build.load(NAME, {NAME: _ARGTYPES})


def lap_frame_cuda(frame, sb_x=64, sb_y=64, forward=True):
    """Launch csrc/lap_frame.cu on a CUDA tensor; returns a new tensor."""
    _check(frame, sb_x, sb_y)
    if frame.device.type != "cuda":
        raise ValueError("lap_frame_cuda takes a CUDA tensor")
    lib = build()
    h, w = frame.shape
    out = torch.empty_like(frame)
    with torch.cuda.device(frame.device):
        stream = torch.cuda.current_stream(frame.device).cuda_stream
        err = lib.lap_frame(frame.data_ptr(), out.data_ptr(), h, w, sb_x,
                            sb_y, 1 if forward else 0, stream)
    devstats.launch(NAME)
    _build.check(err, NAME)
    return out


def lap_frame(frame, sb_x=64, sb_y=64, forward=True):
    """Frame lapped pre (forward) or post filter of an (H, W) int32
    plane; sb_x/sb_y: superblock size per axis (64 >> xdec/ydec).  The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if frame.device.type == "cuda":
        return lap_frame_cuda(frame, sb_x, sb_y, forward)
    if frame.device.type == "cpu":
        _check(frame, sb_x, sb_y)
        return lap_frame_plain(frame, sb_x, sb_y, forward)
    raise ValueError("lap_frame: unsupported device %s" % frame.device)
