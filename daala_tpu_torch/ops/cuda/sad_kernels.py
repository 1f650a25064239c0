"""The full-pel SAD fields of a tile: the CUDA kernel (csrc/sad_fields.cu)
and its plain PyTorch version.

Replaces _fullpel_fields (daala_tpu/models/mefield.py:42), which JAX
computes in XLA, not Pallas.  For every offset (dy, dx) in [-r, r]^2
(row-major) and every level-0 vertex window, the sum of |cur - ref
shifted by (dy, dx)| over the window's visible pixels: the tile's 8x8
cells placed at (oy, ox) of a zero (8 nv, 8 nh) cell grid, whose (i, j)
8 x 8 block of cells is vertex (i, j)'s window (models/mefield.py says
how the tiles and their offsets are cut).

The plain version computes the (noff, ch, cw) cell sums, one dy at a
time with every dx at once, then sums them per window.  The kernel runs
one block an SM, each taking vertex windows in turn with a window's
pixels in shared memory (the next one's copy in flight), and writes only
the window sums, in one launch per tile and reference; it is bound by its
byte differences, not by HBM.  See the note in csrc/sad_fields.cu.

`sad_fields` launches the kernel for tensors on a CUDA device and runs
the plain version only for tensors on the CPU; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from daala_tpu_torch.ops.cuda import _build
from daala_tpu_torch.utils import devstats

NAME = "sad_fields"
KERNELS = ("sad_fields_kernel",)  # the source's __global__ functions
MAX_R = 64  # the widest search the kernel's shared memory holds
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

# Level-0 vertex spacing: 64 px = 8 cells of 8 px.
_CELL = 8
_WIN_CELLS = 8  # 64-px window = 8 cells


def _cell_sads(cur_vis, ref_win, r):
    """(noff, ch, cw) int32 8x8-cell SADs of cur_vis ((vh, vw) uint8)
    against ref_win ((vh + 2r, vw + 2r) uint8 starting at (-r, -r)) at
    every offset, row-major (dy, dx), dy, dx in [-r, r].

    The differences are int16 (a cell SAD is at most 64*255 < 2^15) and
    the cell sums exact integers."""
    vh, vw = cur_vis.shape
    ch = -(-vh // _CELL)
    cw = -(-vw // _CELL)
    # Pad once to cell-aligned int16 buffers; the visibility mask zeroes
    # the partial-cell overhang.
    py, px = ch * _CELL - vh, cw * _CELL - vw
    cur16 = F.pad(cur_vis.to(torch.int16), (0, px, 0, py))
    ref16 = F.pad(ref_win.to(torch.int16), (0, px, 0, py))
    mask = F.pad(torch.ones((vh, vw), dtype=torch.int16,
                            device=cur_vis.device), (0, px, 0, py))
    noffd = 2 * r + 1
    hh, ww = ch * _CELL, cw * _CELL
    cells = torch.empty((noffd, noffd, ch, cw), dtype=torch.int32,
                        device=cur_vis.device)
    for dy in range(noffd):
        # (hh, noffd, ww): every dx of this dy at once.
        ref = ref16[dy:dy + hh].unfold(1, ww, 1)
        d = (cur16[:, None, :] - ref).abs_().mul_(mask[:, None, :])
        cells[dy] = d.reshape(ch, _CELL, noffd, cw, _CELL) \
            .sum((1, 4), dtype=torch.int32).transpose(0, 1)
    return cells.view(noffd * noffd, ch, cw)


def _window_sums(cells, nv, nh, y0, x0):
    """(noff, nv, nh) sums of the windows of 8x8 cells: `cells` placed at
    (y0, x0) of a zero (nv * 8, nh * 8) cell grid, whose (i, j) block is
    vertex (i, j)'s window."""
    ch, cw = cells.shape[1:]
    hp, wp = nv * _WIN_CELLS, nh * _WIN_CELLS
    cp = torch.zeros((cells.shape[0], hp, wp), dtype=torch.int32,
                     device=cells.device)
    cp[:, y0:y0 + ch, x0:x0 + cw] = cells
    return cp.view(-1, nv, _WIN_CELLS, nh, _WIN_CELLS) \
        .sum((2, 4), dtype=torch.int32)


def sad_fields_plain(cur, ref, r, nv, nh, oy=0, ox=0):
    """The plain PyTorch version: what the kernel computes."""
    return _window_sums(_cell_sads(cur, ref, r), nv, nh, oy, ox)


def _check(cur, ref, r, nv, nh, oy, ox):
    if cur.dtype != torch.uint8 or cur.dim() != 2:
        raise ValueError("sad_fields takes an (vh, vw) uint8 current tile, "
                         "got %s %s" % (cur.dtype, tuple(cur.shape)))
    vh, vw = cur.shape
    if ref.dtype != torch.uint8 or tuple(ref.shape) != (vh + 2 * r,
                                                        vw + 2 * r):
        raise ValueError("sad_fields takes a (%d, %d) uint8 reference "
                         "window for r=%d, got %s %s"
                         % (vh + 2 * r, vw + 2 * r, r, ref.dtype,
                            tuple(ref.shape)))
    if ref.device != cur.device:
        raise ValueError("sad_fields: the reference is on %s, the current "
                         "tile on %s" % (ref.device, cur.device))
    if vh <= 0 or vw <= 0 or r < 0 or nv <= 0 or nh <= 0:
        raise ValueError("sad_fields: tile %dx%d, r=%d, %dx%d vertices"
                         % (vh, vw, r, nv, nh))
    if (oy < 0 or ox < 0 or oy + -(-vh // _CELL) > _WIN_CELLS * nv
            or ox + -(-vw // _CELL) > _WIN_CELLS * nh):
        raise ValueError("sad_fields: the tile's %dx%d cells at (%d, %d) "
                         "leave the %dx%d windows' grid"
                         % (-(-vh // _CELL), -(-vw // _CELL), oy, ox,
                            _WIN_CELLS * nv, _WIN_CELLS * nh))


def build():
    """Build (first use) and load csrc/sad_fields.cu; returns the library."""
    return _build.load(NAME, {NAME: _ARGTYPES})


def sad_fields_cuda(cur, ref, r, nv, nh, oy=0, ox=0):
    """Launch csrc/sad_fields.cu on CUDA tensors; returns the (noff, nv,
    nh) int32 fields."""
    _check(cur, ref, r, nv, nh, oy, ox)
    if cur.device.type != "cuda":
        raise ValueError("sad_fields_cuda takes CUDA tensors")
    if r > MAX_R:
        raise ValueError("sad_fields_cuda takes r <= %d, got %d"
                         % (MAX_R, r))
    cur, ref = cur.contiguous(), ref.contiguous()
    lib = build()
    vh, vw = cur.shape
    out = torch.empty(((2 * r + 1) ** 2, nv, nh), dtype=torch.int32,
                      device=cur.device)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        err = lib.sad_fields(cur.data_ptr(), ref.data_ptr(), out.data_ptr(),
                             vh, vw, r, nv, nh, oy, ox, stream)
    devstats.launch(NAME)
    _build.check(err, NAME)
    return out


def sad_fields(cur, ref, r, nv, nh, oy=0, ox=0):
    """The (noff, nv, nh) int32 full-pel SAD fields of a current tile cur
    ((vh, vw) uint8, its visible pixels) against ref ((vh + 2r, vw + 2r)
    uint8, the reference from (-r, -r) of the tile), its cells at (oy,
    ox) of the (8 nv, 8 nh) cell grid of the vertex windows.  The kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if cur.device.type == "cuda":
        return sad_fields_cuda(cur, ref, r, nv, nh, oy, ox)
    if cur.device.type == "cpu":
        _check(cur, ref, r, nv, nh, oy, ox)
        return sad_fields_plain(cur, ref, r, nv, nh, oy, ox)
    raise ValueError("sad_fields: unsupported device %s" % cur.device)
