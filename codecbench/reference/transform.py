"""The codec's integer transforms in plain PyTorch: the blockwise 2-D
DCTs of every size and the frame lapped filter at superblock edges.

A frozen copy of the plain versions in the port's ops/dct.py and
ops/cuda/{dct,lap}_kernels.py (the code the port's CUDA kernels equal
bit for bit), without their kernel dispatch.  Every operation is
elementwise lifting on the tensor's own dtype, so a tensor of int16
computes the same network in int16 (the control of codecbench/check.py).
"""

from __future__ import annotations

import torch

from codecbench.reference import lifting as L

_FDCT_1D = {4: L.fdct4, 8: L.fdct8, 16: L.fdct16, 32: L.fdct32, 64: L.fdct64}
_IDCT_1D = {4: L.idct4, 8: L.idct8, 16: L.idct16, 32: L.idct32, 64: L.idct64}


def blocks_of(c, n):
    """(H, W) -> (H//n * W//n, n, n) block tensor."""
    h, w = c.shape
    return (c.reshape(h // n, n, w // n, n).permute(0, 2, 1, 3)
            .reshape(-1, n, n))


def unblocks(blocks, h, w):
    """(H//n * W//n, n, n) -> (H, W), the inverse of blocks_of."""
    n = blocks.shape[-1]
    return (blocks.reshape(h // n, w // n, n, n).permute(0, 2, 1, 3)
            .reshape(h, w))


def fdct2d(x):
    """Forward 2-D DCT of (..., n, n) blocks: two passes over columns,
    each writing transposed (od_bin_fdct{n}x{n})."""
    f = _FDCT_1D[x.shape[-1]]

    def cols_t(v):
        return torch.stack(f([v[..., k, :] for k in range(v.shape[-1])]),
                           dim=-1)
    return cols_t(cols_t(x))


def idct2d(y):
    """Inverse 2-D DCT of (..., n, n) blocks (od_bin_idct{n}x{n})."""
    f = _IDCT_1D[y.shape[-1]]

    def rows_t(v):
        return torch.stack(f([v[..., :, k] for k in range(v.shape[-1])]),
                           dim=-2)
    return rows_t(rows_t(y))


def dct_frame(frame, n, forward=True):
    """The n-point blockwise 2-D DCT (or its inverse) of a whole plane."""
    h, w = frame.shape
    f = fdct2d if forward else idct2d
    return unblocks(f(blocks_of(frame, n)), h, w)


def _filter_rows_at(c, row_starts, inv):
    if not row_starts:
        return c
    fn = L.post_filter4 if inv else L.pre_filter4
    idx = (torch.tensor(row_starts, device=c.device)[:, None]
           + torch.arange(4, device=c.device)[None, :])
    band = c[idx]
    c = c.clone()
    c[idx] = torch.stack(fn([band[:, k, :] for k in range(4)]), dim=1)
    return c


def _filter_cols_at(c, col_starts, inv):
    if not col_starts:
        return c
    fn = L.post_filter4 if inv else L.pre_filter4
    idx = (torch.tensor(col_starts, device=c.device)[:, None]
           + torch.arange(4, device=c.device)[None, :])
    band = c[:, idx]
    c = c.clone()
    c[:, idx] = torch.stack(fn([band[:, :, k] for k in range(4)]), dim=2)
    return c


def lap_frame(frame, sb_x, sb_y, forward=True):
    """The 4-point lapped filter across every inner superblock edge of a
    plane: rows then columns forward, columns then rows inverse."""
    h, w = frame.shape
    rows = [k * sb_y - 2 for k in range(1, h // sb_y)]
    cols = [k * sb_x - 2 for k in range(1, w // sb_x)]
    if forward:
        return _filter_cols_at(_filter_rows_at(frame, rows, False), cols,
                               False)
    return _filter_rows_at(_filter_cols_at(frame, cols, True), rows, True)
