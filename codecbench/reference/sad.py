"""The encoder's full-pel motion-search SAD fields, computed directly
from their definition in plain PyTorch.

For every offset (dy, dx) of the (2r + 1)^2 window, row-major, dy and
dx in [-r, r]: the absolute differences between the visible current
luma and the reference shifted by (dy, dx), summed over 8x8 cells (the
partial cells at the visible edge count only their visible pixels),
then over each level-0 vertex's window of 8 x 8 cells.  The cell grid
sits at (my, mx) of a zero grid of nvb x nhb windows, with
my = max(0, min(4, 8 nvb - cells down)) and mx likewise, so that every
window clipped to the frame is one whole block of that grid.

`dtype` is the type the sums accumulate in: int32 as the codec states
it, int16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sad_fields(cur, ref_padded, pad, vis, nvmvbs, nhmvbs, r, device="cpu",
               dtype=torch.int32):
    """(noff, nvb, nhb) SAD field of the visible current luma `cur`
    against one reference plane padded by `pad` pixels on every side."""
    vh, vw = vis
    ch, cw = -(-vh // 8), -(-vw // 8)
    nvb, nhb = nvmvbs // 8 + 1, nhmvbs // 8 + 1
    my = max(0, min(4, 8 * nvb - ch))
    mx = max(0, min(4, 8 * nhb - cw))
    cur_t = torch.from_numpy(np.ascontiguousarray(cur[:vh, :vw])).to(
        device).to(torch.int32)
    ref_t = torch.from_numpy(np.ascontiguousarray(
        ref_padded[pad - r:pad + r + vh, pad - r:pad + r + vw])).to(
        device).to(torch.int32)
    noffd = 2 * r + 1
    out = torch.zeros((noffd, noffd, 8 * nvb, 8 * nhb), dtype=dtype,
                      device=device)
    for dy in range(noffd):
        # (vh, noffd, vw): every dx of this dy.
        diff = (cur_t[:, None, :] - ref_t[dy:dy + vh].unfold(1, vw, 1)).abs()
        diff = F.pad(diff, (0, 8 * cw - vw, 0, 0, 0, 8 * ch - vh))
        cells = diff.reshape(ch, 8, noffd, cw, 8).sum((1, 4), dtype=dtype)
        out[dy, :, my:my + ch, mx:mx + cw] = cells.transpose(0, 1)
    return out.reshape(noffd * noffd, nvb, 8, nhb, 8).sum((2, 4), dtype=dtype)
