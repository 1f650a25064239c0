"""obmc_leaf_cells (csrc/obmc_leaf.cu): the colour sweep's OBMC leaves
and their 8x8-cell SADs."""

import numpy as np

WRAPPER = ("daala_tpu_torch.ops.cuda.obmc_kernels", "obmc_leaf_cells_cuda")


def work(args):
    """Counted once the window has closed (the leaves' arguments are on
    the card).  Bytes: the 64-byte leaf arguments, the visible current
    pixels of the leaves (which do not overlap within a call) and the
    cell sums written; the reference windows, whose union would have to
    be counted per call, are left out, so the byte side of the bound is
    a lower one.  Operations, on int32 lanes: per leaf and corner every
    horizontal sample's 6 8-bit multiply-adds (a quarter each, dp4a),
    its offset and int16 wrap (3.5 in all) and every pixel's 6 vertical
    16-bit multiply-adds (a half each, dp2a) with the rounding, shift
    and 2 clips (7); per pixel 9 for the blend and, where visible, 3 for
    the difference, magnitude and sum."""
    cur_shape = tuple(args[1].shape)
    scal, log_n = args[2], args[3]

    def later():
        s = scal.cpu().numpy().astype(np.int64)
        n, L = 1 << log_n, s.shape[0]
        vis = int((np.clip(cur_shape[0] - s[:, 13], 0, n)
                   * np.clip(cur_shape[1] - s[:, 14], 0, n)).sum())
        nbytes = 64 * L + vis + L * (n >> 3) * (n >> 3) * 4
        ops = L * (4 * (3.5 * (n + 5) * n + 7 * n * n) + 9 * n * n) + 3 * vis
        return nbytes, {"int32": int(ops)}
    return later
