"""Zigzag scan-order generation from measured coefficient statistics.

Re-implements the reference's gen_zigzag{4,8,16,32,64}.m Octave
scripts (reference: tools/gen_zigzag8.m:1-36): the block is split into
the PVQ band layout (the upper-left quadrant is delegated to the next
smaller scan, then the horizontal band, the vertical band, and the
remainder), and each band is ordered by descending measured coefficient
magnitude.  The shipped `ZIGZAG*` tables in `daala_tpu_torch.ops._tables`
were produced this way from corpus statistics; `measure_mags` collects
the same statistics with this framework's own lapped transform
(`daala_tpu_torch.models.analysis`: the lap_frame and dct_frame CUDA
kernels on the card), so scans can be retuned for new content classes.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.device import resolve
from daala_tpu_torch.utils import devstats


def band_masks(n: int):
    """The three scan bands of an n x n block (n >= 8): horizontal
    (rows < n/4, cols >= n/2), vertical (rows >= n/2, cols < n/4), and
    the remainder outside the delegated n/2 x n/2 upper-left quadrant
    (reference: tools/gen_zigzag8.m:5-10).  For n == 4 there is a
    single band covering everything but DC
    (reference: tools/gen_zigzag4.m:5-9)."""
    if n == 4:
        b = np.ones((n, n), np.int32)
        b[0, 0] = 0
        return [b == 1]
    b = np.full((n, n), 3, np.int32)
    b[:n // 2, :n // 2] = 0
    b[:n // 4, n // 2:] = 1
    b[n // 2:, :n // 4] = 2
    return [b == 1, b == 2, b == 3]


def gen_zigzag(mags: np.ndarray) -> np.ndarray:
    """(entries, 2) array of (x, y) pairs: each band's coefficients in
    descending magnitude order, ties broken by row-major index (the
    Octave scripts' stable sort of -x)."""
    mags = np.asarray(mags, np.float64)
    n = mags.shape[0]
    assert mags.shape == (n, n)
    flat = mags.reshape(-1)
    order = []
    for mask in band_masks(n):
        idx = np.flatnonzero(mask.reshape(-1))
        sel = idx[np.argsort(-flat[idx], kind="stable")]
        order.extend(sel.tolist())
    order = np.asarray(order)
    return np.stack([order % n, order // n], axis=1).astype(np.int32)


def measure_mags(frames, n: int, device="cuda") -> np.ndarray:
    """Mean |coefficient| per (row, col) of n x n lapped-DCT blocks
    over `frames` (list of 2-D uint8/int arrays), using the codec's own
    analysis transform on `device` (one lap_frame and one dct_frame
    launch per frame on a card).

    Each frame is cropped to multiples of 64 and uploaded once; the
    (n, n) sum of |d| over its blocks is reduced on the device in
    float64 and only that comes back, to be divided on the host.  The
    coefficients are int32, so every sum is an exact integer in float64
    and the mean the same number as the JAX package's, which fetches
    the whole plane."""
    from daala_tpu_torch.models import analysis as A
    dev = resolve(device)
    bs = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[n]
    acc = np.zeros((n, n), np.float64)
    cnt = 0
    for f in frames:
        f = np.asarray(f)
        h = f.shape[0] // 64 * 64
        w = f.shape[1] // 64 * 64
        if not h or not w:
            raise ValueError("frames must be at least 64x64")
        c = A.lift_to_coeff(devstats.upload(f[:h, :w], dev))
        c = A.prefilter_frame(c)
        c = A.split_filter(c, 4, bs)
        d = A.fdct_frame(c, bs)
        blocks = d.abs().to(torch.float64).reshape(h // n, n, w // n, n)
        # The exact sum on the device, the division on the host, as
        # numpy's mean does (CUDA divides by a host scalar through its
        # reciprocal).
        acc += devstats.fetch(blocks.sum(dim=(0, 2)), None) / (
            h // n * (w // n))
        cnt += 1
    return acc / max(cnt, 1)


def read_luma(path):
    """The luma planes of every frame of the y4m file at `path`."""
    from daala_tpu_torch.utils.y4m import Y4MReader
    reader = Y4MReader(path)
    try:
        return [planes[0] for planes in reader]
    finally:
        reader.close()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", type=int, choices=[4, 8, 16, 32, 64])
    ap.add_argument("--clip", help="y4m file to measure statistics on")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the analysis (default: cuda)")
    args = ap.parse_args(argv)
    if args.clip:
        frames = read_luma(args.clip)
    else:
        rng = np.random.default_rng(0)
        yy, xx = np.mgrid[0:256, 0:256]
        frames = [(128 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 11.0)
                   + rng.normal(0, 8, (256, 256))).clip(0, 255)
                  .astype(np.uint8)]
    mags = measure_mags(frames, args.n, args.device)
    zz = gen_zigzag(mags)
    print("OD_ZIGZAG%d = [" % args.n)
    for x, y in zz:
        print("  (%d, %d)," % (x, y))
    print("]")


if __name__ == "__main__":
    main()
