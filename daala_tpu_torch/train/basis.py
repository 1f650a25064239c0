"""Synthesis basis functions and magnitudes of the lapped transform.

Reproduces the reference's compute_basis tool
(reference: tools/compute_basis.c:58-91): push a unit pulse through
the inverse DCT and the two boundary post-filters exactly as the
codec applies them, and measure each basis function's L2 norm.  The
resulting magnitudes are the `OD_BASIS_MAG` tables used for PVQ
quantization-matrix compensation (reference: src/pvq.c, shipped here
as `daala_tpu_torch.ops._tables.BASIS_MAG*`); tests/test_torch_train.py
checks the regenerated values against the shipped tables.

The codec currently laps every block size with the 4-point filter
(reference: src/filter.h:73-77 `OD_FILT_SIZE(ln, xdec) == 0`), so the
luma and 4:2:0-chroma tables coincide.
"""

from __future__ import annotations

import numpy as np

from daala_tpu_torch.ops import _lifting as L

_IDCT = {4: L.idct4, 8: L.idct8, 16: L.idct16, 32: L.idct32, 64: L.idct64}

#: Pulse amplitude used by the reference tool; large enough that the
#: integer transforms' rounding contributes <1e-3 to the magnitudes.
BASIS_PULSE = 1024


def _lanes(vec: np.ndarray) -> list:
    return [np.asarray(v, np.int64) for v in vec]


def synthesis_basis(n: int, dec: int = 0) -> np.ndarray:
    """(n, n+8) int array: row i is the spatial-domain synthesis basis
    of coefficient i, scaled by BASIS_PULSE, spanning the 2-sample
    lapping aprons on each side (reference: tools/compute_basis.c:63-80).

    `dec` is the chroma decimation flag; it only selects the lapping
    filter size, which is constant in the current format, so the output
    does not depend on it (kept for tool-CLI parity).
    """
    del dec  # OD_FILT_SIZE(ln, xdec) == 0 for every (ln, xdec)
    if n not in _IDCT:
        raise ValueError("block size must be one of %s" % sorted(_IDCT))
    filt_ap = 2  # 2 << OD_FILT_SIZE == 2 samples of apron per side
    out = np.zeros((n, n + 4 * filt_ap), np.int64)
    for i in range(n):
        x = np.zeros(n, np.int64)
        x[i] = BASIS_PULSE
        y = np.array(_IDCT[n](_lanes(x)), np.int64)
        buf = np.zeros(n + 4 * filt_ap, np.int64)
        buf[2 * filt_ap:2 * filt_ap + n] = y
        # The wider (left) lapping is applied first, then the right
        # edge; both are the 4-point post-filter.
        lo = 2 * filt_ap - filt_ap
        buf[lo:lo + 4] = L.post_filter4(_lanes(buf[lo:lo + 4]))
        hi = 2 * filt_ap + n - filt_ap
        buf[hi:hi + 4] = L.post_filter4(_lanes(buf[hi:hi + 4]))
        out[i] = buf
    return out


def basis_magnitudes(n: int, dec: int = 0) -> np.ndarray:
    """Per-coefficient synthesis magnitudes sqrt(sum y^2)/pulse
    (reference: tools/compute_basis.c:74-80)."""
    b = synthesis_basis(n, dec).astype(np.float64)
    # The reference sums over sample positions [-2, n+2) around the
    # block, i.e. buffer columns [2, n+6) with our 2-sample margins.
    return np.sqrt((b[:, 2:n + 6] ** 2).sum(axis=1)) / BASIS_PULSE


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ln", type=int, help="log2(size) - 2, e.g. 1 for 8x8")
    ap.add_argument("mode", choices=["coeff", "mag", "coeff420", "mag420"])
    args = ap.parse_args(argv)
    n = 4 << args.ln
    dec = 1 if args.mode.endswith("420") else 0
    if args.mode.startswith("mag"):
        print(", ".join("%f" % m for m in basis_magnitudes(n, dec)))
    else:
        for row in synthesis_basis(n, dec):
            print(" ".join(str(int(v)) for v in row))


if __name__ == "__main__":
    main()
