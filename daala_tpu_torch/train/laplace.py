"""Regenerate the Laplace / exponential entropy-coder tables.

The shipped `EXP_CDF_TABLE` / `LAPLACE_OFFSET` pair (used by the
Laplace coders in `daala_tpu_torch.entropy.models`) and the `CDF_TABLE` /
`DECAY_E` pair are bitstream-normative, machine-generated data.  The
reference generates them with small C programs
(reference: tools/gen_laplace_tables.c:36-124, tools/gen_cdf.c:35-110);
this module reproduces the same computation -- including the C
programs' float32 truncation behavior, which the table values depend
on -- so the tables in `daala_tpu_torch.ops._tables` can be regenerated and
audited rather than trusted as opaque constants.
"""

from __future__ import annotations

import math

import numpy as np


def _quantize_pmf(p: np.ndarray) -> np.ndarray:
    """Round a 16-bin pmf to integers summing to 32768, minimum 1 per
    bin, dumping the rounding residual on the most probable bin
    (reference: tools/gen_laplace_tables.c:85-99)."""
    pi = np.floor(0.5 + 32768 * p).astype(np.int64)
    pi = np.maximum(pi, 1)
    maxj = int(np.argmax(p))
    pi[maxj] += 32768 - int(pi.sum())
    return pi


def gen_laplace_tables(n: int = 128, shift: int = 7):
    """(EXP_CDF_TABLE, LAPLACE_OFFSET) for `n` decay entries.

    Row i models a geometric distribution with ratio r = i / 2**shift;
    bins 0..14 are exact, bin 15 absorbs the tail.  The offset table is
    the Q15 probability mass reserved below the first symbol
    (reference: tools/gen_laplace_tables.c:69-118).
    """
    cdfs = np.empty((n, 16), np.int32)
    offs = np.empty(n, np.int32)
    # Row 0 is the degenerate all-mass-on-zero distribution, with each
    # later bin granted the minimum 1/32768 probability.
    cdfs[0] = 32768 - 15 + np.arange(16)
    offs[0] = 0
    f32 = np.float32
    for i in range(1, n):
        r = f32(i) / f32(1 << shift)
        p = np.empty(16, np.float64)
        p[0] = f32(1) - r
        for j in range(1, 15):
            # float32 truncation of (1-r)*pow(r, j), as the C tool's
            # float locals produce.
            p[j] = f32(f32(f32(1) - r) * f32(math.pow(r, j)))
        p[15] = f32(math.pow(r, 15))
        sr = math.sqrt(r)
        offs[i] = int(32768 * (p[0] - p[0] * sr / (1 + sr)))
        cdfs[i] = np.cumsum(_quantize_pmf(p)).astype(np.int32)
    return cdfs, offs


def gen_cdf(n: int = 128, shift: int = 7):
    """(CDF_TABLE, DECAY_E) from tools/gen_cdf.c:35-110.

    Row i models a Laplacian with expected absolute value
    Ex = i / 2**shift, matched via the stationary-point decay
    gamma = (sqrt(1+4*Ex^2)-1)/(2*Ex); bin 0 gets the central mass,
    bins 1..14 the successive shells, bin 15 the tail.  DECAY_E is
    256*exp(-1/a), the adaptation target for the decay estimator.
    """
    cdfs = np.empty((n + 1, 16), np.int32)
    decay = np.empty(n + 1, np.int32)
    cdfs[0] = 32768 - 15 + np.arange(16)
    decay[0] = 1
    f32 = np.float32
    for i in range(1, n + 1):
        ex = f32(i) / f32(1 << shift)
        gamma = (math.sqrt(1 + 4 * ex * ex) - 1) / (2 * ex)
        a = -0.5 / math.log(gamma)
        decay[i] = int(math.floor(0.5 + 256 * math.exp(-1.0 / a)))
        p = np.empty(16, np.float64)
        p[0] = f32(1 - math.exp(-0.5 / a))
        e = math.exp(-0.5 / a)
        for j in range(1, 15):
            p[j] = f32(e * (math.exp(-(j - 1.0) / a) - math.exp(-float(j) / a)))
        p[15] = f32(e * math.exp(-14.0 / a))
        cdfs[i] = np.cumsum(_quantize_pmf(p)).astype(np.int32)
    return cdfs, decay


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("which", choices=["laplace", "cdf"])
    ap.add_argument("n", type=int, nargs="?", default=128)
    ap.add_argument("shift", type=int, nargs="?", default=7)
    args = ap.parse_args(argv)
    if args.which == "laplace":
        cdfs, offs = gen_laplace_tables(args.n, args.shift)
        print("EXP_CDF_TABLE =", cdfs.tolist())
        print("LAPLACE_OFFSET =", offs.tolist())
    else:
        cdfs, decay = gen_cdf(args.n, args.shift)
        print("CDF_TABLE =", cdfs.tolist())
        print("DECAY_E =", decay.tolist())


if __name__ == "__main__":
    main()
