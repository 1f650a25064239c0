"""Search the fixed-point cosine-polynomial constants used by PVQ.

`od_pvq_cos` approximates 32768*cos(pi*x/65536) with a Q15 integer
polynomial whose four constants were found by exhaustive neighborhood
search (reference: tools/cos_search.c:61-88; the winning constants are
the `C` array used in src/pvq.c and `daala_tpu_torch.ops.pvq._cos_pi_2`).
This module re-implements the search as a vectorized numpy program:
the polynomial is evaluated for all 32768 inputs at once per candidate
(integer ops identical to the codec's), so a radius-r search costs
(2r+1)^4 batched evaluations instead of the reference's quadruple
scalar loop.

tests/test_torch_train.py uses radius 1 to confirm the codec's shipped
constants are the exact local optimum of the squared-error objective
(the tool's printed `C` array is a stale dev artifact the reference
codec never adopted -- it scores sse 6534 vs the shipped 4565).
"""

from __future__ import annotations

import itertools

import numpy as np

#: The constants the codec actually ships in od_pvq_cos
#: (reference: src/pvq.c:429-456; daala_tpu_torch.ops.pvq._cos_pi_2).
SHIPPED = 1073758164, -7654, 16573, -2529

#: The (unadopted) winner printed by the reference tool
#: (reference: tools/cos_search.c:50 `C`).
TOOL_C = (1 << 30) + (1 << 14), -7651, 16554, -2504


def cos2_batch(c, x):
    """Vectorized od_pvq_cos2 over int32 x in [0, 32768): the Q15
    polynomial c0 - x^2 + x2*(c1 + (x2*(c2 + (c3*x2 >> 16)) >> 16)),
    clamped to 32767 (reference: tools/cos_search.c:52-59)."""
    x = x.astype(np.int64)
    x2 = (x * x) >> 15
    t = c[2] + ((c[3] * x2) >> 16)
    t = c[1] + ((x2 * t) >> 16)
    return np.minimum(32767, (c[0] - x * x + x2 * t) >> 15)


def truth(n: int = 32768) -> np.ndarray:
    """The real-valued target 32768*cos(i*pi/65536)."""
    return 32768.0 * np.cos(np.arange(n) * np.pi / 65536.0)


def sq_error(c, t=None) -> float:
    """Sum of squared errors of the integer polynomial vs the real
    cosine over the full input range."""
    if t is None:
        t = truth()
    x = np.arange(len(t), dtype=np.int64)
    err = cos2_batch(c, x) - t
    return float((err * err).sum())


def search(center=SHIPPED, radius: int = 1):
    """Best (constants, sse) in the +-radius hypercube around
    `center` (reference: tools/cos_search.c:69-88 with NS=radius)."""
    t = truth()
    best, best_sse = None, np.inf
    offs = range(-radius, radius + 1)
    for d in itertools.product(offs, offs, offs, offs):
        c = tuple(center[k] + d[k] for k in range(4))
        sse = sq_error(c, t)
        if sse < best_sse:
            best, best_sse = c, sse
    return best, best_sse


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--radius", type=int, default=2)
    args = ap.parse_args(argv)
    best, sse = search(radius=args.radius)
    print("best constants:", best, "sse:", sse)
    print("shipped:", SHIPPED, "sse:", sq_error(SHIPPED))


if __name__ == "__main__":
    main()
