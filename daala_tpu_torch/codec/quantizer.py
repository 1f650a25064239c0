"""Coded quantizer map (reference: src/quantizer.c).

The port's copy of daala_tpu/codec/quantizer.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from daala_tpu_torch.ops import _tables as T
from daala_tpu_torch.ops.intrin import OD_COEFF_SHIFT

MAP_Q4 = [int(v) for v in T.CODED_QUANTIZER_MAP_Q4]
N_CODED_QUANTIZERS = len(MAP_Q4)


def codedquantizer_to_quantizer(cq: int) -> int:
    """Reference: src/quantizer.c:73-89."""
    if cq == 0:
        return 0
    if cq < N_CODED_QUANTIZERS:
        return MAP_Q4[cq] << OD_COEFF_SHIFT >> 4
    return MAP_Q4[N_CODED_QUANTIZERS - 1] << OD_COEFF_SHIFT >> 4


def quantizer_to_codedquantizer(q: int) -> int:
    """Reference: src/quantizer.c:92-126 (binary search, ties -> smaller)."""
    if q == 0:
        return 0
    hi = N_CODED_QUANTIZERS
    lo = 1
    q = q << 4 >> OD_COEFF_SHIFT
    while hi > lo + 1:
        mid = (hi + lo) >> 1
        if q < MAP_Q4[mid]:
            hi = mid
        else:
            lo = mid
    if hi < N_CODED_QUANTIZERS:
        lodist = q - MAP_Q4[lo]
        hidist = MAP_Q4[hi] - q
        if hidist < lodist:
            return hi
    return lo


def quality_to_quantizer(quality: int) -> int:
    """Reference: src/rate.c:717-725 (quality in Q4 units via CLI <<4)."""
    if quality <= 0:
        return quality
    return (quality << OD_COEFF_SHIFT >> 4) + (1 << OD_COEFF_SHIFT >> 1)
