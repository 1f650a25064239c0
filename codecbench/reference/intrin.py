"""Fixed-point intrinsics for the TPU-native Daala rebuild.

These helpers mirror the semantics of the reference implementation's
portability layer (reference: src/odintrin.h:88-190, src/filter.h:35-41)
but are expressed as array ops that work identically on NumPy arrays and
JAX tracers (including inside Pallas kernels).  All normative arithmetic
is int32 with C wraparound semantics; Python operators on int32 arrays
already match, so only the non-trivial rounding/shift helpers live here.

A frozen copy of the port's ops/intrin.py, for the benchmark's plain
reference.
"""

from __future__ import annotations

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

# OD_BITRES: resolution of fractional bit usage measurements (1/8 bit).
OD_BITRES = 3

# OD_COEFF_SHIFT: extra precision bits used for transform coefficients
# (reference: src/internal.h:124-125).
OD_COEFF_SHIFT = 4
OD_COEFF_SCALE = 1 << OD_COEFF_SHIFT


def dct_rshift(a, b: int):
    """Unbiased (round-toward-zero) arithmetic shift right.

    Mirrors OD_UNBIASED_RSHIFT32 / OD_DCT_RSHIFT (reference:
    src/filter.h:35-41): adds (1 << b) - 1 before shifting when the value
    is negative, i.e. truncating division by 2**b.  Works on Python ints,
    NumPy arrays, and JAX tracers alike.
    """
    if b == 0:
        return a
    # (a >> 31) is -1 (all ones) for negative values, 0 otherwise; masking
    # with (1 << b) - 1 yields the unbias correction term.
    return (a + ((a >> 31) & ((1 << b) - 1))) >> b


def c_div(a, b):
    """C-style truncating integer division (round toward zero).

    Python's // floors, which differs for negative operands; the codec's
    normative math (e.g. the post-filter inverse scaling, reference:
    src/filter.c:210-215) requires truncation.
    """
    if isinstance(a, int) and isinstance(b, int):
        q = abs(a) // abs(b)
        return q if (a < 0) == (b < 0) else -q
    # Array path: a // b then correct where signs differ and division is
    # inexact (floor rounded down instead of toward zero).
    q = a // b
    r = a - q * b
    return q + ((r != 0) & ((a < 0) != (b < 0)))


def od_ilog_nz(x: int) -> int:
    """Position of the highest set bit + ... = number of bits (x > 0).

    Mirrors OD_ILOG_NZ (reference: src/odintrin.h:236): od_ilog(x) for
    nonzero x, i.e. floor(log2(x)) + 1.  Host/scalar use only.
    """
    return x.bit_length()


def od_ilog(x: int) -> int:
    """OD_ILOG: 0 for x == 0, else bit length (reference: src/odintrin.h:241)."""
    return x.bit_length()


def ilog_nz_array(x):
    """Vectorized OD_ILOG for arrays (number of bits in the value).

    Works on NumPy int32 arrays and JAX tracers.  Assumes x >= 0.
    """
    # 31 - clz(x) + 1 = bit_length.  Build via comparisons to avoid
    # float log inaccuracies; a 5-step binary reduction.
    n = x * 0
    v = x
    for shift in (16, 8, 4, 2, 1):
        big = v >= (1 << shift)
        n = n + big * shift
        v = v >> (big * shift)
    return n + (v > 0)


def flip_sign(a, b):
    """OD_FLIPSIGNI(a, b): negate a when b is negative (reference:
    src/odintrin.h:100-102).  (a + signmask) ^ signmask with
    signmask = -(b < 0)."""
    m = -(b < 0) if isinstance(b, int) else (b >> 31)
    return (a + m) ^ m


def copysign_int(a, b):
    """OD_COPYSIGNI: |a| with the sign of b."""
    return flip_sign(abs(a), b)


def od_shr_round(x, shift: int):
    """OD_SHR_ROUND: arithmetic shift right with round-to-nearest
    (reference: src/odintrin.h:176-178)."""
    if shift == 0:
        return x
    return (x + (1 << shift >> 1)) >> shift


def wrap32(v):
    """An integer tensor (or int) truncated to int32, as an int32 sum or a
    cast to int32 wraps it, computed in int64 (the port's
    models/analysis.py wrap32)."""
    import torch
    if isinstance(v, torch.Tensor):
        v = v.to(torch.int64)
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
