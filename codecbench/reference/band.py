"""The PVQ band search around its pulse search in plain PyTorch: a
frozen copy of the plain versions in the port's ops/cuda/band_kernels.py
(the code its band_prologue and band_epilogue kernels equal bit for
bit), without the kernels.

Replaces the rest of band_search (daala_tpu/models/pvqsearch.py:562),
which JAX runs in XLA, not Pallas.  `band_prologue` gathers each row's
band, computes its gains, the Householder reflection and the 12 theta
and 2 noref candidates, and writes what the pulse search takes;
`band_epilogue` takes the pulse search's result and computes each
candidate's distortion, codeword rate and cost, then picks the winner.
On the card a band_search call is these two launches around the pulse
search's (ops/cuda/pulse_kernels.py), with no host sync; on the CPU the
plain versions.

The float32 expressions take XLA:CPU's forms of JAX's jitted
band_search, read in its optimized HLO and LLVM IR (the fused
multiply-adds are LLVM's contractions of a single-use product into the
add or subtract that uses it, first operand first):

- corr = (corr_i 2^s) / (g gr): XLA drops the 1e-100 (0 in float32) and
  rewrites A / (B / C) as (A C) / B;
- acos(c) = atan2(sqrt((1 - c)(1 + c)), c), with glibc's float32 atan2f,
  which XLA:CPU calls, written out (`atan2f_glibc`) on every device;
- theta_q = floor(fma(theta, 65536 / pi, 0.5)); the theta scale folds
  to 2^-15; t_lower = floor(fma(tq_s, ts, 0.5)), except in the fusion
  that tests it against t_upper, where the product has two uses and is
  not contracted (`ok` takes that one);
- the inter skip distortion and the theta = 0 initial candidate:
  fma(2 - 2 corr, cr cg, 1.4 (cg - cr)^2) 2^-16; the theta gate's and
  every candidate's distortion fma(1.4, (q - cg)^2, q cg t) 2^-16 (t
  the theta or noref term, whose theta part is fma(sinp, 2 - 2 cos,
  dth)); the cost fma(lam, rate, dist), except where the inter scan
  picks the pulses: that fusion rounds lam rate first (`_select`);
- log2 is XLA's log (`xla_log`, a Cephes polynomial with its own
  contractions) times float32(1 / ln 2); the codeword costs are
  fma(-log p, c, log2 tot) (k = 1 leaves) and fma(log tot, c, -log2 p)
  + shift (splits); the theta rate fma(log ts, float32(0.9 / ln 2),
  -0.5 [i == icgr]);
- the node sums of the rate tree are chains below 16 nodes, 8 lanes
  halved then the rest up to 32, else chunks of 32 with the padding
  split low / high as XLA pads them (`node_sum`).

A fused multiply-add is rounded once (pulse_kernels.py `_fma32`), as
the CPU's and the card's FMA instructions round it.  Everything else
(the fixed-point gains, companding, Householder and k) is int64 with
torch's shift rules, as before.  See csrc/band_row.cuh
for the kernels' arithmetic, which tests/test_torch_band_plan.py
compiles for the host and holds to these plain versions.
"""

from __future__ import annotations

import functools
import math
import struct

import numpy as np
import torch

from codecbench.reference.intrin import wrap32 as _wrap32
from codecbench.reference import pvq as P
from codecbench.reference.pulse import CHUNK, _fma32, ordered_sum

MAX_N = 128  # the widest band the kernels take: the codec's widest
NCAND = 14  # 12 theta candidates (3 gains x 4 thetas), then 2 noref

_GAIN_WEIGHT = 1.4
_GW32 = float(np.float32(_GAIN_WEIGHT))  # the weight as a float32 operand
_CGSCALE = float(P.OD_CGAIN_SCALE)
# 1 / OD_CGAIN_SCALE^2, rounded to float32 as the JAX module's constant.
_INV_CS2 = float(np.float32(1.0 / (_CGSCALE * _CGSCALE)))
# float32(OD_MAX_THETA_SCALE * 2 / pi), JAX's weakly typed constant.
_THETA_C = float(np.float32(P.OD_MAX_THETA_SCALE * 2.0 / np.pi))
# XLA folds theta_scale_1 * 2 / pi (float32 constants) to exactly 2^-15.
_TQ_SCALE = 2.0 ** -15
_LOG2E = float(np.float32(1.0 / math.log(2.0)))  # float32(1 / ln 2)
# 0.9 * log2(x) = log(x) * float32(float32(1 / ln 2) * float32(0.9)).
_TRATE_C = float(np.float32(np.float32(_LOG2E) * np.float32(0.9)))


def _f32(h):
    """The float32 value whose float64 bit pattern is the hex `h` (LLVM's
    spelling of a float constant)."""
    return struct.unpack(">d", bytes.fromhex(h))[0]


# XLA:CPU's float32 log: Cephes' logf polynomial (Eigen's plog).
_LOG_P = tuple(_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
_LOG_Q1 = _f32("BF2BD01060000000")
_LOG_Q2 = _f32("3FE6300000000000")
_SQRTHF = _f32("3FE6A09E60000000")

# ---------------------------------------------------------------------------
# Vectorized fixed-point helpers (int32 semantics of ops/pvq.py) on int64
# tensors.  Arguments are int64 tensors or Python ints.
# ---------------------------------------------------------------------------


def _l(x):
    """int64 view of a tensor argument (Python ints pass through)."""
    return x.long() if torch.is_tensor(x) else x


@functools.lru_cache(maxsize=None)
def _pow2(device):
    return torch.tensor([1 << i for i in range(32)], dtype=torch.int64,
                        device=device)


def _ilog(x):
    """OD_ILOG for non-negative x (bit length); 0 -> 0.  The input is
    truncated to uint32 first, as JAX's astype(uint32) does; the bit
    length is an integer search of the powers of two (no float log2)."""
    x = _l(x) & 0xFFFFFFFF
    return torch.searchsorted(_pow2(x.device), x, right=True)


def _ilog_c(x):
    """OD_ILOG via CLZ: negative 32-bit inputs yield 32."""
    x = _l(x)
    return torch.where(x < 0, 32, _ilog(x.clamp_min(0)))


def _shl32(a, s):
    """32-bit wrapping left shift."""
    v = (_l(a) << s) & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v)


def _wrap16(v):
    return ((v + 32768) & 65535) - 32768


def _shr_round(x, s):
    return (_l(x) + ((1 << s) >> 1)) >> s


def _vshr(x, s):
    """Variable shift; negative s = wrapping left shift."""
    if not torch.is_tensor(s):
        return _l(x) >> s if s > 0 else _shl32(x, -s)
    return torch.where(s > 0, _l(x) >> s.clamp_min(0),
                       _shl32(x, (-s).clamp_min(0)))


def _vshr_round(x, s):
    if not torch.is_tensor(s):
        return _shr_round(x, s) if s > 0 else _shl32(x, -s)
    sp = s.clamp_min(0)
    return torch.where(s > 0, (_l(x) + ((1 << sp) >> 1)) >> sp,
                       _shl32(x, (-s).clamp_min(0)))


def _mult16_16_q15(a, b):
    return (_l(a) * _l(b)) >> 15


def _mult16_16_q16(a, b):
    return (_l(a) * _l(b)) >> 16


def _mult16_32_qbeta(a, b):
    return (_l(a) * _l(b)) >> P.OD_BETA_SHIFT


def _od_rcp(x):
    i = _ilog_c(x) - 1
    n = _wrap16(_vshr_round(x, i - P.OD_RCP_INSHIFT)
                - (1 << P.OD_RCP_INSHIFT))
    r = _wrap16(30840 + _mult16_16_q15(-15420, n))
    r = _wrap16(r - _mult16_16_q15(r, _mult16_16_q15(r, n) + r - 32768))
    r = _wrap16(r - (1 + _mult16_16_q15(r, _mult16_16_q15(r, n) + r
                                        - 32768)))
    return _wrap16(_vshr_round(r, i - P.OD_RCP_OUTSHIFT))


def _rsqrt_norm(t):
    n = _l(t) - 32768
    r = 23565 + _mult16_16_q15(n, -13481 + _mult16_16_q15(n, 6711))
    r2 = r * r
    y = (((r2 >> 15) * n + r2) >> 12) - 131077
    ry = r * y
    return r + ((((ry >> 16) * (3 * y) >> 3) - ry) >> 18)


def _sqrt_norm(x):
    return _shr_round(x * _rsqrt_norm(x), P.OD_SQRT_OUTSHIFT) \
        .clamp_max(32767)


def _od_sqrt(x):
    """(sqrt_norm, shift); x == 0 -> (0, 0)."""
    k = (_ilog(x) - 1) >> 1
    s = 2 * k - (P.OD_SQRT_INSHIFT - 2)
    t = _vshr(x, s)
    shift = P.OD_SQRT_OUTSHIFT - ((s + P.OD_SQRT_INSHIFT) >> 1)
    zero = _l(x) == 0
    return (torch.where(zero, 0, _sqrt_norm(t)),
            torch.where(zero, 0, shift))


_EXP2_C = (32768, 22709, 7913, 1704, 443)


def _od_exp2(x):
    integer = _l(x) >> P.OD_EXP2_INSHIFT
    xf = _l(x) - _shl32(integer, P.OD_EXP2_INSHIFT)
    frac = _mult16_16_q15(
        xf, _EXP2_C[1] + _mult16_16_q15(
            xf, _EXP2_C[2] + _mult16_16_q15(
                xf, _EXP2_C[3] + _mult16_16_q15(xf, _EXP2_C[4]))))
    out = _vshr_round(_EXP2_C[0] + frac, -integer) + 1
    out = torch.where(integer > 14, 0x7F000000, out)
    return torch.where(integer < -15, 0, out)


def _od_log2(x):
    return _l(x) + _mult16_16_q15(
        x, 14482 + _mult16_16_q15(
            x, -23234 + _mult16_16_q15(
                x, 13643 + _mult16_16_q15(
                    x, -6403 + _mult16_16_q15(x, 1515)))))


def _od_pow(x, beta):
    """x**beta (beta a host int, Q12); x a tensor."""
    log2_x = _ilog(x) - 1
    xshift = log2_x - P.OD_LOG2_INSHIFT
    t = _vshr(x, xshift) - (1 << P.OD_LOG2_INSHIFT)
    logr = _od_log2(t) + (log2_x - P.OD_COMPAND_SHIFT) \
        * P.OD_LOG2_OUTSCALE
    logr = _mult16_32_qbeta(beta, logr)
    return torch.where(_l(x) == 0, 0, _od_exp2(logr))


_RCP_B15 = P.beta_rcp(P.BETA_1_5)


def _gain_compand(g, q0, beta15):
    """Per-row companding: beta15 (bool) selects the activity-masking
    beta 1.5 (Q12) vs beta 1 (the only two betas the encoder uses)."""
    q0l = _l(q0)
    b1 = torch.div(P.OD_CGAIN_SCALE * _l(g) + (q0l >> 1), q0l,
                   rounding_mode="floor")
    expr = _od_pow(g, _RCP_B15)
    expr = expr << (P.OD_CGAIN_SHIFT + P.OD_COMPAND_SHIFT
                    - P.OD_EXP2_OUTSHIFT)
    b15 = torch.div(expr + (q0l >> 1), q0l, rounding_mode="floor")
    return torch.where(beta15, b15, b1)


def _compute_gain(x16, q0, beta15, bshift):
    acc = (_l(x16) * _l(x16)).sum(-1)
    irt, sqrt_shift = _od_sqrt(acc)
    g = _vshr_round(irt, sqrt_shift - bshift)
    return _gain_compand(g, q0, beta15), g


def _gain_expand(cg0, q0, beta):
    if beta == P.BETA_1:
        return _shr_round(_l(cg0) * _l(q0), P.OD_CGAIN_SHIFT)
    if beta == P.BETA_1_5:
        irt, sqrt_outshift = _od_sqrt(_l(cg0) * _l(q0))
        sqrt_inshift = (P.OD_CGAIN_SHIFT + P.OD_COMPAND_SHIFT) >> 1
        tmp = _l(cg0) * _l(q0) * irt
        return _vshr_round(tmp, P.OD_CGAIN_SHIFT + sqrt_outshift
                           + sqrt_inshift)
    cg = _shr_round(_l(cg0) * _l(q0), P.OD_CGAIN_SHIFT)
    expr = _od_pow(cg, beta)
    return _shr_round(expr, P.OD_EXP2_OUTSHIFT - P.OD_COMPAND_SHIFT)


def _cos_pi_2(x):
    x2 = _mult16_16_q15(x, x)
    return ((1073758164 - _l(x) * _l(x) + x2
             * (-7654 + _mult16_16_q16(x2, 16573
                                       + _mult16_16_q16(-2529, x2))))
            >> 15).clamp_max(32767)


def _pvq_cos(x):
    x = _l(x) & 0x0001FFFF
    x = torch.where(x > (1 << 16), (1 << 17) - x, x)
    poly = torch.where(x < (1 << 15), _cos_pi_2(x), -_cos_pi_2(65536 - x))
    exact = torch.where((x & 0x0000FFFF) != 0, 0,
                        torch.where((x & 0x0001FFFF) != 0, -32767, 32767))
    return torch.where((x & 0x00007FFF) != 0, poly, exact)


def _pvq_sin(x):
    return _pvq_cos(32768 - _l(x))


def _compute_max_theta(qcg, beta15):
    qconst_pi_2 = int(0.5 + (np.pi / 2) * (1 << P.OD_CGAIN_SHIFT))
    rcp = torch.where(beta15, _RCP_B15, P.BETA_1)
    ts = _shr_round(_l(qcg) * _mult16_32_qbeta(rcp, qconst_pi_2),
                    P.OD_CGAIN_SHIFT * 2)
    return _wrap32(torch.where(
        _l(qcg) < int(0.5 + 1.4 * (1 << P.OD_CGAIN_SHIFT)), 1, ts))


def _compute_theta(t, max_theta):
    t = torch.minimum(_l(t), _l(max_theta) - 1)
    return torch.where(_l(max_theta) != 0,
                       torch.div(P.OD_MAX_THETA_SCALE * t
                                 + (_l(max_theta) >> 1),
                                 _l(max_theta).clamp_min(1),
                                 rounding_mode="floor"),
                       0)


def _compute_k(qcg, itheta, noref, n, beta15):
    """n, noref: host values; qcg/itheta tensors (itheta unused when
    noref); beta15 (bool) selects the beta-1.5 rows."""
    if noref:
        rt = P._SQRT_TABLE[1][P._ilog(n + 1)]
        rcp = torch.where(beta15, _RCP_B15, P.BETA_1)
        k = _shr_round(
            (_l(qcg) - int(0.5 + 0.2 * (1 << P.OD_CGAIN_SHIFT)))
            * _mult16_32_qbeta(rcp, rt),
            P.OD_CGAIN_SHIFT + P.OD_SQRT_TBL_SHIFT).clamp_min(1)
        k = torch.where(_l(qcg) == 0, 0, k)
        if n == 15:
            # The reference's n==15, beta > 1.25 special case: only the
            # beta-1.5 rows qualify (beta 1 does not).
            k = torch.where(beta15 & (_l(qcg) == P.OD_CGAIN_SCALE), 1, k)
        return _wrap32(k)
    rt = P._SQRT_TABLE[0][P._ilog(n + 1)]
    k = _vshr_round(
        (_shl32(itheta, P.OD_ITHETA_SHIFT)
         - int(0.5 + 0.2 * (1 << P.OD_ITHETA_SHIFT))) * rt,
        P.OD_SQRT_TBL_SHIFT + P.OD_ITHETA_SHIFT).clamp_min(1)
    return _wrap32(torch.where(_l(itheta) == 0, 0, k))


def _apply_householder(x, r):
    """Vectorized over rows: x, r (m, n) int64."""
    l2r = (r * r).sum(-1, keepdim=True)
    proj = (r * x).sum(-1, keepdim=True)
    l2r_shift = (_ilog(l2r) - 1) - 14
    l2r_norm = _wrap16(_vshr_round(l2r, l2r_shift))
    rcp = _od_rcp(l2r_norm)
    proj_shift = (_ilog(proj.abs()) - 1) - 14
    proj_norm = _wrap16(_vshr_round(proj, proj_shift))
    proj_1 = _wrap16(_mult16_16_q15(proj_norm, rcp))
    outshift = (P.OD_RCP_OUTSHIFT - proj_shift - 1 + l2r_shift) \
        .clamp_max(30)
    tmp = r * proj_1
    sp = outshift.clamp_min(0)
    pos = (tmp + ((1 << sp) >> 1)) >> sp
    neg = _shl32(tmp, (-outshift).clamp_min(0))
    tmp = torch.where(outshift >= 0, pos, neg)
    return _wrap16(x - tmp)


# ---------------------------------------------------------------------------
# The float32 functions XLA:CPU computes its own way.
# ---------------------------------------------------------------------------


def xla_log(x):
    """XLA:CPU's float32 log of a float32 tensor of positive finite
    values: Cephes' logf polynomial (Eigen's plog) with the fused
    multiply-adds LLVM contracts it into.  Equal to JAX's jitted
    jnp.log on every integer to 2^17 and on 400,000 floats over nine
    decades (tests/test_torch_band_order.py); torch.log differs from it
    in about one value in thirty."""
    x = x.clamp_min(2.0 ** -126)
    b = x.view(torch.int32)
    e = ((b >> 23) - 127).float() + 1.0
    m = ((b & -2139095041) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _SQRTHF
    e = e - torch.where(small, 1.0, 0.0)
    r = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = r * r
    x3 = x2 * r
    p = _LOG_P
    y = _fma32(r, p[0], p[1])
    y1 = _fma32(r, p[3], p[4])
    y2 = _fma32(r, p[6], p[7])
    y = _fma32(y, r, p[2])
    y1 = _fma32(y1, r, p[5])
    y2 = _fma32(y2, r, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, (e * _LOG_Q1))
    s = _fma32(x2, -0.5, r) + y
    return _fma32(e, _LOG_Q2, s)


def _bits32(*patterns):
    """The float32 values of the bit patterns, as Python floats."""
    return tuple(float(v) for v in np.array(patterns, np.uint32)
                 .view(np.float32))


# glibc 2.36's atanf constants: atan(0.5), atan(1), atan(1.5), atan(inf)
# in two parts, and the polynomial's 11 coefficients.
_ATAN_HI = _bits32(0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATAN_LO = _bits32(0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
_AT = _bits32(0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E,
              0xBD9D8795, 0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221,
              0x3C8569D7)
# atan2f's pi, its low part, pi / 4, pi / 2 and 1e-30, and the float32
# sums it returns of them.
_PI, _PI_LO, _PI_O_4, _PI_O_2, _TINY = _bits32(
    0x40490FDB, 0xB3BBBD2E, 0x3F490FDB, 0x3FC90FDB, 0x0DA24260)
_f = np.float32
_ATAN_INF = float(_f(_ATAN_HI[3]) + _f(_ATAN_LO[3]))
_HALF_PI = float(_f(_PI_O_2) + _f(_TINY))
_FULL_PI = float(_f(_PI) + _f(_TINY))
_QUARTER_PI = float(_f(_PI_O_4) + _f(_TINY))
_3QUARTER_PI = float(_f(3.0) * _f(_PI_O_4) + _f(_TINY))
_FAR = float(_f(_PI_O_2) + _f(0.5) * _f(_PI_LO))  # |y / x| > 2^60


@functools.lru_cache(maxsize=None)
def _atan_tables(device):
    return (torch.tensor(_ATAN_HI, dtype=torch.float32, device=device),
            torch.tensor(_ATAN_LO, dtype=torch.float32, device=device))


def atanf_glibc(x):
    """glibc 2.36's float32 atan (fdlibm's __atanf, s_atanf.c) of a
    float32 tensor, elementwise, each operation one float32 rounding:
    csrc/band_row.cuh br::atanf_glibc.  The argument's five ranges
    (|x| < 0.4375, < 11/16, < 19/16, < 2.4375, beyond) reduce it each
    their own way before one polynomial; |x| < 2^-29 and |x| >= 2^25
    return at once."""
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    a = ix.view(torch.float32)
    rid = ((ix >= 0x3EE00000).int() + (ix >= 0x3F300000).int()
           + (ix >= 0x3F980000).int() + (ix >= 0x401C0000).int() - 1)
    r = torch.where(rid < 0, x, -a.reciprocal())
    r = torch.where(rid == 2, (a - 1.5) / (1.0 + 1.5 * a), r)
    r = torch.where(rid == 1, (a - 1.0) / (a + 1.0), r)
    r = torch.where(rid == 0, (2.0 * a - 1.0) / (2.0 + a), r)
    z = r * r
    w = z * z
    t = _AT
    s1 = z * (t[0] + w * (t[2] + w * (t[4] + w * (t[6] + w * (
        t[8] + w * t[10])))))
    s2 = w * (t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * t[9]))))
    xs = r * (s1 + s2)
    hi, lo = (v[rid.clamp_min(0).long()] for v in _atan_tables(x.device))
    v = hi - ((xs - lo) - r)
    out = torch.where(rid < 0, r - xs, torch.where(hx < 0, -v, v))
    out = torch.where(ix < 0x31000000, x, out)
    out = torch.where(ix >= 0x4C000000,
                      torch.where(hx > 0, _ATAN_INF, -_ATAN_INF), out)
    return torch.where(ix > 0x7F800000, x + x, out)


def atan2f_glibc(y, x):
    """glibc 2.36's float32 atan2 (fdlibm's __ieee754_atan2f,
    e_atan2f.c), the atan2f that XLA:CPU calls in JAX's arccos, of
    float32 tensors, elementwise: csrc/band_row.cuh br::atan2f_glibc.
    atan(|y / x|) moved to the quadrant of (x, y), after NaNs, x = 1,
    zeros and infinities, which take their own values."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 sign(x) + sign(y)
    k = (iy - ix) >> 23
    z = atanf_glibc((y / x).abs())
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    z = torch.where(k > 60, _FAR, z)
    out = torch.where(m == 2, _PI - (z - _PI_LO), (z - _PI_LO) - _PI)
    out = torch.where(m == 1, -z, out)
    out = torch.where(m == 0, z, out)
    neg = lambda v, cond: torch.where(cond, -v, v)
    yinf, xinf = iy == 0x7F800000, ix == 0x7F800000
    out = torch.where(yinf, neg(torch.full_like(y, _HALF_PI), hy < 0), out)
    both = torch.where(m < 2, _QUARTER_PI, _3QUARTER_PI)
    edge = torch.where(m < 2, 0.0, _FULL_PI)
    out = torch.where(xinf, neg(torch.where(yinf, both, edge), (m & 1) == 1),
                      out)
    out = torch.where(ix == 0, neg(torch.full_like(y, _HALF_PI), hy < 0),
                      out)
    out = torch.where(iy == 0, torch.where(
        m < 2, y, neg(torch.full_like(y, _FULL_PI), m == 3)), out)
    out = torch.where(hx == 0x3F800000, atanf_glibc(y), out)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


def acos_xla(c):
    """JAX's arccos of float32 values in [-1, 1] as XLA:CPU computes it,
    atan2(sqrt((1 - c)(1 + c)), c) with glibc's float32 atan2f
    (`atan2f_glibc`; torch's atan2, numpy's and CUDA's differ from it in
    the last bit of some values), on any device: what the band_prologue
    kernel computes (`acos_xla_cuda` runs it alone).  The square root is
    taken in float64 and rounded to float32, which is the correctly
    rounded float32 root: torch's float32 sqrt on the CPU is not (it
    misses in the last bit on some values near c = +-1)."""
    s = torch.sqrt(((1.0 - c) * (c + 1.0)).double()).float()
    return atan2f_glibc(s, c)


def node_sum(v):
    """The float32 sums of the rows of v (m, L) in XLA:CPU's order, read
    in JAX's band_search: for L < 16 (13 and 15 nodes) one chain from
    element 0 up; for 16 <= L <= 32 (27 and 29 nodes) 8 lanes, lane i
    summing elements i, i + 8, ... of the first 8 floor(L / 8), the
    lanes halved (i + 4, then + 2, then + 1), then the rest in order;
    longer rows (61 to 255 nodes) padded with zeros to a multiple of
    32, pad // 2 of them in front (XLA's split of the padding), each
    chunk of 32 a chain, then the chunk sums in order."""
    m, L = v.shape
    acc = v.new_zeros(m)
    if L < 16:
        for j in range(L):
            acc = acc + v[:, j]
        return acc
    if L <= CHUNK:
        nv = L // 8
        part = v.new_zeros(m, 8)
        for k in range(nv):
            part = part + v[:, 8 * k:8 * k + 8]
        for h in (4, 2, 1):
            part = part[:, :h] + part[:, h:2 * h]
        acc = part[:, 0]
        for j in range(8 * nv, L):
            acc = acc + v[:, j]
        return acc
    nc = -(-L // CHUNK)
    pad = nc * CHUNK - L
    v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2)) \
        .view(m, nc, CHUNK)
    part = v.new_zeros(m, nc)
    for j in range(CHUNK):
        part = part + v[:, :, j]
    for c in range(nc):
        acc = acc + part[:, c]
    return acc


# ---------------------------------------------------------------------------
# The codeword rate trees.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _split_tree(n):
    """DFS-preorder binary split tree of a band of length n (the
    recursion of od_encode_band_pvq_splits,
    src/laplace_encoder.c:56-80): list of (base, size, level,
    parent_index)."""
    nodes = []

    def build(base, size, level, parent):
        idx = len(nodes)
        nodes.append((base, size, level, parent))
        if size <= 1:
            return
        mid = size >> 1
        build(base, mid, level + 1, idx)
        build(base + mid, size - mid, level + 1, idx)

    build(0, n, 0, -1)
    return tuple(nodes)


@functools.lru_cache(maxsize=None)
def _tree_tables(n_tree):
    """Static evaluation tables for the split tree of a band of length
    n_tree (numpy, cached): node spans, parents, k1 CDF row ids, size
    contexts, and the proper-ancestor incidence matrix.  With these the
    whole tree evaluates as a fixed set of static-index gathers plus one
    (m, NN) x (NN, NN) matmul."""
    nodes = _split_tree(n_tree)
    nn = len(nodes)
    base = np.array([b for b, s, l, p in nodes], np.int32)
    size = np.array([s for b, s, l, p in nodes], np.int32)
    level = np.array([l for b, s, l, p in nodes], np.int32)
    parent = np.array([p for b, s, l, p in nodes], np.int32)
    anc = np.zeros((nn, nn), np.float32)
    for i in range(nn):
        p = parent[i]
        while p >= 0:
            anc[p, i] = 1.0
            p = parent[p]
    # k1 rows only exist for 1 < size <= 16 (is_k1 masks the rest; ids
    # outside that range would index past the CDF table).
    k1_id = np.array([P.k1_ctx(int(s), bool(l == 0))
                      if 1 < s <= 16 else 0
                      for s, l in zip(size, level)], np.int32)
    sz_ctx = np.array([P.size_ctx(int(s)) if s > 1 else 0
                       for s in size], np.int32)
    return dict(nn=nn, base=base, size=size, parent=parent, anc=anc,
                k1_id=k1_id, sz_ctx=sz_ctx, mid=(size >> 1))


def _tot1(tt, w1):
    """The flat index of each node's k1 CDF row total, in a k1 table w1
    wide, from _tree_tables's tt."""
    return tt["k1_id"] * w1 + np.minimum(tt["size"] - 1, w1 - 1)


@functools.lru_cache(maxsize=None)
def _tree_tensors(n_tree, w1, device):
    """_tree_tables(n_tree) as tensors on `device` (int64; the ancestor
    matrix float64), with the flat k1 CDF index of each node's total
    for a table of width w1."""
    tt = _tree_tables(n_tree)
    out = {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
           for k, v in tt.items() if k not in ("nn", "anc")}
    out["anc"] = torch.from_numpy(tt["anc"].astype(np.float64)).to(device)
    out["tot1"] = torch.from_numpy(_tot1(tt, w1).astype(np.int64)) \
        .to(device)
    return out


@functools.lru_cache(maxsize=None)
def node_table(n_tree, w1, device="cpu"):
    """The nodes of the split tree of n_tree lanes that span more than
    one lane (the others never code), as the kernels read them: an int32
    (n_tree - 1, 4) tensor on `device`, in preorder, of [e | base << 8 |
    size << 16 | psize << 24, pbase | 7 sz_ctx << 8, the k1 CDF row's
    offset (k1_id w1), the flat index of its total] per node
    (csrc/band_row.cuh br::Node): e is the node's place among all 2 n_tree
    - 1 nodes (the order of XLA's sums), pbase and psize its parent's span
    (psize 0 at the root)."""
    tt = _tree_tables(n_tree)
    inner = np.nonzero(tt["size"] > 1)[0]
    par = tt["parent"][inner]
    psize = np.where(par >= 0, tt["size"][np.maximum(par, 0)], 0)
    pbase = np.where(par >= 0, tt["base"][np.maximum(par, 0)], 0)
    tab = np.stack([inner | tt["base"][inner] << 8 | tt["size"][inner] << 16
                    | psize << 24, pbase | 7 * tt["sz_ctx"][inner] << 8,
                    (tt["k1_id"] * w1)[inner], _tot1(tt, w1)[inner]], 1)
    return torch.from_numpy(tab.astype(np.int32).reshape(-1, 4)).to(device)


def _codeword_rate(y, k, n_tree, n, k1_cdf, split_cdf):
    """Exact PVQ codeword rate (bits) from frame-start CDF tables:
    replays the recursive split coder of encode_band_pvq_splits
    (reference: src/laplace_encoder.c:56-80) over a static DFS tree,
    vectorized over (rows, nodes).  n_tree is the coded vector length
    (n for noref, n-1 for the theta path).  Within-band CDF adaptation
    is the only approximation.  k is not read: the argument keeps JAX's
    signature, and k == 0 rows fall out of the node masks.

    blocked(node) ("an ancestor terminated coding") is the OR over
    proper ancestors a of [(k(a)==1 & size(a)<=16) | k(a)==0]: one
    matmul of the 0/1 termination flags against the static ancestor
    matrix.  It runs in float64, which no reduced-precision matmul
    setting touches; every product is 0 or 1 and every sum at most the
    tree depth, so it is exact.  The costs and their node sums take
    XLA:CPU's forms (see the module docstring)."""
    del k
    m = y.shape[0]
    dev = y.device
    w1 = k1_cdf.shape[1]
    tg = _tree_tensors(n_tree, w1, dev)
    ya = y.abs().long()
    lane = torch.arange(n, device=dev)[None, :]
    ya = torch.where(lane < n_tree, ya, 0)
    zcol = torch.zeros((m, 1), dtype=torch.int64, device=dev)
    csum = torch.cat([zcol, ya.cumsum(-1)], -1)
    # Weighted prefix sums give each k==1 span's pulse position in O(1).
    wsum = torch.cat([zcol, (ya * lane).cumsum(-1)], -1)
    base, size = tg["base"], tg["size"]
    k_node = csum[:, base + size] - csum[:, base]          # (m, NN)
    term = ((k_node == 1) & (size <= 16)[None, :]) | (k_node == 0)
    blocked = (term.double() @ tg["anc"]) > 0.5
    inner = (size > 1)[None, :]
    active = (~blocked) & (k_node > 0) & inner
    is_k1 = active & (k_node == 1) & (size <= 16)[None, :]
    # k == 1 leaf: position coded from pvq_k1_cdf[k1_ctx].
    pos = (wsum[:, base + size] - wsum[:, base]) - base[None, :]
    pos = torch.minimum(pos.clamp_min(0), (size - 1)[None, :])
    flat1 = k1_cdf.reshape(-1)
    last1 = flat1.shape[0] - 1
    rowoff = (tg["k1_id"] * w1)[None, :]
    tot1 = flat1[tg["tot1"]][None, :].float()
    # JAX clamps gather indices into range; these only reach past the
    # table on nodes that is_k1 masks out.
    hi1 = flat1[(rowoff + pos).clamp_max(last1)].float()
    lo1 = torch.where(pos > 0,
                      flat1[(rowoff + (pos - 1).clamp_min(0))
                            .clamp_max(last1)], 0).float()
    cost_k1 = _fma32(-xla_log((hi1 - lo1).clamp_min(1.0)), _LOG2E,
                     (xla_log(tot1.clamp_min(1.0)) * _LOG2E))
    # Split node: count_right from pvq_split_cdf[fctx] + raw bits.
    is_split = active & ~is_k1
    count_right = csum[:, base + size] - csum[:, base + tg["mid"]]
    shift = (_ilog(k_node) - 3).clamp_min(0)
    msbs = count_right >> shift
    t_red = k_node >> shift
    fctx = (7 * tg["sz_ctx"][None, :] + t_red - 1) \
        .clamp(0, split_cdf.shape[0] - 1)
    w2 = split_cdf.shape[1]
    flat2 = split_cdf.reshape(-1)
    roff2 = fctx * w2
    tot2 = flat2[roff2 + t_red.clamp_max(w2 - 1)].float()
    hi2 = flat2[roff2 + msbs.clamp_max(w2 - 1)].float()
    lo2 = torch.where(msbs > 0,
                      flat2[roff2 + (msbs - 1).clamp(0, w2 - 1)],
                      0).float()
    cost_sp = _fma32(xla_log(tot2.clamp_min(1.0)), _LOG2E,
                     -(xla_log((hi2 - lo2).clamp_min(1.0))
                       * _LOG2E)) + shift.float()
    return (node_sum(torch.where(is_k1, cost_k1, 0.0))
            + node_sum(torch.where(is_split, cost_sp, 0.0)))


def _fast_rate(y, k, n_eff, n):
    """The reference's speed>0 rate model (od_pvq_rate,
    src/pvq_encoder.c:253-262), without the theta terms the caller
    adds; its lane sum in XLA:CPU's order and its logs XLA's.  Only
    band_search without CDF tables takes it (search_frame always passes
    them)."""
    ya = y.abs().float()
    j = torch.arange(n, dtype=torch.float32, device=y.device)[None, :]
    total = ordered_sum(torch.where(j < n_eff, j * ya, 0.0))
    kf = k.float().clamp_min(1.0)
    f = total / (kf * n)
    lg = xla_log(n * 2.0 * (f + 0.025)).clamp_min(0.0)
    rate = (1.0 + 0.4 * f) * n * (xla_log(
        1.0 + lg * kf / torch.full((), n, dtype=torch.float32,
                                   device=kf.device)) * _LOG2E) + 3.0
    return torch.where(k == 0, 0.0, rate)


def _select(best_cost, cost, cost_y, ok, isnr):
    """JAX's scan over the candidates, in order: the best cost starts at
    the initial candidate's (index -1, best_cost), and candidate c
    replaces it when ok and its cost is below it (theta: `<`) or not
    above it (noref: `<=`); a NaN never compares true.  Returns (win,
    win_y) per row: the last candidate to replace the best, and the last
    whose cost_y passes the same test against the best cost before it.
    XLA computes `better` once a carried output, each fusion with its
    own rounding of the cost: the inter scan's fusion that carries the
    pulses rounds lam rate before adding it (cost_y), every other
    fusion contracts it (cost).  cost/cost_y/ok/isnr: (C, m)."""
    b = best_cost
    win = torch.full_like(best_cost, -1, dtype=torch.int64)
    win_y = win
    for c in range(cost.shape[0]):
        nr = isnr[c]
        take_y = ok[c] & torch.where(nr, cost_y[c] <= b, cost_y[c] < b)
        take = ok[c] & torch.where(nr, cost[c] <= b, cost[c] < b)
        win_y = torch.where(take_y, c, win_y)
        win = torch.where(take, c, win)
        b = torch.where(take, cost[c], b)
    return win, win_y


def _take(a, win):
    """a (C, m, ...) at the winners (m,) (clamped; -1 rows are the
    caller's to mask)."""
    w = win.clamp_min(0)
    idx = w.view((1, -1) + (1,) * (a.dim() - 2)).expand((1,) + a.shape[1:])
    return a.gather(0, idx)[0]


def _floor_i(v):
    """float32 -> int64 through floor, with XLA's NaN -> 0."""
    return torch.floor(torch.nan_to_num(v, nan=0.0)).long()


# ---------------------------------------------------------------------------
# The plain versions.
# ---------------------------------------------------------------------------


def band_prologue_plain(dflat, mdflat, base, tabsel, tab, qmtab, q0,
                        beta15, lam, n, is_keyframe):
    """Everything of band_search before its pulse search.  Returns (xs
    (G m, n) float32, lane_ok (G m, n) bool, src (C m,) int32, cf (5, C,
    m) float32 = [g2, sinp, dth, qcgf, trate], ci (6, C, m) int32 = [i,
    j, ok, k, ts, kk], rf (3, m) float32 = [cgf, skip_dist, dist0]), C =
    14 inter or 2 keyframe candidates.  xs holds the rows the pulse
    search reads, once each: inter (G = 2) the reflected rows that the
    12 theta candidates search over their first n - 1 lanes, then the
    x16 rows of the 2 noref candidates; keyframe (G = 1) the x16 rows.
    Candidate c of row r searches row src[c m + r] of xs; kk is k where
    the candidate is ok, else 0 (the pulse search's target), g2 its
    distortion scale."""
    dev = dflat.device
    idx = base.long()[:, None] + tab.long()[tabsel.long()]
    inb = (idx >= 0) & (idx < dflat.shape[0])
    idx = idx.clamp(0, max(dflat.shape[0] - 1, 0))
    Xl = torch.where(inb, dflat[idx], 0).long()
    qml = qmtab.long()[tabsel.long()]
    q0 = q0.long()
    beta15 = beta15.bool()
    m = Xl.shape[0]
    rows = torch.arange(m, device=dev)
    inv_cs2 = _INV_CS2
    lamf = float(np.float32(lam))
    # vector_log_mag (src/pvq.c:470-484)
    tx = Xl >> 8
    xs_tot = (tx * tx).sum(-1)
    xshift = (8 + 1 + torch.div(_ilog(n + xs_tot), 2, rounding_mode="floor")
              - 15).clamp_min(0)
    x16 = _vshr_round(Xl * qml, P.OD_QM_SHIFT + xshift[:, None])
    cg, g = _compute_gain(x16, q0, beta15, xshift)
    cgf = cg.float()
    x16_f = x16.float()
    if not is_keyframe:
        Rl = torch.where(inb, mdflat[idx], 0).long()
        tr = Rl >> 8
        rs_tot = (tr * tr).sum(-1)
        rshift = (8 + 1 + torch.div(_ilog(n + rs_tot), 2,
                                    rounding_mode="floor") - 14).clamp_min(0)
        r16 = _vshr_round(Rl * qml, P.OD_QM_SHIFT + rshift[:, None])
        corr_i = (x16 * r16).sum(-1)
        cgr, gr = _compute_gain(r16, q0, beta15, rshift)
        icgr = _shr_round(cgr, P.OD_CGAIN_SHIFT)
        gain_offset = cgr - _shl32(icgr, P.OD_CGAIN_SHIFT)
        cgrf = cgr.float()
        # XLA: (corr_i 2^s) / (g gr) for corr_i / (1e-100 + g gr / 2^s).
        corr = (corr_i.float()
                * _shl32(torch.ones_like(g), xshift + rshift).float()) \
            / (g.float() * gr.float())
        corr = corr.clamp(-1.0, 1.0)
        t_corr = 2.0 - 2.0 * corr
        # skip_dist (inter branch of pvq_theta).
        d = cgf - cgrf
        skip_dist = _fma32(t_corr, cgrf * cgf,
                           _GAIN_WEIGHT * (d * d)) * inv_cs2
    else:
        # Keyframe skip codes zeros: the plain gain energy.
        skip_dist = _GAIN_WEIGHT * cgf * cgf * inv_cs2
    # Initial candidate: qg=0 noref zero-vector.
    best_dist = _GAIN_WEIGHT * cgf * cgf * inv_cs2
    if not is_keyframe:
        # Initial candidate 2 (inter): reference-gain, theta=0 (qg=0
        # coded).  For icgr != 0 the host keeps the zero-vector
        # distortion from candidate 1 (pvq_theta only overwrites it in
        # the icgr == 0 branch).
        scgr = gain_offset.float().clamp_min(0.0)
        d = cgf - scgr
        best_dist = torch.where(
            icgr == 0,
            _fma32(t_corr, scgr * cgf, _GAIN_WEIGHT * (d * d)) * inv_cs2,
            best_dist)
    dist0 = best_dist

    gb_nr = cg >> P.OD_CGAIN_SHIFT
    # Candidate parameters on a leading candidate axis: 3 gains x 4
    # thetas (inter), then 2 noref gains.
    cand = []   # (i, j, ok, k, ts, g2, sinp, qth), each (c, m)
    if not is_keyframe:
        theta_on = Rl.ne(0).any(-1) & (corr > 0.0)
        # Householder reflection of r16.
        mpos = r16.abs().argmax(-1)
        rm = r16.gather(1, mpos[:, None])[:, 0]
        s = torch.where(rm > 0, 1, -1)
        bump = _shr_round(gr * s, rshift)
        r16_refl = r16.index_put((rows, mpos), _wrap16(rm + bump))
        xr_full = _apply_householder(x16, r16_refl)
        # Delete index mpos: xr[j] = xr_full[j + (j >= mpos)], j < n-1.
        jj = torch.arange(n, device=dev)[None, :]
        gidx = jj + (jj >= mpos[:, None]).long()
        xr = xr_full.gather(1, gidx.clamp_max(n - 1))
        theta_q = _floor_i(_fma32(acos_xla(corr), _THETA_C, 0.5))
        gain_bound = (cg - gain_offset) >> P.OD_CGAIN_SHIFT
        i_base = (gain_bound - 1).clamp_min(1)
        # xr lane n-1 is padding for the (n-1)-dim sub-search; excluded
        # from the pulse search via its lane mask.
        xr_f = xr.float()
        xr_f[:, n - 1] = 0.0
        noref_on = (corr < 0.5) | (cg < _shl32(torch.full_like(cg, 2),
                                               P.OD_CGAIN_SHIFT))
        # 3 gains (axis 0) x 4 thetas (axis 1), flattened gain-major.
        i3 = _wrap32(i_base[None, :] + torch.arange(3, device=dev)[:, None])
        gain_ok = i3 <= gain_bound + 1
        qcg3 = _shl32(i3, P.OD_CGAIN_SHIFT) + gain_offset
        ts3 = _compute_max_theta(qcg3, beta15)
        tq_s = theta_q.float() * _TQ_SCALE
        tpos = tq_s * ts3.float()
        # XLA contracts 0.5 + tpos, except where tpos is also t_upper's.
        t_lower = (_floor_i(_fma32(tq_s, ts3.float(), 0.5)) - 2).clamp_min(0)
        t_lower_ok = (_floor_i(0.5 + tpos) - 2).clamp_min(0)
        t_upper = torch.minimum(ts3 - 1, torch.ceil(tpos).long())
        four = torch.arange(4, device=dev)[None, :, None]
        rep = lambda a: a[:, None, :].expand(3, 4, m).reshape(12, m)
        i_t, qcg_t, ts_t = rep(i3), rep(qcg3), rep(ts3)
        qcgf_t = qcg_t.float()
        dq = qcgf_t - cgf
        sq_t = dq * dq

        def theta_terms(j):
            qth = _wrap32(_compute_theta(j, ts_t))
            k = _compute_k(qcg_t, j, False, n, beta15)
            dth = 2.0 - 2.0 * _pvq_cos(theta_q - qth).float() \
                / P.OD_TRIG_SCALE
            return qth, k, dth

        j = (t_lower[:, None, :] + four).reshape(12, m)
        qth_t, k_t, dth_t = theta_terms(j)
        # `ok`, as XLA computes it in its own fusion, from t_lower_ok.
        j_ok = (t_lower_ok[:, None, :] + four).reshape(12, m)
        _, k_ok, dth_ok = theta_terms(j_ok)
        dist_pre = _fma32(sq_t, _GW32, (qcgf_t * cgf * dth_ok)) \
            * inv_cs2
        ok_t = (theta_on & rep(gain_ok) & (j_ok <= rep(t_upper))
                & (j_ok >= 0)
                & ~((dist_pre > dist0 + lamf) & (k_ok != 0)))
        sin_prod = (_pvq_sin(theta_q).float() / P.OD_TRIG_SCALE) \
            * (_pvq_sin(qth_t).float() / P.OD_TRIG_SCALE)
        cand.append((i_t, j, ok_t, k_t, ts_t,
                     qcgf_t * cgf * sin_prod * inv_cs2, sin_prod, qth_t))
    else:
        # Keyframe luma always searches the noref branch (pvq_theta:
        # `(is_keyframe && pli == 0) || corr < 0.5 || ...`).
        noref_on = torch.ones(m, dtype=torch.bool, device=dev)
        theta_q = torch.zeros(m, dtype=torch.int64, device=dev)
        icgr = torch.zeros(m, dtype=torch.int64, device=dev)
        gain_offset = torch.zeros(m, dtype=torch.int64, device=dev)
    i_n = _wrap32(gb_nr.clamp_min(1)[None, :]
                  + torch.arange(2, device=dev)[:, None])
    gain_ok = i_n <= gb_nr + 1
    qcg_n = _shl32(i_n, P.OD_CGAIN_SHIFT)
    k_n = _compute_k(qcg_n, None, True, n, beta15)
    qcgf_n = qcg_n.float()
    dq = qcgf_n - cgf
    dist_pre = _GAIN_WEIGHT * (dq * dq) * inv_cs2
    ok_n = noref_on & gain_ok & ~((dist_pre > dist0) & (k_n != 0))
    zi = torch.zeros_like(i_n)
    cand.append((i_n, torch.full_like(i_n, -1), ok_n, k_n, zi,
                 qcgf_n * cgf * inv_cs2, torch.zeros_like(qcgf_n), zi))
    c_i, c_j, c_ok, c_k, c_ts, c_g2, c_sinp, c_qth = (
        torch.cat(parts) for parts in zip(*cand))
    C = c_i.shape[0]
    isnr = (torch.arange(C, device=dev) >= C - 2)[:, None]
    trate = _fma32(xla_log(c_ts.float().clamp_min(1.0)), _TRATE_C,
                   -torch.where(c_i == icgr[None, :], 0.5, 0.0))
    dth = (2.0 - 2.0 * _pvq_cos(theta_q[None, :] - c_qth).float()
           / P.OD_TRIG_SCALE)
    qcgf = torch.where(isnr, _shl32(c_i, P.OD_CGAIN_SHIFT),
                       _shl32(c_i, P.OD_CGAIN_SHIFT)
                       + gain_offset[None, :]).float()
    # The pulse search's rows, once each: theta candidates search the
    # reflected xr over its first n-1 lanes, noref candidates x16.
    G = 1 if is_keyframe else 2
    xs = x16_f if is_keyframe else torch.cat([xr_f, x16_f])
    lane_ok = torch.ones((G, m, n), dtype=torch.bool, device=dev)
    lane_ok[:G - 1, :, n - 1] = False
    src = (torch.where(isnr, (G - 1) * m, 0) + rows[None, :]) \
        .to(torch.int32).reshape(C * m)
    kk = torch.where(c_ok, c_k, 0)
    cf = torch.stack([c_g2, c_sinp, dth, qcgf, trate])
    ci = torch.stack([c_i, c_j, c_ok.long(), c_k, c_ts, kk]) \
        .to(torch.int32)
    rf = torch.stack([cgf, skip_dist, dist0])
    return xs, lane_ok.view(G * m, n), src, cf, ci, rf


def band_epilogue_plain(y_c, cos_dist, ok_p, cf, ci, rf, lam, n,
                        k1_cdf, split_cdf, is_keyframe):
    """Everything of band_search after its pulse search: y_c (C m, n)
    int32, cos_dist (C m,) float32 and ok_p (C m,) bool are the pulse
    search's result on the prologue's rows; cf, ci, rf the prologue's.
    Returns band_search's (ints (m, 6) int32, y (m, n) int16, skip_diff
    (m,) float32)."""
    C, m = ci.shape[1:]
    g2, sinp, dth, qcgf, trate = cf
    c_i, c_j, c_ok, c_k, c_ts = ci[:5].long()
    c_ok = c_ok.bool()
    cgf, skip_dist, dist0 = rf
    dev = y_c.device
    isnr = (torch.arange(C, device=dev) >= C - 2)[:, None]
    y_c = y_c.view(C, m, n)
    cos_dist = cos_dist.view(C, m)
    valid = ~(c_ok & ~ok_p.view(C, m)).any(0)
    t = 2.0 - 2.0 * cos_dist
    dq = qcgf - cgf
    sq = dq * dq
    qc = qcgf * cgf
    t = torch.where(isnr, t, _fma32(sinp, t, dth))
    dist = _fma32(sq, _GW32, qc * t) * _INV_CS2
    # XLA's keyframe fusion that keeps the best distortion contracts the
    # other product (the cost's fusion contracts the weight's, as the
    # inter frame's do).
    dist_kept = _fma32(t, qc, _GAIN_WEIGHT * sq) * _INV_CS2 if is_keyframe \
        else dist
    # The noref candidates are the last 2 (rate over n lanes); the theta
    # candidates before them code n-1 lanes.
    nt = C - 2
    if k1_cdf is not None:
        rate_parts = []
        if nt:
            rate_parts.append(_codeword_rate(
                y_c[:nt].reshape(nt * m, n), None, n - 1, n, k1_cdf,
                split_cdf).view(nt, m))
        rate_parts.append(_codeword_rate(
            y_c[nt:].reshape(2 * m, n), None, n, n, k1_cdf,
            split_cdf).view(2, m))
        rate = torch.cat(rate_parts)
    else:
        n_eff = torch.where(isnr, n, n - 1).expand(C, m).reshape(-1, 1)
        rate = _fast_rate(y_c.reshape(C * m, n), c_k.reshape(-1), n_eff,
                          n).view(C, m)
    rate = rate + torch.where(isnr, 0.0, trate)
    lam32 = float(np.float32(lam))
    cost = _fma32(rate, lam32, dist)
    cost_y = cost if is_keyframe else dist + rate * lam32
    win, win_y = _select(dist0, cost, cost_y, c_ok, isnr.expand(C, m))
    sel = win >= 0
    best_dist = torch.where(sel, _take(dist_kept, win), dist0)
    noref = torch.where(sel, _take(isnr.expand(C, m), win).long(),
                        1 if is_keyframe else 0)
    best_qg = torch.where(sel, _take(c_i, win), 0)
    best_itheta = torch.where(sel, _take(c_j, win), -1 if is_keyframe else 0)
    best_ts = torch.where(sel, _take(c_ts, win), 0)
    best_k = torch.where(sel, _take(c_k, win), 0)
    best_y = torch.where((win_y >= 0)[:, None], _take(y_c, win_y), 0)
    skip_diff = skip_dist - best_dist
    # int16 pulse transport: |y[i]| <= k, so one bound check keeps the
    # packing exact (the host searches the impossible overflow itself).
    valid = valid & (best_k <= 32767)
    ints = torch.stack([noref, best_qg, best_itheta, best_ts, best_k,
                        valid.long()], -1).to(torch.int32)
    return ints, best_y.to(torch.int16), skip_diff
