"""PVQ math core: gain companding, theta quantization, Householder
reflection, and synthesis.

Bit-exact port of the normative fixed-point math (reference: src/pvq.c,
src/pvq.h).  Scalar quantities (gains, angles, pulse counts) use exact
Python integer arithmetic; vector quantities (reflection, synthesis) use
numpy int arrays.  The shapes here are per-band; the batched TPU encoder
vmaps/bucketizes over all bands of a frame (see daala_tpu/codec/).

Fixed-point formats (reference: src/pvq.h:55-105):
  gains: Q(OD_CGAIN_SHIFT)=Q8 companded; raw gain Q(bshift)
  theta: Q15 scaled by 2/pi (OD_THETA_SCALE)
  trig:  Q15 (OD_TRIG_SCALE)
  beta:  Q(OD_BETA_SHIFT)=Q12

A frozen copy of the port's ops/pvq.py, for the benchmark's plain
reference.
"""

from __future__ import annotations

import numpy as np

from codecbench.reference import tables as T
from codecbench.reference.intrin import OD_COEFF_SHIFT

# --- constants (reference: src/pvq.h) --------------------------------------
OD_CGAIN_SHIFT = 8
OD_CGAIN_SCALE = 1 << OD_CGAIN_SHIFT
OD_THETA_SHIFT = 15
OD_MAX_THETA_SCALE = 1 << OD_THETA_SHIFT
OD_TRIG_SCALE = 32768
OD_BETA_SHIFT = 12
OD_COMPAND_SHIFT = 8 + OD_COEFF_SHIFT
OD_COMPAND_SCALE = 1 << OD_COMPAND_SHIFT
OD_QM_SHIFT = 11
OD_QM_SCALE = 1 << OD_QM_SHIFT
OD_QM_SCALE_MAX = 32767
OD_QM_INV_SHIFT = 12
OD_QM_INV_SCALE = 1 << OD_QM_INV_SHIFT
OD_NBSIZES = 5
OD_NPLANES_MAX = 4
PVQ_MAX_PARTITIONS = 9
MAXN = 64 * 64 // 2
OD_PVQ_LAMBDA = 0.147


def beta_q12(value: float) -> int:
    """OD_BETA(b) = OD_QCONST32(b, OD_BETA_SHIFT)."""
    return int(0.5 + value * (1 << OD_BETA_SHIFT))


BETA_1 = beta_q12(1.0)
BETA_1_5 = beta_q12(1.5)


def _ilog(x: int) -> int:
    return int(x).bit_length()


def shr_round(x: int, shift: int) -> int:
    return (x + (1 << shift >> 1)) >> shift


def vshr(x: int, shift: int) -> int:
    return x >> shift if shift > 0 else _shl32(x, -shift)


def vshr_round(x: int, shift: int) -> int:
    return shr_round(x, shift) if shift > 0 else _shl32(x, -shift)


def _shl32(a: int, shift: int) -> int:
    """OD_SHL: 32-bit wrapping left shift."""
    v = (int(a) << shift) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def mult16_16_q15(a: int, b: int) -> int:
    return (a * b) >> 15


def mult16_16_q16(a: int, b: int) -> int:
    return (a * b) >> 16


def mult16_32_q16(a, b):
    return (a * b) >> 16


def mult16_32_qbeta(a: int, b: int) -> int:
    return (a * b) >> OD_BETA_SHIFT


# --- Q15 trig (reference: src/pvq.c:417-467) -------------------------------

def _cos_pi_2(x: int) -> int:
    x2 = mult16_16_q15(x, x)
    return min(32767, (1073758164 - x * x + x2 *
                       (-7654 + mult16_16_q16(x2, 16573 +
                                              mult16_16_q16(-2529, x2))))
               >> 15)


def pvq_cos(x: int) -> int:
    """od_pvq_cos: cos of a Q15*2/pi angle (reference: src/pvq.c:429-456)."""
    x = x & 0x0001FFFF
    if x > (1 << 16):
        x = (1 << 17) - x
    if x & 0x00007FFF:
        if x < (1 << 15):
            return _cos_pi_2(x)
        return -_cos_pi_2(65536 - x)
    if x & 0x0000FFFF:
        return 0
    if x & 0x0001FFFF:
        return -32767
    return 32767


def pvq_sin(x: int) -> int:
    """od_pvq_sin (reference: src/pvq.c:461-467)."""
    return pvq_cos(32768 - x)


# --- reciprocal / sqrt / pow approximations (reference: src/pvq.c) ---------

OD_RCP_INSHIFT = 15
OD_RCP_OUTSHIFT = 14


def _wrap16(v):
    """od_val16 assignment semantics: wrap to int16 (the reference's
    fixed-point vectors are int16; values at the boundary -- e.g.
    l2r_norm == 32768 -- wrap, and the wrapped results are normative)."""
    return ((v + 32768) & 65535) - 32768


def _ilog_c(x: int) -> int:
    """OD_ILOG via count-leading-zeros: for negative 32-bit inputs the
    reference's CLZ sees the sign bit and yields 32 (reference:
    src/odintrin.h:236-241)."""
    if x < 0:
        return 32
    return _ilog(x)


def od_rcp(x: int) -> int:
    """Fixed-point reciprocal (reference: src/pvq.c:504-528).  All
    od_val16 intermediates wrap to int16 like the reference's."""
    i = _ilog_c(x) - 1
    n = _wrap16(vshr_round(x, i - OD_RCP_INSHIFT) - (1 << OD_RCP_INSHIFT))
    r = _wrap16(30840 + mult16_16_q15(-15420, n))
    r = _wrap16(r - mult16_16_q15(r, mult16_16_q15(r, n) + r - 32768))
    r = _wrap16(r - (1 + mult16_16_q15(r, mult16_16_q15(r, n) + r
                                       - 32768)))
    return _wrap16(vshr_round(r, i - OD_RCP_OUTSHIFT))


OD_RSQRT_INSHIFT = 16
OD_RSQRT_OUTSHIFT = 14


def _rsqrt_norm(t: int) -> int:
    """Reference: src/pvq.c:965-996."""
    n = t - 32768
    r = 23565 + mult16_16_q15(n, -13481 + mult16_16_q15(n, 6711))
    r2 = r * r
    y = (((r2 >> 15) * n + r2) >> 12) - 131077
    ry = r * y
    return r + ((((ry >> 16) * (3 * y) >> 3) - ry) >> 18)


def od_rsqrt(x: int):
    """Returns (rsqrt_norm, shift) (reference: src/pvq.c:998-1014)."""
    k = (_ilog(x) - 1) >> 1
    s = 2 * k - (OD_RSQRT_INSHIFT - 2)
    t = vshr(x, s)
    shift = OD_RSQRT_OUTSHIFT + ((s + OD_RSQRT_INSHIFT) >> 1)
    return _rsqrt_norm(t), shift


OD_SQRT_INSHIFT = 16
OD_SQRT_OUTSHIFT = 15


def _sqrt_norm(x: int) -> int:
    return min(shr_round(x * _rsqrt_norm(x), OD_SQRT_OUTSHIFT), 32767)


def od_sqrt(x: int):
    """Returns (sqrt_norm, shift) (reference: src/pvq.c:737-757)."""
    if x == 0:
        return 0, 0
    k = (_ilog(x) - 1) >> 1
    s = 2 * k - (OD_SQRT_INSHIFT - 2)
    t = vshr(x, s)
    shift = OD_SQRT_OUTSHIFT - ((s + OD_SQRT_INSHIFT) >> 1)
    return _sqrt_norm(t), shift


OD_EXP2_INSHIFT = 15
OD_EXP2_FRACSHIFT = 15
OD_EXP2_OUTSHIFT = 15
_EXP2_C = (32768, 22709, 7913, 1704, 443)


def od_exp2(x: int) -> int:
    """Base-2 exponential, Q15 in/out (reference: src/pvq.c:648-668)."""
    integer = x >> OD_EXP2_INSHIFT
    if integer > 14:
        return 0x7F000000
    if integer < -15:
        return 0
    xf = x - _shl32(integer, OD_EXP2_INSHIFT)
    frac = mult16_16_q15(xf, _EXP2_C[1] + mult16_16_q15(xf, _EXP2_C[2] +
                         mult16_16_q15(xf, _EXP2_C[3] +
                                       mult16_16_q15(xf, _EXP2_C[4]))))
    return vshr_round(_EXP2_C[0] + frac, -integer) + 1


OD_LOG2_INSHIFT = 15
OD_LOG2_OUTSHIFT = 15
OD_LOG2_OUTSCALE = 1 << OD_LOG2_OUTSHIFT


def od_log2(x: int) -> int:
    """Reference: src/pvq.c:675-679."""
    return x + mult16_16_q15(x, 14482 + mult16_16_q15(x, -23234 +
                             mult16_16_q15(x, 13643 +
                             mult16_16_q15(x, -6403 +
                                           mult16_16_q15(x, 1515)))))


def od_pow(x: int, beta: int) -> int:
    """x**beta via log2/exp2 (reference: src/pvq.c:681-700)."""
    if x == 0:
        return 0
    log2_x = _ilog(x) - 1
    xshift = log2_x - OD_LOG2_INSHIFT
    t = vshr(x, xshift) - (1 << OD_LOG2_INSHIFT)
    logr = od_log2(t) + (log2_x - OD_COMPAND_SHIFT) * OD_LOG2_OUTSCALE
    logr = mult16_32_qbeta(beta, logr)
    return od_exp2(logr)


def beta_rcp(beta: int) -> int:
    """1/beta in Q12 (reference: src/pvq.c:626-637)."""
    if beta == BETA_1:
        return BETA_1
    if beta == BETA_1_5:
        return beta_q12(1.0 / 1.5)
    rcp_b = od_rcp(beta << (OD_RCP_INSHIFT - 1 - OD_BETA_SHIFT))
    return shr_round(rcp_b, OD_RCP_OUTSHIFT + 1 - OD_BETA_SHIFT)


# --- gain companding (reference: src/pvq.c:702-813) ------------------------

def gain_compand(g: int, q0: int, beta: int) -> int:
    """g^(1/beta), normalized by q0, Q(OD_CGAIN_SHIFT) out."""
    if beta == BETA_1:
        return (OD_CGAIN_SCALE * g + (q0 >> 1)) // q0
    expr = od_pow(g, beta_rcp(beta))
    expr <<= OD_CGAIN_SHIFT + OD_COMPAND_SHIFT - OD_EXP2_OUTSHIFT
    return (expr + (q0 >> 1)) // q0


def gain_expand(cg0: int, q0: int, beta: int) -> int:
    """cg^beta (reference: src/pvq.c:764-813)."""
    if beta == BETA_1:
        return shr_round(cg0 * q0, OD_CGAIN_SHIFT)
    if beta == BETA_1_5:
        irt, sqrt_outshift = od_sqrt(cg0 * q0)
        sqrt_inshift = (OD_CGAIN_SHIFT + OD_COMPAND_SHIFT) >> 1
        tmp = cg0 * q0 * irt
        return vshr_round(tmp, OD_CGAIN_SHIFT + sqrt_outshift + sqrt_inshift)
    cg = shr_round(cg0 * q0, OD_CGAIN_SHIFT)
    expr = od_pow(cg, beta)
    return shr_round(expr, OD_EXP2_OUTSHIFT - OD_COMPAND_SHIFT)


def compute_gain(x, q0: int, beta: int, bshift: int):
    """Raw + companded gain of int16 vector x (reference:
    src/pvq.c:815-853).  Returns (qcg, g)."""
    acc = int(np.sum(np.asarray(x, np.int64) ** 2))
    irt, sqrt_shift = od_sqrt(acc)
    g = vshr_round(irt, sqrt_shift - bshift)
    return gain_compand(g, q0, beta), g


def compute_max_theta(qcg: int, beta: int) -> int:
    """Reference: src/pvq.c:855-870."""
    qconst_pi_2 = int(0.5 + (np.pi / 2) * (1 << OD_CGAIN_SHIFT))
    ts = shr_round(qcg * mult16_32_qbeta(beta_rcp(beta), qconst_pi_2),
                   OD_CGAIN_SHIFT * 2)
    if qcg < int(0.5 + 1.4 * (1 << OD_CGAIN_SHIFT)):
        ts = 1
    return ts


def compute_theta(t: int, max_theta: int) -> int:
    """Reference: src/pvq.c:872-886."""
    if max_theta != 0:
        return (OD_MAX_THETA_SCALE * min(t, max_theta - 1)
                + (max_theta >> 1)) // max_theta
    return 0


_SQRT_TABLE = ((0, 0, 0, 0, 2290, 2985, 4222, 0, 8256, 0, 16416, 0, 32767),
               (0, 0, 0, 0, 2401, 3072, 4284, 0, 8287, 0, 16432, 0, 32767))
OD_SQRT_TBL_SHIFT = 10
OD_ITHETA_SHIFT = 15


def compute_k(qcg: int, itheta: int, noref: bool, n: int, beta: int) -> int:
    """Number of PVQ pulses (reference: src/pvq.c:893-962).

    Uses the nodesync=1 paths (the robust-stream mode Daala uses for
    keyframes; reference: src/encode.c:1352-1354 always sets nodesync)."""
    if noref:
        if qcg == 0:
            return 0
        if n == 15 and qcg == OD_CGAIN_SCALE and beta > beta_q12(1.25):
            return 1
        rt = _SQRT_TABLE[1][_ilog(n + 1)]
        return max(1, shr_round(
            (qcg - int(0.5 + 0.2 * (1 << OD_CGAIN_SHIFT))) *
            mult16_32_qbeta(beta_rcp(beta), rt),
            OD_CGAIN_SHIFT + OD_SQRT_TBL_SHIFT))
    else:
        if itheta == 0:
            return 0
        rt = _SQRT_TABLE[0][_ilog(n + 1)]
        return max(1, vshr_round(
            (_shl32(itheta, OD_ITHETA_SHIFT) -
             int(0.5 + 0.2 * (1 << OD_ITHETA_SHIFT))) * rt,
            OD_SQRT_TBL_SHIFT + OD_ITHETA_SHIFT))


# --- Householder reflection (reference: src/pvq.c:490-623) -----------------

def compute_householder(r: np.ndarray, gr: int, shift: int):
    """Build the reflection vector in-place; returns (m, sign)
    (reference: src/pvq.c:490-523).  r entries are od_val16."""
    m = int(np.argmax(np.abs(r)))
    s = 1 if r[m] > 0 else -1
    r[m] = _wrap16(int(r[m]) + shr_round(gr * s, shift))
    return m, s


def apply_householder(x: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Reflect x by r (reference: src/pvq.c:559-623).  int16-range in/out."""
    r = np.asarray(r, np.int64)
    x = np.asarray(x, np.int64)
    l2r = int(np.sum(r * r))
    proj = int(np.sum(r * x))
    l2r_shift = (_ilog(l2r) - 1) - 14
    # l2r_norm / proj_norm / proj_1 are od_val16 in the reference: they
    # wrap to int16 (l2r_norm can round to exactly 32768 -> -32768, and
    # the wrapped value is what od_rcp normatively sees).
    l2r_norm = _wrap16(vshr_round(l2r, l2r_shift))
    rcp = od_rcp(l2r_norm)
    proj_shift = (_ilog(abs(proj)) - 1) - 14
    proj_norm = _wrap16(vshr_round(proj, proj_shift))
    proj_1 = _wrap16(mult16_16_q15(proj_norm, rcp))
    outshift = min(30, OD_RCP_OUTSHIFT - proj_shift - 1 + l2r_shift)
    if outshift >= 0:
        tmp = r * proj_1
        tmp = (tmp + (1 << outshift >> 1)) >> outshift
    else:
        tmp = np.array([_shl32(int(v), -outshift) for v in (r * proj_1)],
                       np.int64)
    # The output vector is od_val16 in the reference.
    return ((x - tmp + 32768) & 65535) - 32768


# --- synthesis (reference: src/pvq.c:1016-1116) ----------------------------

def synthesis_partial(ypulse, r16, n: int, noref: bool, g: int, theta: int,
                      m: int, s: int, qm_inv) -> np.ndarray:
    """od_pvq_synthesis_partial: rebuild coefficients from pulses.

    ypulse has n entries when noref, n-1 otherwise.  qm_inv is the
    coding-order inverse QM slice for this band.  Returns int32 coeffs."""
    # g == 0 only occurs on corrupt streams; the math below degrades to
    # a zero scale like the reference (whose OD_ASSERT compiles out).
    ypulse = np.asarray(ypulse, np.int64)
    nn = n - (0 if noref else 1)
    yy = int(np.sum(ypulse[:nn] * ypulse[:nn]))
    gshift = max(0, _ilog(g) - 14)
    if yy == 0:
        scale = 0
    else:
        rsqrt, rsqrt_shift = od_rsqrt(yy)
        tmp = rsqrt * g
        scale = vshr_round(tmp, rsqrt_shift + gshift - 16)
    qshift = OD_QM_INV_SHIFT - gshift
    qm_inv = np.asarray(qm_inv, np.int64)
    if noref:
        x = (ypulse[:n] * scale) >> 16
        return shr_round_arr(x * qm_inv[:n], qshift).astype(np.int32)
    else:
        sintheta = pvq_sin(theta)
        costheta = pvq_cos(theta)
        # The reference promotes to double here (OD_TRIG_SCALE_1 is a double
        # constant); keep the same operation order for bit-exactness
        # (reference: src/pvq.c:1091,1096).
        scale_s = int(np.floor(0.5 + scale * (1.0 / OD_TRIG_SCALE)
                               * sintheta))
        # x is an od_val16 vector in the reference (int16 wrap).
        x = np.empty(n, np.int64)
        x[:m] = (ypulse[:m] * scale_s) >> 16
        x[m] = int(np.floor(0.5 + (-s * shr_round(g, gshift))
                            * (1.0 / OD_TRIG_SCALE) * costheta))
        x[m + 1:n] = (ypulse[m:nn] * scale_s) >> 16
        x = ((x + 32768) & 65535) - 32768
        x = apply_householder(x, r16)
        return shr_round_arr(x * qm_inv[:n], qshift).astype(np.int32)


def shr_round_arr(x, shift: int):
    return (x + (1 << shift >> 1)) >> shift


# --- contexts and QM helpers (reference: src/pvq.c:383-415) ----------------

def size_ctx(n: int) -> int:
    logn = _ilog(n - 1)
    odd = n & 1
    return 2 * logn - 1 - odd - 7 * (n == 14)


def k1_ctx(n: int, orig_length: bool) -> int:
    if orig_length:
        return 8 + 2 * (n > 8) + (n & 1)
    return size_ctx(n)


def qm_get_index(bs: int, band: int) -> int:
    return bs * (bs + 1) + band - band // 3


def qm_offset(bs: int, xydec: int) -> int:
    off = (((1 << 2 * bs) - 1) << 4) // 3
    stride = (((1 << 2 * OD_NBSIZES) - 1) << 4) // 3
    return xydec * stride + off


QM_STRIDE = (((1 << 2 * OD_NBSIZES) - 1) << 4) // 3
QM_BUFFER_SIZE = 2 * QM_STRIDE


_INIT_QM_CACHE: dict = {}


def init_qm(qm_q4: np.ndarray):
    """Build magnitude-compensated QM and inverse in coding order
    (reference: src/pvq.c:322-380).  qm_q4: flat 8x8 base matrix (64,).

    Returns (qm, qm_inv) int16 arrays of length QM_BUFFER_SIZE.
    Vectorized + memoized on the base matrix: the interpolated QMs
    repeat across keyframes, and the scalar build cost ~30 ms per
    keyframe in both codecs at 1080p."""
    from codecbench.reference import partition
    qarr = np.asarray(qm_q4, np.int64).reshape(-1)
    key = qarr.tobytes()
    hit = _INIT_QM_CACHE.get(key)
    if hit is not None:
        return hit[0].copy(), hit[1].copy()
    x = np.zeros(QM_BUFFER_SIZE, np.int16)
    x_inv = np.zeros(QM_BUFFER_SIZE, np.int16)
    mags = {0: [T.BASIS_MAG4, T.BASIS_MAG8, T.BASIS_MAG16, T.BASIS_MAG32,
                T.BASIS_MAG64],
            1: [T.BASIS_MAG4_CHROMA_420, T.BASIS_MAG8_CHROMA_420,
                T.BASIS_MAG16_CHROMA_420, T.BASIS_MAG32_CHROMA_420,
                T.BASIS_MAG64_CHROMA_420]}
    for bs in range(OD_NBSIZES):
        n = 4 << bs
        idx = (np.arange(n) << 1) >> bs
        for xydec in range(2):
            off = qm_offset(bs, xydec)
            basis = np.asarray(mags[xydec][bs], np.float64)
            # ((SCALE * basis[i]) * basis[j]) preserves the scalar
            # loop's left-associated float rounding.
            mag = np.floor(0.5 + (OD_QM_SCALE * basis)[:, None]
                           * basis[None, :]).astype(np.int64)
            qmv = qarr[(idx[:, None] * 8 + idx[None, :])]
            y = (mag * 16 + (qmv >> 1)) // qmv
            y[0, 0] = OD_QM_SCALE
            np.minimum(y, OD_QM_SCALE_MAX, out=y)
            y_inv = (OD_QM_SCALE * OD_QM_INV_SCALE + (y >> 1)) // y
            co = partition.coding_order_indices(n)
            x[off:off + len(co)] = y.reshape(-1)[co]
            x_inv[off:off + len(co)] = y_inv.reshape(-1)[co]
    _INIT_QM_CACHE[key] = (x, x_inv)
    return x.copy(), x_inv.copy()


# --- the PVQ QM a frame is searched with (reference: src/encode.c) ---------

OD_QM_SIZE = OD_NBSIZES * (OD_NBSIZES + 1)


def quality_to_quantizer(quality: int) -> int:
    """Reference: src/rate.c:717-725 (quality in Q4 units via CLI <<4)."""
    if quality <= 0:
        return quality
    return (quality << OD_COEFF_SHIFT >> 4) + (1 << OD_COEFF_SHIFT >> 1)


def interp_qm(q, use_masking, pli):
    """od_interp_qm for one plane (reference: src/encode.c:2903-2941)."""
    import math
    luma = T.LUMA_QM_Q4[1 if use_masking else 0]
    chroma = T.CHROMA_QM_Q4[1 if use_masking else 0]
    qm_q4 = luma if pli == 0 else chroma
    anchors = [(4, (256, 448, 320)), (318, (256, 140, 100))]
    scale1 = anchors[0][1][min(pli, 2)]
    scale2 = anchors[1][1][min(pli, 2)]
    q1 = anchors[0][0] << OD_COEFF_SHIFT
    q2 = anchors[1][0] << OD_COEFF_SHIFT
    out = [0] * OD_QM_SIZE
    if q <= q1:
        for i in range(OD_QM_SIZE):
            out[i] = min(255, int(qm_q4[i]) * scale1 >> 8)
    elif q > q2:
        for i in range(OD_QM_SIZE):
            out[i] = min(255, int(qm_q4[i]) * scale2 >> 8)
    else:
        x = (math.log(q) - math.log(q1)) / (math.log(q2) - math.log(q1))
        for i in range(OD_QM_SIZE):
            out[i] = min(255, int(math.floor(0.5 + (1.0 / 256) * math.exp(
                x * math.log(int(qm_q4[i]) * scale2)
                + (1 - x) * math.log(int(qm_q4[i]) * scale1)))))
    return out


def stated_qm(quant, hvs, use_masking, nplanes):
    """(qm, pvq_qm_q4) of a constant-quality encode at the encoder's
    `quant`: od_init_qm of the HVS or flat 8x8 base (reference:
    src/decode.c:1155-1160), and each plane's interpolated PVQ QM at
    the keyframe's base quantizer (src/encode.c:3052-3079)."""
    qm, _ = init_qm(T.QM8_Q4_HVS if hvs else T.QM8_Q4_FLAT)
    q = quality_to_quantizer((quant << 4) - 8 if quant > 0 else 0)
    return qm, np.array([interp_qm(q, use_masking, pli)
                         for pli in range(nplanes)], np.int64)
