"""PVQ coefficient coding: codeword coder, encoder search, and the
band-level encode/decode drivers.

Mirrors the reference semantics exactly (reference: src/pvq_encoder.c,
src/pvq_decoder.c, src/laplace_encoder.c:38-80).  The encoder-side search
(pvq_theta) is non-normative but reproduced faithfully so that our
bitstreams match the reference encoder's on identical inputs, giving a
strong equivalence test; the decode path is normative.

Vector math uses numpy; model state lives in daala_tpu.entropy.adapt.

The port's copy of daala_tpu/codec/pvq_codec.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import math

import numpy as np

from daala_tpu_torch.entropy import ec as ec_mod
from daala_tpu_torch.entropy.adapt import (
    OD_ADAPT_COUNT_EX_Q8, OD_ADAPT_COUNT_Q8, OD_ADAPT_K_Q8,
    OD_ADAPT_SUM_EX_Q8, PVQ_MAX_PARTITIONS, cost_cdf_adapt,
    decode_cdf_adapt, encode_cdf_adapt)
from daala_tpu_torch.ops import partition as part
from daala_tpu_torch.ops import pvq as P

OD_NBSIZES = 5
OD_MAX_PVQ_SIZE = 128
OD_PVQ_SKIP_ZERO = 1
OD_PVQ_SKIP_COPY = 2
OD_CFL_FLIP_SHIFT = 4  # OD_LIMIT_BSIZE_MAX (reference: src/pvq_encoder.c:42)


# ---------------------------------------------------------------------------
# PVQ codeword coder (recursive binary splitting of the pulse counts).
# Reference: src/laplace_encoder.c:38-80, src/laplace_decoder.c:43-91.
# ---------------------------------------------------------------------------

def _encode_pvq_split(enc, cw_ctx, count, total, ctx):
    if total == 0:
        return
    shift = max(0, total.bit_length() - 3)
    rest = 0
    if shift:
        rest = count & ((1 << shift) - 1)
        count >>= shift
        total >>= shift
    fctx = 7 * ctx + total - 1
    encode_cdf_adapt(enc, count, cw_ctx.pvq_split_cdf[fctx], total + 1,
                     cw_ctx.pvq_split_increment)
    if shift:
        enc.encode_bits(rest, shift)


def _decode_pvq_split(dec, cw_ctx, total, ctx):
    if total == 0:
        return 0
    shift = max(0, total.bit_length() - 3)
    fctx = 7 * ctx + (total >> shift) - 1
    msbs = decode_cdf_adapt(dec, cw_ctx.pvq_split_cdf[fctx],
                            (total >> shift) + 1,
                            cw_ctx.pvq_split_increment)
    count = 0
    if shift:
        count = dec.decode_bits(shift)
    count += msbs << shift
    if count > total:
        count = total
        dec.error = 1
    return count


def encode_band_pvq_splits(enc, cw_ctx, y, n, k, level, base=0):
    """od_encode_band_pvq_splits (reference: src/laplace_encoder.c:56-80).
    Operates on y[base:base+n] in place (index bounds, not slices)."""
    if n <= 1 or k == 0:
        return
    if k == 1 and n <= 16:
        cdf_id = P.k1_ctx(n, level == 0)
        pos = 0
        while not y[base + pos]:
            pos += 1
        encode_cdf_adapt(enc, pos, cw_ctx.pvq_k1_cdf[cdf_id], n,
                         cw_ctx.pvq_k1_increment)
    else:
        mid = n >> 1
        count_right = k
        for i in range(mid):
            count_right -= abs(int(y[base + i]))
        _encode_pvq_split(enc, cw_ctx, count_right, k, P.size_ctx(n))
        encode_band_pvq_splits(enc, cw_ctx, y, mid, k - count_right,
                               level + 1, base)
        encode_band_pvq_splits(enc, cw_ctx, y, n - mid, count_right,
                               level + 1, base + mid)


def decode_band_pvq_splits(dec, cw_ctx, y, n, k, level, base=0):
    """od_decode_band_pvq_splits (reference: src/laplace_decoder.c:64-91).
    Writes into y[base:base+n] in place."""
    if n == 1:
        y[base] = k
    elif k == 0:
        for i in range(n):
            y[base + i] = 0
    elif k == 1 and n <= 16:
        cdf_id = P.k1_ctx(n, level == 0)
        for i in range(n):
            y[base + i] = 0
        pos = decode_cdf_adapt(dec, cw_ctx.pvq_k1_cdf[cdf_id], n,
                               cw_ctx.pvq_k1_increment)
        y[base + pos] = 1
    else:
        mid = n >> 1
        count_right = _decode_pvq_split(dec, cw_ctx, k, P.size_ctx(n))
        decode_band_pvq_splits(dec, cw_ctx, y, mid, k - count_right,
                               level + 1, base)
        decode_band_pvq_splits(dec, cw_ctx, y, n - mid, count_right,
                               level + 1, base + mid)


try:
    import ctypes as _ct
    from daala_tpu_torch import native as _native
    _NLIB = _native.get_lib()
    _I32P = _ct.POINTER(_ct.c_int32)
except Exception:  # pragma: no cover
    _NLIB = None


_F64P = _ct.POINTER(_ct.c_double) if _NLIB is not None else None


def _nptr(arr):
    return arr.ctypes.data


def encode_pvq_codeword(enc, cw_ctx, y, n, k):
    """Reference: src/pvq_encoder.c:44-49."""
    if _NLIB is not None and hasattr(enc, "_h"):
        ya = np.ascontiguousarray(y[:n], np.int32)
        _NLIB.ec_pvq_codeword_encode(
            enc._h, _nptr(ya), n, k, _nptr(cw_ctx.pvq_k1_cdf),
            _nptr(cw_ctx.pvq_split_cdf), cw_ctx.pvq_k1_increment,
            cw_ctx.pvq_split_increment)
        return
    encode_band_pvq_splits(enc, cw_ctx, y, n, k, 0)
    for i in range(n):
        if y[i]:
            enc.encode_bits(1 if y[i] < 0 else 0, 1)


def decode_pvq_codeword(dec, cw_ctx, n, k):
    """Reference: src/pvq_decoder.c:38-45."""
    if (_NLIB is not None and hasattr(dec, "_h")
            and not getattr(dec, "_accounting", False)):
        ya = np.zeros(n, np.int32)
        _NLIB.ec_pvq_codeword_decode(
            dec._h, _nptr(ya), n, k, _nptr(cw_ctx.pvq_k1_cdf),
            _nptr(cw_ctx.pvq_split_cdf), cw_ctx.pvq_k1_increment,
            cw_ctx.pvq_split_increment)
        return ya.tolist()
    y = [0] * n
    decode_band_pvq_splits(dec, cw_ctx, y, n, k, 0)
    for i in range(n):
        if y[i] and dec.decode_bits(1):
            y[i] = -y[i]
    return y


# ---------------------------------------------------------------------------
# Gain interleaving (reference: src/pvq_encoder.c:229-241,
# src/pvq_decoder.c:48-60).
# ---------------------------------------------------------------------------

def neg_interleave(x, ref):
    if x < ref:
        return -2 * (x - ref) - 1
    if x < 2 * ref:
        return 2 * (x - ref)
    return x - 1


def neg_deinterleave(x, ref):
    if x < 2 * ref - 1:
        if x & 1:
            return ref - 1 - (x >> 1)
        return ref + (x >> 1)
    return x + 1


def vector_log_mag(x, n):
    """od_vector_log_mag (reference: src/pvq.c:470-484).

    Upper bound on the bits in the L2 norm; int16/int32 casts in the
    reference cannot overflow for in-range coefficients."""
    total = 0
    for i in range(n):
        tmp = int(x[i]) >> 8
        total += tmp * tmp
    return 8 + 1 + (n + total).bit_length() // 2


def rdo_quant(x, q, delta0, pvq_norm_lambda):
    """od_rdo_quant (reference: src/pvq_encoder.c:723-737)."""
    threshold = 128 + min(max(0, int(256 * pvq_norm_lambda * delta0 / 2)),
                          128)
    if abs(x) < q * threshold // 256:
        return 0
    # OD_DIV_R0: round-to-zero-biased division toward nearest? (reference:
    # src/odintrin.h:123: (x + flipsign((y+1)/2 - 1, x))/y -> round to
    # nearest, ties away from zero... careful: (y+1)>>1 - 1.
    return div_r0(x, q)


def div_r0(x, y):
    """OD_DIV_R0: nearest integer division with ties rounded toward zero
    (reference: src/odintrin.h:123)."""
    off = ((y + 1) >> 1) - 1
    num = x + (-off if x < 0 else off)
    q = abs(num) // y
    return -q if num < 0 else q


# ---------------------------------------------------------------------------
# Encoder-side PVQ search (reference: src/pvq_encoder.c:79-225, 333-636).
# ---------------------------------------------------------------------------

_RSQRT_TABLE = [1.000000, 0.707107, 0.577350, 0.500000,
                0.447214, 0.408248, 0.377964, 0.353553,
                0.333333, 0.316228, 0.301511, 0.288675,
                0.277350, 0.267261, 0.258199, 0.250000]
_RSQRT_ARR = np.array(_RSQRT_TABLE, np.float64)


def _rsqrt_tab(i):
    if i <= 16:
        return _RSQRT_TABLE[i - 1]
    return 1.0 / math.sqrt(i)


def pvq_search_rdo_double(xcoeff, n, k, ypulse, g2, pvq_norm_lambda, prev_k):
    """Reference: src/pvq_encoder.c:93-227.  ypulse is modified in place
    (list of ints); returns the cosine distance.

    Production path: one native call running the scalar search in the
    reference's exact floating-point operation order
    (daala_tpu/native/ec_core.cc).  The numpy fallback vectorizes each
    greedy pulse placement over all n candidate positions."""
    if _NLIB is not None:
        xa = np.ascontiguousarray(xcoeff[:n], np.float64)
        ya = np.ascontiguousarray(ypulse[:n], np.int32)
        cd = _NLIB.ec_pvq_search_rdo_double(
            xa.ctypes.data, n, k, ya.ctypes.data, float(g2),
            float(pvq_norm_lambda), int(prev_k))
        ypulse[:n] = ya.tolist()
        return cd
    xc = np.asarray(xcoeff[:n], np.float64)
    x = np.abs(xc)
    xx = float(x @ x)
    xy = 0.0
    yy = 0.0
    norm_1 = 1.0 / math.sqrt(1e-30 + xx)
    lam = pvq_norm_lambda / (1e-30 + g2)
    i = 0
    if 0 < prev_k <= k:
        yp = np.abs(np.asarray(ypulse[:n], np.int64))
        xy = float(x @ yp)
        yy = float(yp @ yp)
        i = int(yp.sum())
    elif k > 2:
        l1_norm = float(x.sum())
        yp = np.floor(k * x * (1.0 / max(l1_norm, 1e-100)))
        yp = np.maximum(yp, 0.0).astype(np.int64)
        xy = float(x @ yp)
        yy = float(yp @ yp)
        i = int(yp.sum())
    else:
        yp = np.zeros(n, np.int64)
    rdo_pulses = 1 + k // 4
    delta_rate = 3.0 / n
    accel_rate = 0.0
    if k == 1:
        if n == 15:
            accel_rate = -8.0 / n
            delta_rate = 4.5 / n - accel_rate
        elif n == 8:
            accel_rate = 5.7 / n
            delta_rate = 9.3 / n - accel_rate
    jidx = np.arange(n, dtype=np.float64)
    while i < k - rdo_pulses:
        txy = xy + x
        txy = txy * txy
        tyy = yy + 2.0 * yp + 1.0
        pos = int(np.argmax(txy / tyy))
        xy += float(x[pos])
        yy += 2 * int(yp[pos]) + 1
        yp[pos] += 1
        i += 1
    rate_pen = lam * jidx * (delta_rate + jidx * accel_rate)
    while i < k:
        idx = int(yy) + 2 * yp + 1
        small = idx <= 16
        tyy_r = np.where(
            small, _RSQRT_ARR[np.minimum(idx, 16) - 1],
            1.0 / np.sqrt(np.maximum(idx, 1).astype(np.float64)))
        cost = 2.0 * (xy + x) * norm_1 * tyy_r - rate_pen
        pos = int(np.argmax(cost))
        xy += float(x[pos])
        yy += 2 * int(yp[pos]) + 1
        yp[pos] += 1
        i += 1
    out = np.where(xc < 0, -yp, yp)
    ypulse[:n] = out.tolist()
    return xy / (1e-100 + math.sqrt(xx * yy))


def _pvq_theta_forced(out, x0, r0, n, q0, y, beta, is_keyframe, pli,
                      qm, qm_inv, forced):
    """Replay a device band decision through pvq_theta's exact
    normative tail (reference: src/pvq_encoder.c:594-636): skip
    determination, synthesis, and gain-coding transform.  The stream
    is fully determined by the decision; only the search was
    approximate."""
    noref, qg, itheta, max_theta, k, yvec, skip_diff_delta = forced
    noref = bool(noref)
    xshift = max(0, vector_log_mag(x0, n) - 15)
    rshift = max(0, vector_log_mag(r0, n) - 14)
    r0a = np.asarray(r0[:n], np.int64)
    qma = np.asarray(qm[:n], np.int64)
    r16 = P.shr_round_arr(r0a * qma, P.OD_QM_SHIFT + rshift)
    cgr, gr = P.compute_gain(r16, q0, beta, rshift)
    cfl_enabled = is_keyframe and pli != 0
    if cfl_enabled:
        cgr = P.OD_CGAIN_SCALE
    icgr = P.shr_round(cgr, P.OD_CGAIN_SHIFT)
    gain_offset = cgr - P._shl32(icgr, P.OD_CGAIN_SHIFT)
    m = 0
    s = 1
    r16_refl = r16.copy()
    best_qtheta = 0
    if not noref:
        m, s = P.compute_householder(r16_refl, gr, rshift)
        if itheta >= 0 and max_theta > 0:
            best_qtheta = P.compute_theta(itheta, max_theta)
    for i in range(n):
        y[i] = 0
    lim = n if noref else n - 1
    for i in range(lim):
        y[i] = int(yvec[i])
    theta = best_qtheta
    skip = 0
    if noref:
        if qg == 0:
            skip = OD_PVQ_SKIP_ZERO
    else:
        if not is_keyframe and qg == 0:
            skip = OD_PVQ_SKIP_ZERO if icgr else OD_PVQ_SKIP_COPY
        if qg == icgr and itheta == 0 and not cfl_enabled:
            skip = OD_PVQ_SKIP_COPY
    if skip:
        if skip == OD_PVQ_SKIP_COPY:
            for i in range(n):
                out[i] = int(r0[i])
        else:
            for i in range(n):
                out[i] = 0
    else:
        if noref:
            gain_offset = 0
        g_syn = P.gain_expand(P._shl32(qg, P.OD_CGAIN_SHIFT)
                              + gain_offset, q0, beta)
        xc = P.synthesis_partial(np.asarray(y[:n], np.int64), r16_refl,
                                 n, noref, g_syn, theta, m, s, qm_inv)
        for i in range(n):
            out[i] = int(xc[i])
    if is_keyframe:
        qg_coded = qg if noref else neg_interleave(qg, icgr)
    else:
        qg_coded = qg - 1 if noref else neg_interleave(qg + 1, icgr + 1)
    return qg_coded, itheta, max_theta, k, skip_diff_delta


def pvq_rate(qg, icgr, theta, ts, adapt, y0, k, n, is_keyframe, pli, speed):
    """od_pvq_rate (reference: src/pvq_encoder.c:247-287)."""
    if k == 0:
        rate = 0.0
    elif speed > 0:
        lim = n - (1 if theta != -1 else 0)
        ya = np.abs(np.asarray(y0[:lim], np.int64))
        total = int(np.arange(lim) @ ya)
        f = total / float(k * n)
        rate = (1 + 0.4 * f) * n * math.log2(
            1 + max(0.0, math.log(n * 2 * (1 * f + 0.025)) * k / n)) + 3
    else:
        # Exact rate: run the codeword coder into a scratch encoder with a
        # cloned adaptation context (reference: src/pvq_encoder.c:268-277).
        lim = n - (1 if theta != -1 else 0)
        cw = adapt.pvq.pvq_codeword_ctx
        if _NLIB is not None:
            # Single native call: scratch coder + scratch CDF copies live
            # entirely in C (daala_tpu/native/ec_core.cc).
            ya = np.ascontiguousarray(y0[:lim], np.int32)
            rate = _NLIB.ec_pvq_codeword_rate_q3(
                _nptr(ya), lim, k, _nptr(cw.pvq_k1_cdf),
                _nptr(cw.pvq_split_cdf), cw.pvq_k1_increment,
                cw.pvq_split_increment) / 8.0
        else:
            from daala_tpu_torch.entropy.adapt import PvqCodewordCtx
            enc = ec_mod.Encoder()
            cd = PvqCodewordCtx()
            cd.restore(cw.snapshot())
            tell = enc.tell_frac()
            encode_pvq_codeword(enc, cd, y0, lim, k)
            rate = (enc.tell_frac() - tell) / 8.0
    if qg > 0 and theta >= 0:
        rate += 0.9 * math.log2(ts)
        if is_keyframe and pli == 0:
            rate += 6
        if qg == icgr:
            rate -= 0.5
    return rate


def pvq_theta(out, x0, r0, n, q0, y, beta, nodesync, is_keyframe, pli,
              adapt, qm, qm_inv, pvq_norm_lambda, speed, forced=None):
    """The per-band PVQ search (reference: src/pvq_encoder.c:333-636).

    out, y: int lists/arrays modified in place (length n).
    Returns (qg_coded, itheta, max_theta, k, skip_diff_delta).

    Production path: the entire band search runs as one native call
    (ec_pvq_theta in daala_tpu/native/ec_core.cc, differentially fuzzed
    against this Python implementation).

    forced: optional device decision (noref, qg, itheta, max_theta, k,
    yvec, skip_diff) from models/pvqsearch.py band_search — skips the
    search and replays the exact normative tail (skip logic +
    synthesis) so the coded stream is fully determined by the
    decision."""
    if forced is not None:
        return _pvq_theta_forced(out, x0, r0, n, q0, y, beta,
                                 is_keyframe, pli, qm, qm_inv, forced)
    if _NLIB is not None:
        cw = adapt.pvq.pvq_codeword_ctx
        out_c = np.zeros(n, np.int32)
        y_c = np.zeros(n, np.int32)
        x0a = np.ascontiguousarray(x0[:n], np.int32)
        r0a = np.ascontiguousarray(r0[:n], np.int32)
        qma = np.ascontiguousarray(qm[:n], np.int32)
        qmia = np.ascontiguousarray(qm_inv[:n], np.int32)
        resi = np.zeros(4, np.int32)
        sdd = _ct.c_double()
        _NLIB.ec_pvq_theta(
            out_c.ctypes.data, x0a.ctypes.data, r0a.ctypes.data, n,
            int(q0), y_c.ctypes.data, int(beta), int(is_keyframe),
            int(pli), qma.ctypes.data, qmia.ctypes.data,
            float(pvq_norm_lambda), int(speed),
            cw.pvq_k1_cdf.ctypes.data, cw.pvq_split_cdf.ctypes.data,
            cw.pvq_k1_increment, cw.pvq_split_increment,
            resi.ctypes.data, _ct.byref(sdd))
        out[:n] = out_c.tolist()
        y[:n] = y_c.tolist()
        return (int(resi[0]), int(resi[1]), int(resi[2]), int(resi[3]),
                sdd.value)
    gain_weight = 1.4
    assert n > 1
    xshift = max(0, vector_log_mag(x0, n) - 15)
    rshift = max(0, vector_log_mag(r0, n) - 14)
    x0a = np.asarray(x0[:n], np.int64)
    r0a = np.asarray(r0[:n], np.int64)
    qma = np.asarray(qm[:n], np.int64)
    x16 = P.shr_round_arr(x0a * qma, P.OD_QM_SHIFT + xshift)
    r16 = P.shr_round_arr(r0a * qma, P.OD_QM_SHIFT + rshift)
    corr = int(x16 @ r16)
    cfl_enabled = is_keyframe and pli != 0
    cg, g = P.compute_gain(x16, q0, beta, xshift)
    cgr, gr = P.compute_gain(r16, q0, beta, rshift)
    if cfl_enabled:
        cgr = P.OD_CGAIN_SCALE
    icgr = P.shr_round(cgr, P.OD_CGAIN_SHIFT)
    gain_offset = cgr - P._shl32(icgr, P.OD_CGAIN_SHIFT)
    qg = 0
    dist = gain_weight * cg * cg * (1.0 / (P.OD_CGAIN_SCALE ** 2))
    best_dist = dist
    best_cost = dist + pvq_norm_lambda * pvq_rate(
        0, 0, -1, 0, adapt, None, 0, n, is_keyframe, pli, speed)
    noref = True
    best_k = 0
    itheta = -1
    max_theta = 0
    for i in range(n):
        y[i] = 0
    best_qtheta = 0
    m = 0
    s = 1
    corr = corr / (1e-100 + g * float(gr) / P._shl32(1, xshift + rshift))
    corr = max(min(corr, 1.0), -1.0)
    if is_keyframe:
        skip_dist = gain_weight * cg * cg * (1.0 / (P.OD_CGAIN_SCALE ** 2))
    else:
        skip_dist = (gain_weight * (cg - cgr) * (cg - cgr)
                     + cgr * float(cg) * (2 - 2 * corr))
        skip_dist *= 1.0 / (P.OD_CGAIN_SCALE ** 2)
    if not is_keyframe:
        scgr = max(0.0, gain_offset)
        if icgr == 0:
            best_dist = (gain_weight * (cg - scgr) * (cg - scgr)
                         + scgr * float(cg) * (2 - 2 * corr))
            best_dist *= 1.0 / (P.OD_CGAIN_SCALE ** 2)
        best_cost = best_dist + pvq_norm_lambda * pvq_rate(
            0, icgr, 0, 0, adapt, None, 0, n, is_keyframe, pli, speed)
        best_qtheta = 0
        itheta = 0
        max_theta = 0
        noref = False
    dist0 = best_dist
    r16_refl = r16.copy()
    if n <= OD_MAX_PVQ_SIZE and np.any(np.asarray(r0[:n]) != 0) and corr > 0:
        theta = int(np.floor(0.5 + P.OD_MAX_THETA_SCALE * 2 / np.pi
                             * math.acos(corr)))
        m, s = P.compute_householder(r16_refl, gr, rshift)
        xr_full = P.apply_householder(x16, r16_refl)
        xr = np.empty(n - 1, np.int64)
        xr[:m] = xr_full[:m]
        xr[m:n - 1] = xr_full[m + 1:n]
        prev_k = 0
        gain_bound = (cg - gain_offset) >> P.OD_CGAIN_SHIFT
        items = []
        if speed >= 2:
            # Fast trial mode: the 2x2 neighborhood at and just below
            # the projection (the step the RD tradeoff usually
            # prefers); the full set is searched only by the final
            # pass.
            i0 = max(1, P.shr_round(cg - gain_offset, P.OD_CGAIN_SHIFT))
            gain_range = range(max(1, i0 - 1), i0 + 1)
        else:
            gain_range = range(max(1, gain_bound - 1), gain_bound + 2)
        for i in gain_range:
            qcg = P._shl32(i, P.OD_CGAIN_SHIFT) + gain_offset
            ts = P.compute_max_theta(qcg, beta)
            # OD_THETA_SCALE_1 = pi/(2*32768); theta*SCALE_1*2/pi*ts
            # simplifies to theta*ts/32768 but keep the C operation order
            # (reference: src/pvq_encoder.c:478-481).
            theta_scale_1 = 1.0 / ((1 << 15) * 2.0 / math.pi)
            theta_lower = max(0, int(math.floor(
                0.5 + theta * theta_scale_1 * 2 / math.pi * ts)) - 2)
            theta_upper = min(ts - 1, int(math.ceil(
                theta * theta_scale_1 * 2 / math.pi * ts)))
            if speed >= 2:
                j0 = min(ts - 1, max(0, int(math.floor(
                    0.5 + theta * theta_scale_1 * 2 / math.pi * ts))))
                theta_lower = max(0, j0 - 1)
                theta_upper = j0
            for j in range(theta_lower, theta_upper + 1):
                qtheta = P.compute_theta(j, ts)
                k = P.compute_k(qcg, j, False, n, beta)
                items.append((k, i, j, qcg, qtheta, ts))
        # Sort by K with gain tie-break (reference: items_compare).
        items.sort(key=lambda it: (it[0], it[1]))
        y_tmp = [0] * n
        cos_dist = 0.0
        prev_k = 0
        for (k, i, j, qcg, qtheta, ts) in items:
            dist_theta = 2 - 2.0 * P.pvq_cos(theta - qtheta) \
                / P.OD_TRIG_SCALE
            dist = gain_weight * (qcg - cg) * (qcg - cg) \
                + qcg * float(cg) * dist_theta
            dist *= 1.0 / (P.OD_CGAIN_SCALE ** 2)
            if dist > dist0 + 1.0 * pvq_norm_lambda and k != 0:
                continue
            sin_prod = (P.pvq_sin(theta) / P.OD_TRIG_SCALE) \
                * (P.pvq_sin(qtheta) / P.OD_TRIG_SCALE)
            if k == 0:
                cos_dist = 0.0
                y_tmp[:n - 1] = [0] * (n - 1)
            elif k != prev_k:
                cos_dist = pvq_search_rdo_double(
                    xr, n - 1, k, y_tmp,
                    qcg * float(cg) * sin_prod / (P.OD_CGAIN_SCALE ** 2),
                    pvq_norm_lambda, prev_k)
            prev_k = k
            dist_theta = 2 - 2.0 * P.pvq_cos(theta - qtheta) \
                / P.OD_TRIG_SCALE + sin_prod * (2 - 2 * cos_dist)
            dist = gain_weight * (qcg - cg) * (qcg - cg) \
                + qcg * float(cg) * dist_theta
            dist *= 1.0 / (P.OD_CGAIN_SCALE ** 2)
            cost = dist + pvq_norm_lambda * pvq_rate(
                i, icgr, j, ts, adapt, y_tmp, k, n, is_keyframe, pli, speed)
            if cost < best_cost:
                best_cost = cost
                best_dist = dist
                qg = i
                best_k = k
                best_qtheta = qtheta
                itheta = j
                max_theta = ts
                noref = False
                y[:n - 1] = y_tmp[:n - 1]
    if n <= OD_MAX_PVQ_SIZE and (
            (is_keyframe and pli == 0) or corr < 0.5
            or cg < P._shl32(2, P.OD_CGAIN_SHIFT)):
        gain_bound = cg >> P.OD_CGAIN_SHIFT
        prev_k = 0
        y_tmp = [0] * n
        # speed >= 2 keeps the exact 2-candidate noref gain range — it
        # is already minimal.
        gain_range_nr = range(max(1, gain_bound), gain_bound + 2)
        for i in gain_range_nr:
            qcg = P._shl32(i, P.OD_CGAIN_SHIFT)
            k = P.compute_k(qcg, -1, True, n, beta)
            dist = gain_weight * (qcg - cg) * (qcg - cg)
            dist *= 1.0 / (P.OD_CGAIN_SCALE ** 2)
            if dist > dist0 and k != 0:
                continue
            cos_dist = pvq_search_rdo_double(
                x16, n, k, y_tmp,
                qcg * float(cg) / (P.OD_CGAIN_SCALE ** 2),
                pvq_norm_lambda, prev_k)
            prev_k = k
            dist = gain_weight * (qcg - cg) * (qcg - cg) \
                + qcg * float(cg) * (2 - 2 * cos_dist)
            dist *= 1.0 / (P.OD_CGAIN_SCALE ** 2)
            cost = dist + pvq_norm_lambda * pvq_rate(
                i, 0, -1, 0, adapt, y_tmp, k, n, is_keyframe, pli, speed)
            if cost <= best_cost:
                best_cost = cost
                best_dist = dist
                qg = i
                noref = True
                best_k = k
                itheta = -1
                max_theta = 0
                for ii in range(n):
                    y[ii] = y_tmp[ii]
    k = best_k
    theta = best_qtheta
    skip = 0
    if noref:
        if qg == 0:
            skip = OD_PVQ_SKIP_ZERO
    else:
        if not is_keyframe and qg == 0:
            skip = OD_PVQ_SKIP_ZERO if icgr else OD_PVQ_SKIP_COPY
        if qg == icgr and itheta == 0 and not cfl_enabled:
            skip = OD_PVQ_SKIP_COPY
    if skip:
        if skip == OD_PVQ_SKIP_COPY:
            for i in range(n):
                out[i] = int(r0[i])
        else:
            for i in range(n):
                out[i] = 0
    else:
        if noref:
            gain_offset = 0
        g = P.gain_expand(P._shl32(qg, P.OD_CGAIN_SHIFT) + gain_offset, q0,
                          beta)
        xc = P.synthesis_partial(np.asarray(y[:n], np.int64), r16_refl, n,
                                 noref, g, theta, m, s, qm_inv)
        for i in range(n):
            out[i] = int(xc[i])
    skip_diff_delta = skip_dist - best_dist
    if is_keyframe:
        qg_coded = qg if noref else neg_interleave(qg, icgr)
    else:
        qg_coded = qg - 1 if noref else neg_interleave(qg + 1, icgr + 1)
    return qg_coded, itheta, max_theta, k, skip_diff_delta


# ---------------------------------------------------------------------------
# Band-level entropy coding (reference: src/pvq_encoder.c:655-721,
# src/pvq_decoder.c:96-280).
# ---------------------------------------------------------------------------

# ---- cost-only trial coding (fast trial pass) -----------------------------
# Mirrors frame_enc.inc cost_cdf_q3 / cost_codeword_fit_q3: with
# trial_rate_approx the block-size RDO trial pass codes nothing — every
# symbol becomes an analytic -log2(p) against the FROZEN adaptation
# state, accumulated in a shared 1-element list (1/8-bit units, double).
# Terms are added to the accumulator one at a time in the same order as
# the C engine so the float sums match bit for bit.

def _cost_cdf_q3(cdf, val, n):
    prev = cdf[val - 1] if val > 0 else 0
    return -8.0 * math.log2((cdf[val] - prev) / cdf[n - 1])


def _cost_codeword_q3(adapt, y, n, has_theta, k):
    """Exact codeword rate, coded into a scratch range coder against
    the REAL codeword CDFs (which keep adapting) — mirrors the C cost
    branch in frame_enc.inc pvq_encode_partition.  A closed-form fit
    here biases the split decision: its constant per-band overhead
    makes the split hypothesis (4x the band count) look too
    expensive."""
    if k == 0:
        return 0.0
    lim = n - (1 if has_theta else 0)
    cw = adapt.pvq.pvq_codeword_ctx
    if _NLIB is not None:
        ya = np.ascontiguousarray(y[:lim], np.int32)
        return float(_NLIB.ec_pvq_codeword_cost_enc_q3(
            _nptr(ya), lim, k, _nptr(cw.pvq_k1_cdf),
            _nptr(cw.pvq_split_cdf), cw.pvq_k1_increment,
            cw.pvq_split_increment))
    enc = ec_mod.Encoder()
    tell = enc.tell_frac()
    encode_pvq_codeword(enc, cw, y, lim, k)
    return float(enc.tell_frac() - tell)


def pvq_encode_partition(enc, adapt, qg, theta, max_theta, y, n, k,
                         exg_ref, ext_ref, nodesync, cdf_ctx, is_keyframe,
                         code_skip, skip_rest, encode_flip, flip,
                         cost=None):
    """exg_ref/ext_ref: (container, index) for the expectation ints.
    cost: 1-element list accumulator — cost-only trial mode (mirrors
    frame_enc.inc pvq_encode_partition F.cost_only branch)."""
    model = adapt.pvq.pvq_param_model
    noref = theta == -1
    sym = (1 if qg > 0 else 0) + 2 * min(theta + 1, 3) \
        + 8 * code_skip * skip_rest
    if is_keyframe:
        assert sym != 8
        if sym >= 8:
            sym -= 1
    else:
        assert sym != 10
        if sym >= 10:
            sym -= 1
    if cost is not None:
        cost_cdf_adapt(cost, sym, adapt.pvq.pvq_gaintheta_cdf[cdf_ctx],
                       8 + 7 * code_skip,
                       adapt.pvq.pvq_gaintheta_increment)
        if encode_flip:
            cost[0] += 8.0
        if qg > 0:
            cont, idx = exg_ref
            tmp = cont[idx]
            c, _ = model[0 if noref else 1].cost_encode(
                qg - 1, -1, tmp, 2)
            cost[0] += 8.0 * c
            cont[idx] += ((qg << 16) - cont[idx]) >> 2
        if theta > 1 and (nodesync or max_theta > 3):
            cont, idx = ext_ref
            tmp = cont[idx]
            c, _ = model[2].cost_encode(
                theta - 2, -1 if nodesync else max_theta - 3, tmp, 2)
            cost[0] += 8.0 * c
            cont[idx] += ((theta << 16) - cont[idx]) >> 2
        cost[0] += _cost_codeword_q3(adapt, y, n, not noref, k)
        return
    encode_cdf_adapt(enc, sym, adapt.pvq.pvq_gaintheta_cdf[cdf_ctx],
                     8 + 7 * code_skip, adapt.pvq.pvq_gaintheta_increment)
    if encode_flip:
        enc.encode_bits(flip, 1)
    if qg > 0:
        cont, idx = exg_ref
        tmp = cont[idx]
        model[0 if noref else 1].encode(enc, qg - 1, -1, tmp, 2)
        cont[idx] += ((qg << 16) - cont[idx]) >> 2
    if theta > 1 and (nodesync or max_theta > 3):
        cont, idx = ext_ref
        tmp = cont[idx]
        model[2].encode(enc, theta - 2, -1 if nodesync else max_theta - 3,
                        tmp, 2)
        cont[idx] += ((theta << 16) - cont[idx]) >> 2
    encode_pvq_codeword(enc, adapt.pvq.pvq_codeword_ctx, y,
                        n - (0 if noref else 1), k)


def pvq_decode_partition(dec, q0, n, adapt, exg_ref, ext_ref, ref, out,
                         beta, nodesync, is_keyframe, pli, cdf_ctx, cfl,
                         has_skip, skip_rest, band, qm, qm_inv):
    """Returns (noref, skip) (reference: src/pvq_decoder.c:96-280).
    ref/out are numpy int64/int32 views of length n; cfl is a dict with
    'ref' (full block coding-order array view), 'nb_coeffs', 'allow_flip'."""
    model = adapt.pvq.pvq_param_model
    theta = 0
    gr = 0
    gain_offset = 0
    if skip_rest[(band + 2) % 3]:
        qg = 0
        if is_keyframe:
            itheta = -1
            noref = True
        else:
            itheta = 0
            noref = False
    else:
        sym = decode_cdf_adapt(dec, adapt.pvq.pvq_gaintheta_cdf[cdf_ctx],
                               8 + 7 * has_skip,
                               adapt.pvq.pvq_gaintheta_increment)
        if not is_keyframe and sym >= 10:
            sym += 1
        if is_keyframe and sym >= 8:
            sym += 1
        if sym >= 8:
            sym -= 8
            skip_rest[0] = skip_rest[1] = skip_rest[2] = 1
        qg = sym & 1
        itheta = (sym >> 1) - 1
        noref = itheta == -1
    if cfl["allow_flip"] and not noref:
        flip = dec.decode_bits(1)
        if flip:
            cref = cfl["ref"]
            cref[:cfl["nb_coeffs"]] = -cref[:cfl["nb_coeffs"]]
        cfl["allow_flip"] = False
    if qg > 0:
        cont, idx = exg_ref
        tmp = cont[idx]
        x, _ = model[0 if noref else 1].decode(dec, -1, tmp, 2)
        qg = 1 + x
        cont[idx] += ((qg << 16) - cont[idx]) >> 2
    skip = 0
    rshift = max(0, vector_log_mag(ref, n) - 14)
    ref16 = np.empty(n, np.int64)
    for i in range(n):
        ref16[i] = P.shr_round(int(ref[i]) * int(qm[i]),
                               P.OD_QM_SHIFT + rshift)
    if not noref:
        cfl_enabled = pli != 0 and is_keyframe
        cgr, gr = P.compute_gain(ref16, q0, beta, rshift)
        if cfl_enabled:
            cgr = P.OD_CGAIN_SCALE
        icgr = P.shr_round(cgr, P.OD_CGAIN_SHIFT)
        if is_keyframe:
            qg = neg_deinterleave(qg, icgr)
        else:
            qg = neg_deinterleave(qg, icgr + 1) - 1
            if qg == 0:
                skip = OD_PVQ_SKIP_ZERO if icgr else OD_PVQ_SKIP_COPY
        if qg == icgr and itheta == 0 and not cfl_enabled:
            skip = OD_PVQ_SKIP_COPY
        gain_offset = cgr - P._shl32(icgr, P.OD_CGAIN_SHIFT)
        qcg = P._shl32(qg, P.OD_CGAIN_SHIFT) + gain_offset
        max_theta = P.compute_max_theta(qcg, beta)
        if itheta > 1 and (nodesync or max_theta > 3):
            cont, idx = ext_ref
            tmp = cont[idx]
            x, _ = model[2].decode(dec, -1 if nodesync else max_theta - 3,
                                   tmp, 2)
            itheta = 2 + x
            cont[idx] += ((itheta << 16) - cont[idx]) >> 2
        theta = P.compute_theta(itheta, max_theta)
    else:
        itheta = 0
        if not is_keyframe:
            qg += 1
        qcg = P._shl32(qg, P.OD_CGAIN_SHIFT)
        if qg == 0:
            skip = OD_PVQ_SKIP_ZERO
    k = P.compute_k(qcg, itheta, noref, n, beta)
    if k != 0:
        y = decode_pvq_codeword(dec, adapt.pvq.pvq_codeword_ctx,
                                n - (0 if noref else 1), k)
    else:
        y = [0] * n
    if skip:
        if skip == OD_PVQ_SKIP_COPY:
            out[:n] = ref[:n]
        else:
            out[:n] = 0
    else:
        g = P.gain_expand(qcg, q0, beta)
        s = 0
        m = 0
        if not noref:
            m, s = P.compute_householder(ref16, gr, rshift)
        xc = P.synthesis_partial(np.asarray(y, np.int64), ref16, n, noref,
                                 g, theta, m, s, qm_inv)
        out[:n] = xc
    if skip:
        skip = 1
    return noref, skip


def pvq_encode_block(enc, adapt, encoder_ctx, ref, coeffs_in, out, q0, pli,
                     bs, beta, nodesync, is_keyframe, qm, qm_inv,
                     pvq_qm_q4, pvq_norm_lambda, speed, rollback_fns,
                     forced_bands=None):
    """od_pvq_encode (reference: src/pvq_encoder.c:792-1029).

    ref/coeffs_in/out: numpy int arrays in coding order (scan_length).
    rollback_fns: (checkpoint_fn, rollback_fn) capturing EC + adaptation.
    Returns 1 if both DC and AC are skipped.
    """
    offs = part.band_offsets(4 << bs)
    nb_bands = len(offs) - 1
    exg = adapt.pvq.pvq_exg[pli][bs]
    ext = adapt.pvq.pvq_ext
    ext_base = bs * PVQ_MAX_PARTITIONS
    skip_cdf = adapt.skip_cdf[2 * bs + (1 if pli != 0 else 0)]
    dc_quant = max(1, q0 * int(pvq_qm_q4[P.qm_get_index(bs, 0)]) >> 4)
    size = [int(offs[i + 1] - offs[i]) for i in range(nb_bands)]
    skip_diff = 0.0
    flip = 0
    if pli != 0 and is_keyframe:
        xy = 0
        for i in range(int(offs[0]), int(offs[1])):
            rq = int(ref[i]) * int(qm[i])
            inq = int(coeffs_in[i]) * int(qm[i])
            xy += (rq * inq) >> ((P.OD_QM_SHIFT + OD_CFL_FLIP_SHIFT) << 1)
        if xy < 0:
            flip = 1
            ref[int(offs[0]):int(offs[nb_bands])] = \
                -ref[int(offs[0]):int(offs[nb_bands])]
    qg = [0] * nb_bands
    theta = [0] * nb_bands
    max_theta = [0] * nb_bands
    k = [0] * nb_bands
    y = np.zeros(int(offs[nb_bands]), np.int64)
    for i in range(nb_bands):
        q = max(1, q0 * int(pvq_qm_q4[P.qm_get_index(bs, i + 1)]) >> 4)
        o0, o1 = int(offs[i]), int(offs[i + 1])
        yband = [0] * size[i]
        outband = [0] * size[i]
        qg[i], theta[i], max_theta[i], k[i], sd = pvq_theta(
            outband, coeffs_in[o0:o1], ref[o0:o1], size[i], q, yband,
            beta[i], nodesync, is_keyframe, pli, adapt, qm[o0:o1],
            qm_inv[o0:o1], pvq_norm_lambda, speed,
            forced=(forced_bands.get(i)
                    if forced_bands is not None else None))
        skip_diff += sd
        y[o0:o1] = yband
        out[o0:o1] = outband
    # Cost-only fast-trial mode (mirrors frame_enc.inc F.cost_only):
    # symbol rates are analytic but the adaptation checkpoint/rollback
    # discipline is identical to the exact path.
    cost = getattr(encoder_ctx, "_cost_q3", None)
    checkpoint_fn, rollback_fn = rollback_fns
    cp = checkpoint_fn()
    if is_keyframe:
        out[0] = 0
    else:
        dc_rate = -math.log2((skip_cdf[3] - skip_cdf[2])
                             / (skip_cdf[2] - skip_cdf[1]))
        out[0] = rdo_quant(int(coeffs_in[0]) - int(ref[0]), dc_quant,
                           dc_rate, pvq_norm_lambda)
    tell = cost[0] if cost is not None else enc.tell_frac()
    tell0_blk = tell
    if cost is not None:
        cost_cdf_adapt(cost, 2 + (1 if out[0] != 0 else 0), skip_cdf,
                       4 + (1 if pli == 0 and bs > 0 else 0),
                       adapt.skip_increment)
    else:
        encode_cdf_adapt(enc, 2 + (1 if out[0] != 0 else 0), skip_cdf,
                         4 + (1 if pli == 0 and bs > 0 else 0),
                         adapt.skip_increment)
    cfl_encoded = False
    skip_rest = 1
    skip_theta_value = -1 if is_keyframe else 0
    for i in range(1, nb_bands):
        if theta[i] != skip_theta_value or qg[i]:
            skip_rest = 0
    skip_dir = 0
    if nb_bands > 1:
        for i in range(3):
            tmp = 1
            for j in range(i + 1, nb_bands, 3):
                if theta[j] != skip_theta_value or qg[j]:
                    tmp = 0
            skip_dir |= tmp << i
    if theta[0] == skip_theta_value and qg[0] == 0 and skip_rest:
        nb_bands_coded = 0
    else:
        nb_bands_coded = nb_bands
    for i in range(nb_bands_coded):
        encode_flip = (pli != 0 and is_keyframe and theta[i] != -1
                       and not cfl_encoded)
        if i == 0 or (not skip_rest and not (skip_dir & (1 << ((i - 1) % 3)))):
            o0, o1 = int(offs[i]), int(offs[i + 1])
            pvq_encode_partition(
                enc, adapt, qg[i], theta[i], max_theta[i],
                [int(v) for v in y[o0:o1]], size[i], k[i],
                (exg, i), (ext, ext_base + i), nodesync,
                (1 if pli != 0 else 0) * OD_NBSIZES * PVQ_MAX_PARTITIONS
                + bs * PVQ_MAX_PARTITIONS + i,
                is_keyframe, 1 if (i == 0 and i < nb_bands - 1) else 0,
                skip_rest, encode_flip, flip, cost=cost)
        if i == 0 and not skip_rest and bs > 0:
            if cost is not None:
                cost_cdf_adapt(
                    cost, skip_dir,
                    adapt.pvq.pvq_skip_dir_cdf[(1 if pli != 0 else 0)
                                               + 2 * (bs - 1)], 7,
                    adapt.pvq.pvq_skip_dir_increment)
            else:
                encode_cdf_adapt(
                    enc, skip_dir,
                    adapt.pvq.pvq_skip_dir_cdf[(1 if pli != 0 else 0)
                                               + 2 * (bs - 1)], 7,
                    adapt.pvq.pvq_skip_dir_increment)
        if encode_flip:
            cfl_encoded = True
    tell = (cost[0] if cost is not None else enc.tell_frac()) - tell
    if out[0] != 0:
        skip_rate = -math.log2(
            (skip_cdf[1] - skip_cdf[0])
            / skip_cdf[3 + (1 if pli == 0 and bs > 0 else 0)])
    else:
        skip_rate = -math.log2(
            skip_cdf[0] / skip_cdf[3 + (1 if pli == 0 and bs > 0 else 0)])
    tell -= int(math.floor(0.5 + 8 * skip_rate))
    if nb_bands_coded == 0 or skip_diff <= pvq_norm_lambda / 8 * tell:
        if is_keyframe:
            out[0] = 0
        else:
            dc_rate = -math.log2((skip_cdf[1] - skip_cdf[0]) / skip_cdf[0])
            out[0] = rdo_quant(int(coeffs_in[0]) - int(ref[0]), dc_quant,
                               dc_rate, pvq_norm_lambda)
        rollback_fn(cp)
        # The rollback restores fresh CDF list objects; re-fetch the
        # row (the reference's pointer stays valid because it restores
        # bytes in place, reference: src/encode.c:742-750).
        skip_cdf = adapt.skip_cdf[2 * bs + (1 if pli != 0 else 0)]
        if cost is not None:
            cost[0] = tell0_blk
            cost_cdf_adapt(cost, 1 if out[0] != 0 else 0, skip_cdf,
                           4 + (1 if pli == 0 and bs > 0 else 0),
                           adapt.skip_increment)
        else:
            encode_cdf_adapt(enc, 1 if out[0] != 0 else 0, skip_cdf,
                             4 + (1 if pli == 0 and bs > 0 else 0),
                             adapt.skip_increment)
        if is_keyframe:
            out[1:] = 0
        else:
            out[1:] = ref[1:len(out)]
        if out[0] == 0:
            return 1
    return 0


def pvq_decode_block(dec, adapt, ref, out, q0, pli, bs, beta, nodesync,
                     is_keyframe, block_skip, qm, qm_inv, pvq_qm_q4):
    """od_pvq_decode (reference: src/pvq_decoder.c:283-377).

    ref/out: numpy int arrays in coding order (length scan_length)."""
    offs = part.band_offsets(4 << bs)
    nb_bands = len(offs) - 1
    exg = adapt.pvq.pvq_exg[pli][bs]
    ext = adapt.pvq.pvq_ext
    ext_base = bs * PVQ_MAX_PARTITIONS
    noref = [False] * PVQ_MAX_PARTITIONS
    skip = [1] * PVQ_MAX_PARTITIONS
    skip_rest = [0, 0, 0]
    assert block_skip < 4
    out[0] = block_skip & 1
    if not (block_skip >> 1):
        if is_keyframe:
            out[1:] = 0
        else:
            out[1:] = ref[1:len(out)]
    else:
        cfl = {"ref": ref, "nb_coeffs": int(offs[nb_bands]),
               "allow_flip": pli != 0 and is_keyframe}
        for i in range(nb_bands):
            q = max(1, q0 * int(pvq_qm_q4[P.qm_get_index(bs, i + 1)]) >> 4)
            o0, o1 = int(offs[i]), int(offs[i + 1])
            noref[i], skip[i] = pvq_decode_partition(
                dec, q, o1 - o0, adapt, (exg, i), (ext, ext_base + i),
                ref[o0:o1], out[o0:o1], beta[i], nodesync, is_keyframe, pli,
                (1 if pli != 0 else 0) * OD_NBSIZES * PVQ_MAX_PARTITIONS
                + bs * PVQ_MAX_PARTITIONS + i, cfl,
                1 if (i == 0 and i < nb_bands - 1) else 0, skip_rest, i,
                qm[o0:o1], qm_inv[o0:o1])
            if i == 0 and not skip_rest[0] and bs > 0:
                skip_dir = decode_cdf_adapt(
                    dec,
                    adapt.pvq.pvq_skip_dir_cdf[(1 if pli != 0 else 0)
                                               + 2 * (bs - 1)], 7,
                    adapt.pvq.pvq_skip_dir_increment)
                for j in range(3):
                    skip_rest[j] = 1 if (skip_dir & (1 << j)) else 0
    flags = 0
    for i in range(nb_bands - 1, -1, -1):
        flags <<= 1
        flags |= int(noref[i]) & 1
        flags <<= 1
        flags |= int(skip[i]) & 1
    return flags
