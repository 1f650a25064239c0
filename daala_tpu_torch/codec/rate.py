"""1-pass rate control (CBR) with Q57 log-domain rate modeling.

Faithful port of the reference rate control (reference: src/rate.c):
R = scale * Q^-exp per frame subtype, second-order Bessel followers for
the scale estimates and drop tracking, a bit reservoir with overflow /
underflow caps, and frame dropping.  All arithmetic is the same 64-bit
fixed point (Python ints are exact).

The port's copy of daala_tpu/codec/rate.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

OD_I_FRAME = 0
OD_P_FRAME = 1
OD_B_FRAME = 2
OD_GOLDEN_P_FRAME = 3
OD_FRAME_NSUBTYPES = 4
OD_GOLDEN_FRAME_INTERVAL = 10

OD_COEFF_SHIFT = 4
OD_MQP = [1.00, 1.05, 1.1, 1.00]
OD_DQP = [-2, 0, 1, -2]
OD_LOG_QUANTIZER_BASE_Q12 = 0x0064EB
OD_LOG_QUANTIZER_EXP_Q12 = 0x000289
OD_LOG_QUANTIZER_OFFSET_Q45 = 0x0000C7851EB851EC


def q57(v):
    return v << 57


def _f_q45(v):
    return int(v * (1 << 45))


def _f_q12(v):
    return int(v * (1 << 12))


_ATANH_LOG2 = [
    0x32B803473F7AD0F4, 0x2F2A71BD4E25E916, 0x2E68B244BB93BA06,
    0x2E39FB9198CE62E4, 0x2E2E683F68565C8F, 0x2E2B850BE2077FC1,
    0x2E2ACC58FE7B78DB, 0x2E2A9E2DE52FD5F2, 0x2E2A92A338D53EEC,
    0x2E2A8FC08F5E19B6, 0x2E2A8F07E51A485E, 0x2E2A8ED9BA8AF388,
    0x2E2A8ECE2FE7384A, 0x2E2A8ECB4D3E4B1A, 0x2E2A8ECA94940FE8,
    0x2E2A8ECA6669811D, 0x2E2A8ECA5ADEDD6A, 0x2E2A8ECA57FC347E,
    0x2E2A8ECA57438A43, 0x2E2A8ECA57155FB4, 0x2E2A8ECA5709D510,
    0x2E2A8ECA5706F267, 0x2E2A8ECA570639BD, 0x2E2A8ECA57060B92,
    0x2E2A8ECA57060008, 0x2E2A8ECA5705FD25, 0x2E2A8ECA5705FC6C,
    0x2E2A8ECA5705FC3E, 0x2E2A8ECA5705FC33, 0x2E2A8ECA5705FC30,
    0x2E2A8ECA5705FC2F, 0x2E2A8ECA5705FC2F]


def ilog64(v):
    return int(v).bit_length()


def bexp64(logq57: int) -> int:
    """Binary exponential of a Q57 log (reference: src/rate.c:103-189).
    Note the C repeats iterations 4, 13, and 40 (indices 3, 12, 39) to
    guarantee CORDIC convergence."""
    ipart = logq57 >> 57
    if ipart < 0:
        return 0
    if ipart >= 63:
        return 0x7FFFFFFFFFFFFFFF
    z = logq57 - q57(ipart)
    w = 1 << 62
    if z:
        z <<= 5
        w = 0x26A3D0E401DD846D
        i = 0
        while True:  # i = 0..3
            mask = -1 if z < 0 else 0
            w += ((w >> (i + 1)) + mask) ^ mask
            z -= (_ATANH_LOG2[i] + mask) ^ mask
            if i >= 3:
                break
            z *= 2
            i += 1
        while True:  # i = 3 (repeat), 4..12
            mask = -1 if z < 0 else 0
            w += ((w >> (i + 1)) + mask) ^ mask
            z -= (_ATANH_LOG2[i] + mask) ^ mask
            if i >= 12:
                break
            z *= 2
            i += 1
        while i < 32:  # i = 12 (repeat), 13..31
            mask = -1 if z < 0 else 0
            w += ((w >> (i + 1)) + mask) ^ mask
            z = (z - ((_ATANH_LOG2[i] + mask) ^ mask)) * 2
            i += 1
        wlo = 0
        if ipart > 30:
            while True:  # i = 32..39
                mask = -1 if z < 0 else 0
                wlo += ((w >> i) + mask) ^ mask
                z -= (_ATANH_LOG2[31] + mask) ^ mask
                if i >= 39:
                    break
                z <<= 1
                i += 1
            while i < 61:  # i = 39 (repeat), 40..60
                mask = -1 if z < 0 else 0
                wlo += ((w >> i) + mask) ^ mask
                z = (z - ((_ATANH_LOG2[31] + mask) ^ mask)) << 1
                i += 1
        w = (w << 1) + wlo
    if ipart < 62:
        w = ((w >> (61 - ipart)) + 1) >> 1
    return w


def blog64(w: int) -> int:
    """Binary log in Q57 (reference: src/rate.c:191-276); iterations 4,
    13, and 40 (indices 3, 12, 39) are repeated."""
    if w <= 0:
        return -1
    ipart = ilog64(w) - 1
    if ipart > 61:
        w >>= ipart - 61
    else:
        w <<= 61 - ipart
    z = 0
    if w & (w - 1):
        x = w + (1 << 61)
        y = w - (1 << 61)

        def step(i, x, y, z, tab_i):
            mask = -1 if y < 0 else 0
            z += ((_ATANH_LOG2[tab_i] >> i) + mask) ^ mask
            u = x >> (i + 1)
            x -= ((y >> (i + 1)) + mask) ^ mask
            y -= (u + mask) ^ mask
            return x, y, z

        for i in range(0, 4):                    # 0..3
            x, y, z = step(i, x, y, z, i)
        for i in range(3, 13):                   # 3 (repeat), 4..12
            x, y, z = step(i, x, y, z, i)
        for i in range(12, 32):                  # 12 (repeat), 13..31
            x, y, z = step(i, x, y, z, i)
        for i in range(32, 40):                  # 32..39
            x, y, z = step(i, x, y, z, 31)
        for i in range(39, 62):                  # 39 (repeat), 40..61
            x, y, z = step(i, x, y, z, 31)
        z = (z + 8) >> 4
    return q57(ipart) + z


def q57_to_q24(v: int) -> int:
    ret = (v + (1 << 32)) >> 33
    return max(-0x80000000, min(ret, 0x7FFFFFFF))


def bexp64_q24(log_scale: int) -> int:
    if log_scale < q57(8):
        ret = bexp64(log_scale + q57(24))
        return min(ret, 0x7FFFFFFF)
    return 0x7FFFFFFF


_ROUGH_TAN_LOOKUP = [0, 358, 722, 1098, 1491, 1910,
                     2365, 2868, 3437, 4096, 4881, 5850,
                     7094, 8784, 11254, 15286, 23230, 46817]


def _warp_alpha(alpha):
    i = alpha * 36 >> 24
    if i >= 17:
        i = 16
    t0 = _ROUGH_TAN_LOOKUP[i]
    t1 = _ROUGH_TAN_LOOKUP[i + 1]
    d = alpha * 36 - (i << 24)
    return ((t0 << 32) + ((t1 - t0) << 8) * d) >> 32


class Bessel2:
    """2nd-order low-pass Bessel follower (reference: src/rate.c:278-364)."""

    def __init__(self, delay, value):
        self.reinit(delay)
        self.y = [value, value]
        self.x = [value, value]

    def reinit(self, delay):
        alpha = (1 << 24) // delay
        one48 = 1 << 48
        warp = max(_warp_alpha(alpha), 1)
        k1 = 3 * warp
        k2 = k1 * warp
        d = ((((1 << 12) + k1) << 12) + k2 + 256) >> 9
        a = (k2 << 23) // d
        ik2 = one48 // k2
        b1 = 2 * a * (ik2 - (1 << 24))
        b2 = (one48 << 8) - ((4 * a) << 24) - b1
        self.c = [(b1 + (1 << 31)) >> 32, (b2 + (1 << 31)) >> 32]
        self.g = (a + 128) >> 8
        if not hasattr(self, "y"):
            self.y = [0, 0]
            self.x = [0, 0]

    def update(self, x):
        ya = ((x + self.x[0] * 2 + self.x[1]) * self.g
              + self.y[0] * self.c[0] + self.y[1] * self.c[1]
              + (1 << 23)) >> 24
        self.x = [x, self.x[0]]
        self.y = [ya, self.y[0]]
        return ya


class RateControl:
    """od_rc_state + the selection/update logic (reference:
    src/rate.c:522-1198)."""

    def __init__(self, enc, bitrate):
        self.enc = enc
        self.target_bitrate = bitrate
        self.rate_bias = 0
        self.base_quantizer = 0
        if bitrate > 0:
            kfr = enc.info.keyframe_rate
            self.reservoir_frame_delay = min(int(kfr * 1.5), 256)
            self.drop_frames = 1
            self.cap_overflow = 1
            self.cap_underflow = 0
            self.reset()

    def reset(self):
        enc = self.enc
        info = enc.info
        self.bits_per_frame = (self.target_bitrate
                               * info.timebase_denominator
                               // info.timebase_numerator)
        self.bits_per_frame = max(32, min(self.bits_per_frame,
                                          0x400000000000))
        self.reservoir_frame_delay = max(self.reservoir_frame_delay, 12)
        self.reservoir_max = self.bits_per_frame \
            * self.reservoir_frame_delay
        self.reservoir_target = (self.reservoir_max + 1) >> 1
        self.reservoir_fullness = self.reservoir_target
        npixels = info.frame_width * info.frame_height
        self.log_npixels = blog64(npixels)
        ibpp = npixels // self.bits_per_frame
        self.exp = [0] * OD_FRAME_NSUBTYPES
        self.log_scale = [0] * OD_FRAME_NSUBTYPES
        if ibpp < 1:
            self.exp[OD_I_FRAME] = 59
            self.log_scale[OD_I_FRAME] = blog64(1997) - q57(OD_COEFF_SHIFT)
        elif ibpp < 2:
            self.exp[OD_I_FRAME] = 55
            self.log_scale[OD_I_FRAME] = blog64(1604) - q57(OD_COEFF_SHIFT)
        else:
            self.exp[OD_I_FRAME] = 48
            self.log_scale[OD_I_FRAME] = blog64(834) - q57(OD_COEFF_SHIFT)
        if ibpp < 4:
            pexp, pscale = 100, 2249
        elif ibpp < 8:
            pexp, pscale = 95, 1751
        else:
            pexp, pscale = 73, 1260
        for ft in (OD_P_FRAME, OD_B_FRAME, OD_GOLDEN_P_FRAME):
            self.exp[ft] = pexp
            self.log_scale[ft] = blog64(pscale) - q57(OD_COEFF_SHIFT)
        self.inter_p_delay = 10
        self.inter_b_delay = 10
        self.inter_delay_target = self.reservoir_frame_delay >> 1
        self.frame_count = [0] * OD_FRAME_NSUBTYPES
        self.prev_drop_count = [0] * OD_FRAME_NSUBTYPES
        self.log_drop_scale = [0] * OD_FRAME_NSUBTYPES
        self.scalefilter = [
            Bessel2(4, q57_to_q24(self.log_scale[OD_I_FRAME])),
            Bessel2(self.inter_p_delay,
                    q57_to_q24(self.log_scale[OD_P_FRAME])),
            Bessel2(self.inter_b_delay,
                    q57_to_q24(self.log_scale[OD_B_FRAME]))]
        self.vfrfilter = [Bessel2(4, bexp64_q24(0))
                          for _ in range(OD_FRAME_NSUBTYPES)]

    # -- closed-form frame typing (reference: src/rate.c:589-650) ----------

    def frame_type(self, coding_frame_count, keyframe_rate, frame_delay,
                   b_frames):
        """Open-GOP closed form; returns (frame_type, is_golden,
        ip_count)."""
        if coding_frame_count == 0:
            return OD_I_FRAME, 1, 0
        keyrate = keyframe_rate
        ip_per_gop = (keyrate + frame_delay - 1) // frame_delay
        gop_n = (coding_frame_count - 1) // keyrate
        gop_i = coding_frame_count - gop_n * keyrate - 1
        ip_count = ((coding_frame_count > 0) + gop_n * ip_per_gop
                    + (gop_i + frame_delay - 1) // frame_delay)
        if gop_i % frame_delay != 0:
            ft = OD_B_FRAME
        elif gop_i // frame_delay < ip_per_gop - 1:
            ft = OD_P_FRAME
        else:
            ft = OD_I_FRAME
        golden = (ip_count % (OD_GOLDEN_FRAME_INTERVAL // (b_frames + 1))
                  == 0 and ft != OD_B_FRAME) or ft == OD_I_FRAME
        return ft, int(golden), ip_count

    def _frame_type_count(self, coding_order, keyframe_rate, frame_delay,
                          b_frames):
        nframes = [0] * OD_FRAME_NSUBTYPES
        acc = [0] * OD_FRAME_NSUBTYPES
        count = 0
        reservoir_frames = 0
        for i in range(self.reservoir_frame_delay):
            ft, golden, _ = self.frame_type(coding_order + i,
                                            keyframe_rate, frame_delay,
                                            b_frames)
            if ft == OD_I_FRAME:
                for j in range(OD_FRAME_NSUBTYPES):
                    nframes[j] += acc[j]
                reservoir_frames += count
                acc = [0] * OD_FRAME_NSUBTYPES
                acc[OD_I_FRAME] = 1
                count = 1
            elif ft == OD_P_FRAME:
                acc[OD_GOLDEN_P_FRAME if golden else OD_P_FRAME] += 1
                count += 1
            else:
                acc[OD_B_FRAME] += 1
                count += 1
        if reservoir_frames == 0:
            nframes = acc
            reservoir_frames += count
        return reservoir_frames, nframes

    def _scale_drop(self, ft, nframes):
        if self.prev_drop_count[ft] > 0 or self.log_drop_scale[ft] > 0:
            dup_scale = bexp64(((self.log_drop_scale[ft]
                                 + blog64(self.prev_drop_count[ft] + 1))
                                >> 1) + q57(8))
            if dup_scale < nframes << 8:
                if dup_scale > 0:
                    nframes = ((nframes << 8) + dup_scale - 1) // dup_scale
            else:
                nframes = 1 if nframes else 0
        return nframes

    # -- quantizer selection (reference: src/rate.c:840-1065) --------------

    def select_quantizer(self, frame_type, is_golden, coding_order,
                         keyframe_rate, frame_delay, b_frames, quality,
                         cur_time, lossy_q_min, lossy_q_max):
        """Returns (target_quantizer, base_quantizer) for bitrate mode."""
        if getattr(self, "tp_model", None) is not None:
            return self._twopass_select(frame_type, is_golden,
                                        lossy_q_min, lossy_q_max)
        frame_subtype = OD_GOLDEN_P_FRAME \
            if (is_golden and frame_type == OD_P_FRAME) else frame_type
        mqp_q12 = [_f_q12(v) for v in OD_MQP]
        dqp_q45 = [_f_q45(v) for v in OD_DQP]
        clamp = cur_time > 0
        reservoir_frames, nframes = self._frame_type_count(
            coding_order, keyframe_rate, frame_delay, b_frames)
        for ft in range(OD_FRAME_NSUBTYPES):
            nframes[ft] = self._scale_drop(ft, nframes[ft])
        rate_bias = (self.rate_bias // (cur_time + 1000)) \
            * reservoir_frames
        rate_total = self.reservoir_fullness - self.reservoir_target \
            + rate_bias + reservoir_frames * self.bits_per_frame
        qlo = 1
        qhi = quality if quality > 0 else lossy_q_max
        base_quantizer = (qlo + qhi) >> 1
        while qlo < qhi:
            log_base_quantizer = blog64(base_quantizer)
            bits = 0
            for i in range(OD_FRAME_NSUBTYPES):
                lq = log_base_quantizer - q57(OD_COEFF_SHIFT)
                lq >>= 36
                lq *= OD_LOG_QUANTIZER_BASE_Q12
                lq += OD_LOG_QUANTIZER_OFFSET_Q45 >> 12
                lq *= mqp_q12[i]
                lq += dqp_q45[i]
                lq = (lq - OD_LOG_QUANTIZER_OFFSET_Q45) \
                    * OD_LOG_QUANTIZER_EXP_Q12 + q57(OD_COEFF_SHIFT)
                lq = max(blog64(lossy_q_min),
                         min(lq, blog64(lossy_q_max)))
                bits += nframes[i] * bexp64(
                    self.log_scale[i] + self.log_npixels
                    - (lq >> 6) * self.exp[i])
            diff = bits - rate_total
            if diff > 0:
                qlo = base_quantizer + 1
            elif diff < 0:
                qhi = base_quantizer - 1
            else:
                break
            base_quantizer = (qlo + qhi) >> 1
        if clamp:
            base_quantizer = max((self.base_quantizer * 0x0CCCD
                                  + 0x8000) >> 16,
                                 min(base_quantizer,
                                     (self.base_quantizer * 0x13333
                                      + 0x8000) >> 16))
        lq = blog64(base_quantizer) - q57(OD_COEFF_SHIFT)
        lq >>= 36
        lq *= OD_LOG_QUANTIZER_BASE_Q12
        lq += OD_LOG_QUANTIZER_OFFSET_Q45 >> 12
        lq *= mqp_q12[frame_subtype]
        lq += dqp_q45[frame_subtype]
        lq = (lq - OD_LOG_QUANTIZER_OFFSET_Q45) \
            * OD_LOG_QUANTIZER_EXP_Q12 + q57(OD_COEFF_SHIFT)
        lq = max(blog64(lossy_q_min), min(lq, blog64(lossy_q_max)))
        if self.cap_overflow:
            margin = (self.reservoir_max + 31) >> 5
            soft_limit = self.reservoir_fullness + self.bits_per_frame \
                - (self.reservoir_max - margin)
            log_soft_limit = blog64(soft_limit)
            log_scale_pixels = self.log_scale[frame_subtype] \
                + self.log_npixels
            exp = self.exp[frame_subtype]
            log_qexp = (lq >> 6) * exp
            if log_scale_pixels - log_qexp < log_soft_limit:
                log_qexp += ((log_scale_pixels - log_soft_limit - log_qexp)
                             >> 32) * (min(margin, soft_limit) << 32) \
                    // margin
                lq = ((log_qexp + (exp >> 1)) // exp) << 6
        if quality == -1:
            log_hard_limit = blog64(self.reservoir_fullness
                                    + (self.bits_per_frame >> 1))
            log_scale_pixels = self.log_scale[frame_subtype] \
                + self.log_npixels
            exp = self.exp[frame_subtype]
            log_qexp = (lq >> 6) * exp
            if log_scale_pixels - log_qexp > log_hard_limit:
                log_qexp = log_scale_pixels - log_hard_limit
                lq = (log_qexp + (exp >> 1)) // exp << 6
                lq = max(lq, blog64(lossy_q_max))
        log_scale_pixels = self.log_scale[frame_subtype] + self.log_npixels
        log_qexp = (lq >> 6) * self.exp[frame_subtype]
        self.rate_bias += bexp64(log_scale_pixels - log_qexp)
        target_quantizer = bexp64(lq)
        self.base_quantizer = base_quantizer
        return target_quantizer, base_quantizer

    # -- post-frame update (reference: src/rate.c:1090-1198) ---------------

    def update(self, bits, is_golden, frame_type, droppable,
               target_quantizer):
        dropped = 0
        if self.target_bitrate <= 0:
            return 0
        if getattr(self, "tp_model", None) is not None:
            self._twopass_update(bits)
            return 0
        frame_subtype = OD_GOLDEN_P_FRAME \
            if (is_golden and frame_type == OD_P_FRAME) else frame_type
        if bits <= 0:
            log_scale = q57(-64)
            bits = 0
            self.prev_drop_count[frame_subtype] += 1
        else:
            log_bits = blog64(bits)
            log_qexp = (blog64(target_quantizer) >> 6) \
                * self.exp[frame_type]
            log_scale = min(log_bits - self.log_npixels + log_qexp,
                            q57(16))
            if self.frame_count[frame_type] == 0:
                f = self.scalefilter[frame_type]
                v = q57_to_q24(log_scale)
                f.y = [v, v]
                f.x = [v, v]
                self.log_scale[frame_type] = log_scale
                if frame_type == OD_P_FRAME:
                    self.log_scale[OD_GOLDEN_P_FRAME] = log_scale
            else:
                if (frame_type == OD_P_FRAME
                        and self.inter_p_delay < self.inter_delay_target
                        and self.frame_count[OD_P_FRAME]
                        >= self.inter_p_delay):
                    self.inter_p_delay += 1
                    self.scalefilter[OD_P_FRAME].reinit(self.inter_p_delay)
                self.log_scale[frame_type] = self.scalefilter[
                    frame_type].update(q57_to_q24(log_scale)) << 33
            if droppable and self.reservoir_fullness \
                    + self.bits_per_frame < bits:
                self.prev_drop_count[frame_subtype] += 1
                bits = 0
                dropped = 1
            else:
                drop_count = self.prev_drop_count[frame_subtype] + 1
                drop_count = 0x7FFFFFFF if drop_count > 0x7F \
                    else drop_count << 24
                self.log_drop_scale[frame_subtype] = blog64(
                    self.vfrfilter[frame_subtype].update(drop_count)) \
                    - q57(24)
                self.prev_drop_count[frame_subtype] = 0
            self.frame_count[frame_type] += 1
        self.reservoir_fullness += self.bits_per_frame - bits
        if self.cap_overflow and self.reservoir_fullness \
                > self.reservoir_max:
            self.reservoir_fullness = self.reservoir_max
        if self.cap_underflow and self.reservoir_fullness < 0:
            self.reservoir_fullness = 0
        self.rate_bias -= bits
        return dropped

    # -- 2-pass rate control -------------------------------------------
    # The reference only stubs this API (od_enc_rc_2pass_out/in return
    # OD_EIMPL, reference: src/rate.c:1199-1220); this is a working
    # implementation.  Pass 1 records per-frame (subtype, bits,
    # quantizer); pass 2 converts each record into the RC model's
    # per-frame scale (log2 bits = log_scale + log2 npixels -
    # exp/64 * log2 q, mirroring the 1-pass update model) and allocates
    # a base quantizer each frame by bisection so the predicted bits of
    # ALL remaining frames hit the remaining budget exactly, with
    # closed-loop drift correction from actual spend.

    def record_pass1(self, frame_type, is_golden, bits, quantizer):
        frame_subtype = OD_GOLDEN_P_FRAME \
            if (is_golden and frame_type == OD_P_FRAME) else frame_type
        if not hasattr(self, "pass1_frames"):
            self.pass1_frames = []
        self.pass1_frames.append([int(frame_subtype), int(bits),
                                  int(quantizer)])

    def twopass_out(self):
        """Serialize first-pass metrics (our extension; the reference
        returns OD_EIMPL here)."""
        import json
        if not getattr(self, "pass1_frames", None):
            raise ValueError("no pass-1 metrics recorded")
        return json.dumps({"daala_tpu_2pass": 1,
                           "frames": self.pass1_frames}).encode()

    def twopass_in(self, buf):
        """Load first-pass metrics and switch to 2-pass allocation."""
        import json
        import math
        data = json.loads(buf)
        assert data.get("daala_tpu_2pass") == 1
        if self.target_bitrate <= 0:
            raise ValueError("pass 2 needs a target bitrate")
        info = self.enc.info
        npix = info.frame_width * info.frame_height
        # Per-frame model scales from pass-1 measurements.  Frames that
        # spent ~nothing (full skips) keep a tiny floor.
        self.tp_model = []
        for st_, bits, q in data["frames"]:
            ex = self.exp[st_] / 64.0
            ls = (math.log2(max(bits, 32)) - math.log2(npix)
                  + ex * math.log2(max(q, 1)))
            self.tp_model.append((st_, ls, self.exp[st_]))
        self.tp_index = 0
        self.tp_spent = 0
        self.tp_total_budget = self.bits_per_frame * len(self.tp_model)
        # Live model correction: ratio of actual to predicted bits,
        # exponentially averaged.  The pass-1 scale/exponent model can be
        # off when coding behavior differs between the passes (e.g.
        # different skip decisions at different quantizers); this keeps
        # pass 2 converging on the budget anyway.
        self.tp_correction = 1.0
        self.tp_last_pred = None

    _TP_MQP = (1.0, 1.05, 1.1, 1.0)

    def _twopass_select(self, frame_type, is_golden, lossy_q_min,
                        lossy_q_max):
        import math
        st_now = OD_GOLDEN_P_FRAME \
            if (is_golden and frame_type == OD_P_FRAME) else frame_type
        info = self.enc.info
        npix = info.frame_width * info.frame_height
        i = min(self.tp_index, len(self.tp_model) - 1)
        remaining = self.tp_model[i:]
        budget = self.tp_total_budget - self.tp_spent
        budget = max(budget, 32 * max(1, len(remaining)))

        def pred_total(lq):
            t = 0.0
            for st_, ls, ex in remaining:
                t += npix * 2.0 ** (ls - (ex / 64.0)
                                    * (lq * self._TP_MQP[st_]))
            return t * self.tp_correction

        lo, hi = 0.0, math.log2(lossy_q_max)
        for _ in range(48):
            mid = 0.5 * (lo + hi)
            if pred_total(mid) > budget:
                lo = mid
            else:
                hi = mid
        base_lq = 0.5 * (lo + hi)
        q = 2.0 ** (base_lq * self._TP_MQP[st_now])
        target = int(min(max(lossy_q_min, round(q)), lossy_q_max))
        self.base_quantizer = int(min(max(lossy_q_min,
                                          round(2.0 ** base_lq)),
                                      lossy_q_max))
        # Remember this frame's predicted bits for the feedback loop.
        st_, ls, ex = remaining[0]
        self.tp_last_pred = self.tp_correction * npix * 2.0 ** (
            ls - (ex / 64.0) * (base_lq * self._TP_MQP[st_]))
        return target, self.base_quantizer

    def _twopass_update(self, bits):
        self.tp_spent += bits
        self.tp_index += 1
        pred = getattr(self, "tp_last_pred", None)
        if pred and pred > 0 and bits > 0:
            ratio = min(4.0, max(0.25, bits / pred))
            self.tp_correction = min(4.0, max(
                0.25, self.tp_correction
                + 0.5 * (ratio * self.tp_correction
                         - self.tp_correction)))
        self.tp_last_pred = None
