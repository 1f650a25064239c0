"""Adaptive probability models: CDF adaptation, the "generic" coder for
unbounded nonnegative integers, and the Laplace-family coders.

Semantics mirror the reference (reference: src/generic_code.c,
src/generic_encoder.c, src/generic_decoder.c, src/laplace_encoder.c,
src/laplace_decoder.c).  These are host-side model state machines; the TPU
produces the symbol values, the host replays the adaptation while
serializing (encode) or parsing (decode).

The port's copy of daala_tpu/entropy/models.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import math

import numpy as np

from daala_tpu_torch.ops import _tables as T

GENERIC_TABLES = 12


def cdf_init(nsyms: int, val: int, first: int | None = None) -> list:
    """od_cdf_init: linearly increasing initial CDF (reference:
    src/generic_code.c:31-41)."""
    if first is None:
        first = val
    return [val * j + first for j in range(nsyms)]


def cdf_adapt_q15(val: int, cdf: list, n: int, count: int, rate: int) -> int:
    """Adapt a Q15 CDF after coding a symbol; returns the updated count
    (reference: src/generic_code.c:42-85)."""
    count = min(count + 1, 1 << rate)
    assert cdf[n - 1] == 32768
    if count >= 1 << rate:
        for i in range(n):
            tmp = 2 - (1 << rate) + i + (32767 + (1 << rate) - n) * (i >= val)
            cdf[i] -= (cdf[i] - tmp) >> rate
    else:
        alpha = 4 * 32768 // (n + 4 * count)
        for i in range(n):
            tmp = (32768 - n) * (i >= val) + i + 1
            cdf[i] -= ((cdf[i] - tmp) * alpha) >> 15
    assert cdf[n - 1] == 32768
    return count


class AdaptiveCDFQ15:
    """A Q15-adapting CDF with its count, first-use normalization included
    (reference: src/generic_encoder.c:39-63, src/generic_decoder.c)."""

    def __init__(self, init_cdf, rate: int):
        self.cdf = list(init_cdf)
        self.count = 0
        self.rate = rate

    def _normalize_first_use(self):
        if self.count == 0:
            n = len(self.cdf)
            ft = self.cdf[n - 1]
            for i in range(n):
                self.cdf[i] = self.cdf[i] * 32768 // ft

    def encode(self, enc, val: int):
        self._normalize_first_use()
        enc.encode_cdf_q15(val, self.cdf)
        self.count = cdf_adapt_q15(val, self.cdf, len(self.cdf), self.count,
                                   self.rate)

    def decode(self, dec) -> int:
        self._normalize_first_use()
        val = dec.decode_cdf_q15(self.cdf)
        self.count = cdf_adapt_q15(val, self.cdf, len(self.cdf), self.count,
                                   self.rate)
        return val

    def cost_bits(self, val: int) -> float:
        """od_encode_cdf_cost against the *current* state (Q15 path uses the
        normalized CDF)."""
        cdf = self.cdf
        if self.count == 0:
            n = len(cdf)
            ft = cdf[n - 1]
            cdf = [c * 32768 // ft for c in cdf]
        prev = cdf[val - 1] if val > 0 else 0
        return -math.log2((cdf[val] - prev) / cdf[len(cdf) - 1])


class AdaptiveCDFIncrement:
    """Increment-based adaptive CDF (not necessarily summing to a power of
    two); coded with the unscaled path (reference:
    src/generic_encoder.c:65-86)."""

    def __init__(self, init_cdf, increment: int):
        self.cdf = list(init_cdf)
        self.increment = increment

    def _adapt(self, val: int):
        n = len(self.cdf)
        if self.cdf[n - 1] + self.increment > 32767:
            for i in range(n):
                self.cdf[i] = (self.cdf[i] >> 1) + i + 1
        for i in range(val, n):
            self.cdf[i] += self.increment

    def encode(self, enc, val: int, nsyms: int | None = None):
        cdf = self.cdf if nsyms is None else self.cdf[:nsyms]
        enc.encode_cdf_unscaled(val, cdf)
        self._adapt(val)

    def decode(self, dec, nsyms: int | None = None) -> int:
        cdf = self.cdf if nsyms is None else self.cdf[:nsyms]
        val = dec.decode_cdf_unscaled(cdf)
        self._adapt(val)
        return val

    def cost_bits(self, val: int, nsyms: int | None = None) -> float:
        cdf = self.cdf if nsyms is None else self.cdf[:nsyms]
        prev = cdf[val - 1] if val > 0 else 0
        return -math.log2((cdf[val] - prev) / cdf[len(cdf) - 1])


def log_ex(ex_q16: int) -> int:
    """2*log2(ex_q16 / 2^16) in Q1 (reference: src/generic_code.c:112-127)."""
    lg = int(ex_q16).bit_length()
    if lg < 15:
        odd = int(ex_q16 * ex_q16 > 2 << (2 * lg))
    else:
        tmp = ex_q16 >> (lg - 8)
        odd = int(tmp * tmp > 1 << 15)
    return max(0, 2 * lg - 33 + odd)


class GenericModel:
    """The "generic" coder for one-sided exponential-ish distributions
    (reference: src/generic_code.h:43-48, src/generic_encoder.c:88-150).

    Splits x into a 4-bit-quantized MSB symbol coded from a CDF selected by
    log E[x], plus raw LSBs, with a Laplace tail past 15.
    """

    def __init__(self):
        self.increment = 64
        # Contiguous numpy storage: snapshots become one memcpy and the
        # rows can be handed to the native coder by pointer.
        self.cdf = np.array([[(j + 1) * self.increment for j in range(16)]
                             for _ in range(GENERIC_TABLES)], np.int32)

    def snapshot(self):
        return (self.increment, self.cdf.copy())

    def restore(self, snap):
        self.increment = snap[0]
        np.copyto(self.cdf, snap[1])

    def _params(self, ex_q16: int):
        lg_q1 = log_ex(ex_q16)
        shift = max(0, (lg_q1 - 5) >> 1)
        gid = min(GENERIC_TABLES - 1, lg_q1)
        return shift, gid

    def _update(self, ex_q16: int, x: int, xs: int, gid: int,
                integration: int) -> int:
        cdf = self.cdf[gid]
        if cdf[15] + self.increment > 32767:
            for i in range(16):
                cdf[i] = (cdf[i] >> 1) + i + 1
        xenc = min(15, xs)
        for i in range(xenc, 16):
            cdf[i] += self.increment
        x = min(x, 32767)
        return ex_q16 + (((x << 16) - ex_q16) >> integration)

    def encode(self, enc, x: int, max_val: int, ex_q16: int,
               integration: int) -> int:
        """Returns the updated ex_q16 (reference:
        src/generic_encoder.c:99-150)."""
        if max_val == 0:
            return ex_q16
        shift, gid = self._params(ex_q16)
        cdf = self.cdf[gid]
        xs = (x + (1 << shift >> 1)) >> shift
        ms = (max_val + (1 << shift >> 1)) >> shift
        assert max_val == -1 or xs <= ms
        if max_val == -1:
            enc.encode_cdf_unscaled(min(15, xs), cdf)
        else:
            enc.encode_cdf_unscaled(min(15, xs), cdf[:min(ms + 1, 16)])
        if xs >= 15:
            e = ((2 * ex_q16 >> 8) + (1 << shift >> 1)) >> shift
            decay = max(2, min(254, 256 * e // (e + 256)))
            laplace_encode_special(enc, xs - 15, decay,
                                   -1 if max_val == -1 else ms - 15)
        if shift != 0:
            special = int(xs == 0)
            if shift - special > 0:
                enc.encode_bits(
                    x - (xs << shift) + ((not special) << (shift - 1)),
                    shift - special)
        return self._update(ex_q16, x, xs, gid, integration)

    def decode(self, dec, max_val: int, ex_q16: int,
               integration: int):
        """Returns (x, updated ex_q16) (reference:
        src/generic_decoder.c)."""
        if max_val == 0:
            return 0, ex_q16
        shift, gid = self._params(ex_q16)
        cdf = self.cdf[gid]
        ms = (max_val + (1 << shift >> 1)) >> shift
        if max_val == -1:
            xs = dec.decode_cdf_unscaled(cdf)
        else:
            xs = dec.decode_cdf_unscaled(cdf[:min(ms + 1, 16)])
        if xs == 15:
            e = ((2 * ex_q16 >> 8) + (1 << shift >> 1)) >> shift
            decay = max(2, min(254, 256 * e // (e + 256)))
            xs += laplace_decode_special(dec, decay,
                                         -1 if max_val == -1 else ms - 15)
        if shift != 0:
            special = int(xs == 0)
            if shift - special > 0:
                lsb = dec.decode_bits(shift - special)
                x = (xs << shift) + lsb - ((not special) << (shift - 1))
            else:
                x = xs
        else:
            x = xs
        return x, self._update(ex_q16, x, xs, gid, integration)

    def cost_encode(self, x: int, max_val: int, ex_q16: int,
                    integration: int):
        """cost_bits + the exact adaptation of encode(), minus the
        range coder (the cost-only fast trial; frame_enc.inc
        GenModel::cost_encode).  Returns (bits, updated ex_q16)."""
        if max_val == 0:
            return 0.0, ex_q16
        c = self.cost_bits(x, max_val, ex_q16)
        shift, gid = self._params(ex_q16)
        xs = (x + (1 << shift >> 1)) >> shift
        return c, self._update(ex_q16, x, xs, gid, integration)

    def cost_bits(self, x: int, max_val: int, ex_q16: int) -> float:
        """generic_encode_cost (reference: src/generic_encoder.c:152-193)."""
        if max_val == 0:
            return 0.0
        shift, gid = self._params(ex_q16)
        cdf = self.cdf[gid]
        xs = (x + (1 << shift >> 1)) >> shift
        ms = (max_val + (1 << shift >> 1)) >> shift
        extra = 0
        if shift:
            extra = shift - (xs == 0)
        xs = min(15, xs)
        if xs == 15:
            extra += 2
        if max_val == -1:
            ft = cdf[15]
        else:
            ft = cdf[min(ms, 15)]
        p = (cdf[xs] - (0 if xs == 0 else cdf[xs - 1])) / ft
        return extra - math.log2(p)


# ---------------------------------------------------------------------------
# Laplace-family coders (reference: src/laplace_encoder.c,
# src/laplace_decoder.c).
# ---------------------------------------------------------------------------

_EXP_CDF = T.EXP_CDF_TABLE.tolist()
_LAPLACE_OFFSET = T.LAPLACE_OFFSET.tolist()


def laplace_encode_special(enc, x: int, decay: int, max_val: int):
    """Tail coder with exponential decay (reference:
    src/laplace_encoder.c:92-136)."""
    shift = 0
    if max_val == 0:
        return
    while ((max_val >> shift) >= 15 or max_val == -1) and decay > 235:
        decay = (decay * decay + 128) >> 8
        shift += 1
    assert x <= max_val or max_val == -1
    decay = max(2, min(decay, 254))
    xs = x >> shift
    ms = max_val >> shift
    cdf = _EXP_CDF[(decay + 1) >> 1]
    while True:
        sym = min(xs, 15)
        if 0 < ms < 15:
            enc.encode_cdf_unscaled(sym, cdf[:ms + 1])
        else:
            enc.encode_cdf_q15(sym, cdf)
        xs -= 15
        ms -= 15
        if not (sym >= 15 and ms != 0):
            break
    if shift:
        enc.encode_bits(x & ((1 << shift) - 1), shift)


def laplace_decode_special(dec, decay: int, max_val: int) -> int:
    """Mirror of laplace_encode_special (reference:
    src/laplace_decoder.c)."""
    shift = 0
    if max_val == 0:
        return 0
    while ((max_val >> shift) >= 15 or max_val == -1) and decay > 235:
        decay = (decay * decay + 128) >> 8
        shift += 1
    decay = max(2, min(decay, 254))
    ms = max_val >> shift
    cdf = _EXP_CDF[(decay + 1) >> 1]
    xs = 0
    spins = 0
    while True:
        if 0 < ms < 15:
            sym = dec.decode_cdf_unscaled(cdf[:ms + 1])
        else:
            sym = dec.decode_cdf_q15(cdf)
        xs += sym
        ms -= 15
        spins += 1
        if not (sym >= 15 and ms != 0):
            break
        if spins > (1 << 16):
            # Corrupt-stream guard: no valid value needs this many
            # continuation symbols; the reference's loop is unbounded.
            dec.error = 1
            break
    if shift:
        xs = (xs << shift) + dec.decode_bits(shift)
    if max_val != -1 and xs > max_val:
        xs = max_val
        dec.error = 1
    return xs


def laplace_encode(enc, x: int, ex_q8: int, k: int):
    """PVQ pulse-magnitude Laplace coder (reference:
    src/laplace_encoder.c:138-180)."""
    shift = max(0, int(ex_q8).bit_length() - 11)
    ex_q8 = (ex_q8 + (1 << shift >> 1)) >> shift
    k = (k + (1 << shift >> 1)) >> shift
    xs = (x + (1 << shift >> 1)) >> shift
    decay = min(254, 256 * ex_q8 // (ex_q8 + 256))
    offset = _LAPLACE_OFFSET[(decay + 1) >> 1]
    cdf = [_EXP_CDF[(decay + 1) >> 1][j] - offset for j in range(16)]
    sym = min(xs, 15)
    if k != 0:
        enc.encode_cdf_unscaled(sym, cdf[:min(k + 1, 16)])
    if shift:
        special = int(xs == 0)
        if shift - special > 0:
            enc.encode_bits(
                x - (xs << shift) + ((not special) << (shift - 1)),
                shift - special)
    assert xs - 15 <= k - 15
    if xs >= 15:
        laplace_encode_special(enc, xs - 15, decay, k - 15)


def laplace_decode(dec, ex_q8: int, k: int) -> int:
    """Mirror of laplace_encode (reference: src/laplace_decoder.c:163-198)."""
    shift = max(0, int(ex_q8).bit_length() - 11)
    ex_q8 = (ex_q8 + (1 << shift >> 1)) >> shift
    k = (k + (1 << shift >> 1)) >> shift
    decay = min(254, 256 * ex_q8 // (ex_q8 + 256))
    offset = _LAPLACE_OFFSET[(decay + 1) >> 1]
    cdf = [_EXP_CDF[(decay + 1) >> 1][j] - offset for j in range(16)]
    lsb = 0
    sym = 0
    if k != 0:
        sym = dec.decode_cdf_unscaled(cdf[:min(k + 1, 16)])
    if shift:
        special = int(sym == 0)
        if shift - special > 0:
            lsb = dec.decode_bits(shift - special)
        lsb -= (0 if special else 1) << (shift - 1)
    if sym == 15:
        sym += laplace_decode_special(dec, decay, k - 15)
    return (sym << shift) + lsb
