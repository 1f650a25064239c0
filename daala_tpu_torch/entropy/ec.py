"""Daala-compatible multisymbol range coder (host side).

Semantically equivalent to the reference entropy coder (reference:
src/entenc.c, src/entdec.c, src/entcode.c): 15-bit probabilities, carry-less
encoding via a pre-carry buffer, raw bits written backward from the buffer
end, and the reduced-overhead partition function (OD_EC_REDUCED_OVERHEAD,
reference: src/entcode.h:31-84).

This pure-Python implementation is the correctness oracle and the
portability fallback; the C++ implementation in daala_tpu/entropy/native is
the production path (same bitstreams, fuzzed against this one).

The range coder is irreducibly sequential and therefore lives on the host in
the TPU-native design: the TPU computes all symbol values and rate estimates
for a frame in parallel, and the host serializes/parses the actual bytes
(see SURVEY.md section 7).

The port's copy of daala_tpu/entropy/ec.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

import math

M32 = 0xFFFFFFFF
WINDOW_SIZE = 32
UINT_BITS = 4  # OD_EC_UINT_BITS (reference: src/entcode.h:100)
BITRES = 3  # OD_BITRES: 1/8 bit resolution
LOTS_OF_BITS = 0x4000


def _ilog(x: int) -> int:
    return int(x).bit_length()


def _build_uniform():
    """Slice OD_UNIFORM_CDFS_Q15 into per-size CDFs (reference:
    src/entcode.h:108-112: table starts at size 2; offset (n*(n-1)/2)-1)."""
    from daala_tpu_torch.ops import _tables
    flat = _tables.UNIFORM_CDFS_Q15.tolist()
    tabs = {}
    pos = 0
    for n in range(2, 17):
        tabs[n] = flat[pos:pos + n]
        pos += n
    return tabs


_UNIFORM = _build_uniform()


def uniform_cdf_q15(n: int):
    """Q15 CDF for a uniform distribution of size 2..16 (reference:
    src/entcode.c:30-57)."""
    return _UNIFORM[n]


def tell_frac(nbits_total: int, rng: int) -> int:
    """Fractional bit usage to 1/8-bit precision (reference:
    src/entcode.c:66-92)."""
    nbits = nbits_total << BITRES
    l = 0
    for _ in range(BITRES):
        rng = (rng * rng) >> 15
        b = rng >> 16
        l = (l << 1) | b
        rng >>= b
    return nbits - l


def _subsatu(a: int, b: int) -> int:
    return a - min(a, b)


def _partition(f: int, d: int, e: int) -> int:
    """Reduced-overhead partition function (reference: src/entcode.h:70-72,
    src/entenc.c:194-200)."""
    return f + min(f, e) + min(_subsatu(f, e) >> 1, d)


class Encoder:
    """Range encoder (reference: src/entenc.c)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.low = 0
        self.rng = 0x8000
        self.cnt = -9
        self.precarry = []  # 16-bit entries, may hold a carry bit
        self.end_window = 0  # raw bits accumulator
        self.nend_bits = 0
        self.end_bytes = []  # flushed raw bytes, first-flushed first
        self.error = 0
        # OD_MEASURE_EC_OVERHEAD analogue (reference: src/entenc.h:31,
        # src/entenc.c:147-543): accumulate the Shannon-ideal bits per
        # coded symbol; done() reports the coder's overhead.  Debug-only
        # (requires the Python engine: DAALA_TPU_NATIVE=0).
        import os as _o
        self.measure_overhead = bool(
            _o.environ.get("DAALA_TPU_MEASURE_EC_OVERHEAD"))
        self.entropy = 0.0
        self.nb_symbols = 0

    # -- internal -----------------------------------------------------------

    def _normalize(self, low: int, rng: int):
        c = self.cnt
        d = 16 - _ilog(rng)
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & M32
        self.rng = (rng << d) & 0xFFFF
        self.cnt = s

    # -- symbol coding ------------------------------------------------------

    def encode(self, fl: int, fh: int, ft: int):
        """od_ec_encode: ft in [16384, 32768] (reference: src/entenc.c:173)."""
        assert fl < fh <= ft and 16384 <= ft <= 32768
        if self.measure_overhead:
            self.entropy -= math.log2((fh - fl) / ft)
            self.nb_symbols += 1
        l = self.low
        r = self.rng
        assert ft <= r
        s = int(r - ft >= ft)
        ft <<= s
        fl <<= s
        fh <<= s
        d = r - ft
        assert d < ft
        e = _subsatu(2 * d, ft)
        u = _partition(fl, d, e)
        v = _partition(fh, d, e)
        r = v - u
        l += u
        self._normalize(l, r)

    def encode_q15(self, fl: int, fh: int):
        """od_ec_encode_q15: ft == 32768 (reference: src/entenc.c:224)."""
        assert fl < fh <= 32768
        if self.measure_overhead:
            self.entropy -= math.log2((fh - fl) / 32768.0)
            self.nb_symbols += 1
        l = self.low
        r = self.rng
        assert 32768 <= r
        u = (fl * r) >> 15
        v = (fh * r) >> 15
        self._normalize(l + u, v - u)

    def encode_unscaled(self, fl: int, fh: int, ft: int):
        """od_ec_encode_unscaled: 2 <= ft <= 32768 (reference:
        src/entenc.c:254)."""
        s = 15 - _ilog(ft - 1)
        self.encode(fl << s, fh << s, ft << s)

    def encode_bool_q15(self, val: int, fz: int):
        """od_ec_encode_bool_q15 (reference: src/entenc.c:314)."""
        assert 0 < fz < 32768
        if self.measure_overhead:
            self.entropy -= math.log2(
                ((32768 - fz) if val else fz) / 32768.0)
            self.nb_symbols += 1
        r = self.rng
        v = (fz * r) >> 15
        l = self.low + (v if val else 0)
        self._normalize(l, r - v if val else v)

    def encode_cdf_q15(self, s: int, cdf):
        assert cdf[len(cdf) - 1] == 32768
        self.encode_q15(int(cdf[s - 1]) if s > 0 else 0, int(cdf[s]))

    def encode_cdf_unscaled(self, s: int, cdf):
        # int() casts: cdf rows may be numpy (adaptation tables).
        self.encode_unscaled(int(cdf[s - 1]) if s > 0 else 0, int(cdf[s]),
                             int(cdf[len(cdf) - 1]))

    def encode_uint(self, fl: int, ft: int):
        """od_ec_enc_uint: <=4 range-coded MSBs + raw LSBs (reference:
        src/entenc.c:411)."""
        assert ft >= 2 and fl < ft
        if ft > 1 << UINT_BITS:
            ft -= 1
            ftb = _ilog(ft) - UINT_BITS
            ft1 = (ft >> ftb) + 1
            self.encode_cdf_q15(fl >> ftb, _UNIFORM[ft1])
            self.encode_bits(fl & ((1 << ftb) - 1), ftb)
        else:
            self.encode_cdf_q15(fl, _UNIFORM[ft])

    def encode_bits(self, fl: int, ftb: int):
        """od_ec_enc_bits: raw bits, written backward from the stream end
        (reference: src/entenc.c:431)."""
        assert 0 <= ftb <= 25 and fl < (1 << ftb)
        if self.measure_overhead:
            # Raw bits are counted at face value (reference:
            # src/entenc.c:436-438).
            self.entropy += ftb
        end_window = self.end_window
        nend_bits = self.nend_bits
        if nend_bits + ftb > WINDOW_SIZE:
            while nend_bits >= 8:
                self.end_bytes.append(end_window & 0xFF)
                end_window >>= 8
                nend_bits -= 8
        end_window |= fl << nend_bits
        nend_bits += ftb
        self.end_window = end_window
        self.nend_bits = nend_bits

    def patch_initial_bits(self, val: int, nbits: int):
        """od_ec_enc_patch_initial_bits (reference: src/entenc.c:495)."""
        assert 0 <= nbits <= 8 and val < (1 << nbits)
        shift = 8 - nbits
        mask = ((1 << nbits) - 1) << shift
        if len(self.precarry) > 0:
            self.precarry[0] = (self.precarry[0] & ~mask) | (val << shift)
        elif 9 + self.cnt + (self.rng == 0x8000) > nbits:
            self.low = ((self.low & ~(mask << (16 + self.cnt))) |
                        (val << (16 + self.cnt + shift))) & M32
        else:
            self.error = -1

    # -- finalization -------------------------------------------------------

    def done(self) -> bytes:
        """od_ec_enc_done: flush, carry-propagate, merge raw bits
        (reference: src/entenc.c:527)."""
        if self.measure_overhead and self.nb_symbols:
            import sys as _sys
            # Don't count the 1 bit lost to raw bits (reference:
            # src/entenc.c:541-552).
            tell = self.tell() - 1
            print("overhead: %f%%" % (100.0 * (tell - self.entropy)
                                      / max(self.entropy, 1e-9)),
                  file=_sys.stderr)
            print("efficiency: %f bits/symbol"
                  % (tell / self.nb_symbols), file=_sys.stderr)
        l = self.low
        r = self.rng
        c = self.cnt
        s = 9
        m = 0x7FFF
        e = (l + m) & ~m & M32
        while (e | m) >= l + r:
            s += 1
            m >>= 1
            e = (l + m) & ~m & M32
        s += c
        precarry = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                precarry.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        # Flush raw-bit tail.
        ew = self.end_window
        nend = self.nend_bits
        end_bytes = list(self.end_bytes)
        neg_s = -s  # leftover bit capacity in the last range-coded byte
        while nend > neg_s:
            end_bytes.append(ew & 0xFF)
            ew >>= 8
            nend -= 8
        # Carry propagation over the pre-carry buffer.
        out = bytearray(len(precarry))
        carry = 0
        for i in range(len(precarry) - 1, -1, -1):
            v = precarry[i] + carry
            out[i] = v & 0xFF
            carry = v >> 8
        # Remaining raw bits (nend <= neg_s) merge into the final byte.
        if nend > 0:
            out[-1] |= ew & 0xFF
        return bytes(out) + bytes(reversed(end_bytes))

    # -- introspection ------------------------------------------------------

    def tell(self) -> int:
        """od_ec_enc_tell (reference: src/entenc.c:651)."""
        return ((len(self.precarry) + len(self.end_bytes)) * 8 +
                self.cnt + self.nend_bits + 10)

    def tell_frac(self) -> int:
        return tell_frac(self.tell(), self.rng)

    def checkpoint(self):
        """od_ec_enc_checkpoint (reference: src/entenc.c:674)."""
        return (self.low, self.rng, self.cnt, len(self.precarry),
                self.end_window, self.nend_bits, len(self.end_bytes),
                self.error, self.entropy, self.nb_symbols)

    def rollback(self, cp):
        """od_ec_enc_rollback (reference: src/entenc.c:684).

        The reference copies the whole coder struct, so the buffer FILL
        COUNTS are restored exactly even when "rolling forward" to a
        checkpoint past the current position (block-size RDO does this;
        the bytes are then stale but the rate accounting is exact,
        reference: src/encode.c:1808-1812)."""
        (self.low, self.rng, self.cnt, np_, self.end_window,
         self.nend_bits, ne, self.error, self.entropy,
         self.nb_symbols) = cp
        if len(self.precarry) >= np_:
            del self.precarry[np_:]
        else:
            self.precarry.extend([0] * (np_ - len(self.precarry)))
        if len(self.end_bytes) >= ne:
            del self.end_bytes[ne:]
        else:
            self.end_bytes.extend([0] * (ne - len(self.end_bytes)))


class Decoder:
    """Range decoder (reference: src/entdec.c)."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.bpos = 0  # forward pointer (range-coded bytes)
        self.epos = len(buf)  # backward pointer (raw bits)
        self.end_window = 0
        self.nend_bits = 0
        self.tell_offs = 10 - (WINDOW_SIZE - 8)
        self.dif = 0
        self.rng = 0x8000
        self.cnt = -15
        self.error = 0
        self._refill()

    def _refill(self):
        s = WINDOW_SIZE - 9 - (self.cnt + 15)
        while s >= 0 and self.bpos < len(self.buf):
            self.dif |= self.buf[self.bpos] << s
            self.cnt += 8
            self.bpos += 1
            s -= 8
        if self.bpos >= len(self.buf):
            self.tell_offs += LOTS_OF_BITS - self.cnt
            self.cnt = LOTS_OF_BITS

    def _normalize(self, dif: int, rng: int, ret: int) -> int:
        d = 16 - _ilog(rng)
        self.cnt -= d
        self.dif = (dif << d) & M32
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()
        return ret

    def decode_bool_q15(self, fz: int) -> int:
        """od_ec_decode_bool_q15 (reference: src/entdec.c:229)."""
        assert 0 < fz < 32768
        dif = self.dif
        r = self.rng
        v = (fz * r) >> 15
        vw = v << (WINDOW_SIZE - 16)
        if dif >= vw:
            return self._normalize(dif - vw, r - v, 1)
        return self._normalize(dif, v, 0)

    def decode_cdf_q15(self, cdf) -> int:
        """od_ec_decode_cdf_q15 (reference: src/entdec.c:449)."""
        return self.decode_cdf_dyadic(cdf, 15)

    def decode_cdf_dyadic(self, cdf, ftb: int) -> int:
        """od_ec_decode_cdf_unscaled_dyadic (reference: src/entdec.c:407)."""
        dif = self.dif
        r = self.rng
        c = dif >> (WINDOW_SIZE - 16)
        v = 0
        ret = -1
        while True:
            u = v
            ret += 1
            v = (int(cdf[ret]) * r) >> ftb
            if v > c:
                break
        return self._normalize(dif - (u << (WINDOW_SIZE - 16)), v - u, ret)

    def decode_cdf(self, cdf) -> int:
        """od_ec_decode_cdf: ft in [16384, 32768] (reference:
        src/entdec.c:262)."""
        dif = self.dif
        r = self.rng
        ft = int(cdf[len(cdf) - 1])
        s = int(r - ft >= ft)
        ft <<= s
        d = r - ft
        c = dif >> (WINDOW_SIZE - 16)
        q = max(c >> 1, c - d)
        e = _subsatu(2 * d, ft)
        q = max(q, (2 * c + 1 - e) // 3)
        q >>= s
        fl = 0
        ret = 0
        fh = int(cdf[0])
        while fh <= q:
            fl = fh
            ret += 1
            fh = int(cdf[ret])
        fl <<= s
        fh <<= s
        u = _partition(fl, d, e)
        v = _partition(fh, d, e)
        return self._normalize(dif - (u << (WINDOW_SIZE - 16)), v - u, ret)

    def decode_cdf_unscaled(self, cdf) -> int:
        """od_ec_decode_cdf_unscaled (reference: src/entdec.c:331)."""
        dif = self.dif
        r = self.rng
        ft = int(cdf[len(cdf) - 1])
        s = 15 - _ilog(ft - 1)
        ft <<= s
        if r - ft >= ft:
            ft <<= 1
            s += 1
        d = r - ft
        c = dif >> (WINDOW_SIZE - 16)
        q = max(c >> 1, c - d)
        e = _subsatu(2 * d, ft)
        q = max(q, (2 * c + 1 - e) // 3)
        q >>= s
        fl = 0
        ret = 0
        fh = int(cdf[0])
        while fh <= q:
            fl = fh
            ret += 1
            fh = int(cdf[ret])
        fl <<= s
        fh <<= s
        u = _partition(fl, d, e)
        v = _partition(fh, d, e)
        return self._normalize(dif - (u << (WINDOW_SIZE - 16)), v - u, ret)

    def decode_uint(self, ft: int) -> int:
        """od_ec_dec_uint (reference: src/entdec.c:459)."""
        assert ft >= 2
        if ft > 1 << UINT_BITS:
            ft -= 1
            ftb = _ilog(ft) - UINT_BITS
            ft1 = (ft >> ftb) + 1
            t = self.decode_cdf_q15(_UNIFORM[ft1])
            t = (t << ftb) | self.decode_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        return self.decode_cdf_q15(_UNIFORM[ft])

    def decode_bits(self, ftb: int) -> int:
        """od_ec_dec_bits (reference: src/entdec.c:483)."""
        assert 0 <= ftb <= 25
        window = self.end_window
        available = self.nend_bits
        if available < ftb:
            while available <= WINDOW_SIZE - 8:
                if self.epos <= self.bpos_limit():
                    self.tell_offs += LOTS_OF_BITS - available
                    available = LOTS_OF_BITS
                    break
                self.epos -= 1
                window |= self.buf[self.epos] << available
                available += 8
        ret = window & ((1 << ftb) - 1)
        window >>= ftb
        available -= ftb
        self.end_window = window
        self.nend_bits = available
        return ret

    def bpos_limit(self):
        # Raw bits may only consume bytes not yet claimed; the reference
        # allows eptr to run down to buf (start).  Overlap with bptr is
        # legal in corrupt streams; mirror the reference (limit = start).
        return 0

    def tell(self) -> int:
        """od_ec_dec_tell (reference: src/entdec.c:525)."""
        return ((len(self.buf) - self.epos) + self.bpos) * 8 \
            - self.cnt - self.nend_bits + self.tell_offs

    def tell_frac(self) -> int:
        return tell_frac(self.tell(), self.rng)


# -- native engine selection -------------------------------------------------
# The C++ engine (daala_tpu/native/ec_core.cc) is the production path; the
# classes above remain the reference implementation and fallback.  Set
# DAALA_TPU_NATIVE=0 to force pure Python.
PyEncoder = Encoder
PyDecoder = Decoder
try:
    from daala_tpu_torch import native as _native
    if _native.available():
        from daala_tpu_torch.entropy.ec_native import (NativeEncoder,
                                                       NativeDecoder)
        Encoder = NativeEncoder
        Decoder = NativeDecoder
except Exception:  # pragma: no cover - toolchain missing
    pass
