"""ctypes wrappers over the native (C++) range coder.

Drop-in replacements for ec.Encoder / ec.Decoder (same method names and
return values; byte-identical output, enforced by tests/test_ec_native.py
differential fuzzing).  Constructed only when daala_tpu.native built
successfully.

The port's copy of daala_tpu/entropy/ec_native.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import ctypes

import numpy as np

from daala_tpu_torch import native as _native

_c_int32 = ctypes.c_int32
_I32P = ctypes.POINTER(_c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_CP = ctypes.c_int64 * 8
_SCRATCH_LEN = 64


def _cdf_arg(scratch, cdf):
    """CDF rows that already live in contiguous int32 numpy memory (the
    adaptation tables) are passed zero-copy by pointer; lists go through
    the scratch buffer."""
    n = len(cdf)
    if isinstance(cdf, np.ndarray) and cdf.dtype == np.int32 \
            and cdf.flags.c_contiguous:
        return cdf.ctypes.data_as(_I32P), n
    scratch[:n] = [int(v) for v in cdf]
    return scratch, n


class NativeEncoder:
    __slots__ = ("_lib", "_h", "_scratch")

    def __init__(self):
        self._lib = _native.get_lib()
        self._h = self._lib.ec_enc_new()
        self._scratch = (_c_int32 * _SCRATCH_LEN)()

    def __del__(self):
        try:
            self._lib.ec_enc_free(self._h)
        except Exception:
            pass

    def reset(self):
        self._lib.ec_enc_reset(self._h)

    def _cdf(self, cdf):
        return _cdf_arg(self._scratch, cdf)

    def encode(self, fl, fh, ft):
        self._lib.ec_encode(self._h, fl, fh, ft)

    def encode_q15(self, fl, fh):
        self._lib.ec_encode_q15(self._h, fl, fh)

    def encode_unscaled(self, fl, fh, ft):
        self._lib.ec_encode_unscaled(self._h, fl, fh, ft)

    def encode_bool_q15(self, val, fz):
        self._lib.ec_encode_bool_q15(self._h, 1 if val else 0, fz)

    def encode_cdf_q15(self, s, cdf):
        arr, _ = self._cdf(cdf)
        self._lib.ec_encode_cdf_q15(self._h, s, arr)

    def encode_cdf_unscaled(self, s, cdf):
        arr, n = self._cdf(cdf)
        self._lib.ec_encode_cdf_unscaled(self._h, s, arr, n)

    def encode_uint(self, fl, ft):
        self._lib.ec_enc_uint(self._h, fl, ft)

    def encode_bits(self, fl, ftb):
        self._lib.ec_enc_bits(self._h, fl, ftb)

    def patch_initial_bits(self, val, nbits):
        self._lib.ec_enc_patch_initial_bits(self._h, val, nbits)

    def done(self) -> bytes:
        size = self._lib.ec_enc_done_size(self._h)
        out = (ctypes.c_uint8 * size)()
        n = self._lib.ec_enc_done(self._h, out)
        return bytes(out[:n])

    def tell(self):
        return self._lib.ec_enc_tell(self._h)

    def tell_frac(self):
        return self._lib.ec_enc_tell_frac(self._h)

    def checkpoint(self):
        cp = _CP()
        self._lib.ec_enc_checkpoint(self._h, cp)
        return cp

    def rollback(self, cp):
        self._lib.ec_enc_rollback(self._h, cp)

    @property
    def error(self):
        return self._lib.ec_enc_error(self._h)


class NativeDecoder:
    __slots__ = ("_lib", "_h", "_buf", "_scratch", "decode_bool_q15",
                 "decode_cdf_q15", "decode_cdf", "decode_cdf_unscaled",
                 "decode_uint", "decode_bits", "decode_cdf_dyadic",
                 "_accounting", "acct_loc")

    def __init__(self, buf: bytes):
        self._lib = _native.get_lib()
        self._buf = bytes(buf)  # keep alive: C side borrows the pointer
        self._h = self._lib.ec_dec_new(
            ctypes.cast(ctypes.c_char_p(self._buf), _U8P), len(self._buf))
        self._scratch = (_c_int32 * _SCRATCH_LEN)()
        # Bound as instance attributes (not methods) so the decoder-side
        # accounting wrapper can intercept them per instance.
        self.decode_bool_q15 = self._decode_bool_q15
        self.decode_cdf_q15 = self._decode_cdf_q15
        self.decode_cdf = self._decode_cdf
        self.decode_cdf_unscaled = self._decode_cdf_unscaled
        self.decode_uint = self._decode_uint
        self.decode_bits = self._decode_bits
        self.decode_cdf_dyadic = self._decode_cdf_dyadic

    def __del__(self):
        try:
            self._lib.ec_dec_free(self._h)
        except Exception:
            pass

    def _cdf(self, cdf):
        return _cdf_arg(self._scratch, cdf)

    def _decode_bool_q15(self, fz):
        return self._lib.ec_decode_bool_q15(self._h, fz)

    def _decode_cdf_q15(self, cdf):
        arr, _ = self._cdf(cdf)
        return self._lib.ec_decode_cdf_q15(self._h, arr)

    def _decode_cdf_dyadic(self, cdf, ftb):
        if ftb == 15:
            return self._decode_cdf_q15(cdf)
        raise NotImplementedError(ftb)

    def _decode_cdf(self, cdf):
        arr, n = self._cdf(cdf)
        return self._lib.ec_decode_cdf(self._h, arr, n)

    def _decode_cdf_unscaled(self, cdf):
        arr, n = self._cdf(cdf)
        return self._lib.ec_decode_cdf_unscaled(self._h, arr, n)

    def _decode_uint(self, ft):
        return self._lib.ec_dec_uint(self._h, ft)

    def _decode_bits(self, ftb):
        return self._lib.ec_dec_bits(self._h, ftb)

    def tell(self):
        return self._lib.ec_dec_tell(self._h)

    def tell_frac(self):
        return self._lib.ec_dec_tell_frac(self._h)

    @property
    def error(self):
        return self._lib.ec_dec_error(self._h)

    @error.setter
    def error(self, v):
        self._lib.ec_dec_set_error(self._h, int(v))
