"""Native (C++) runtime components.

The hot host-side loops — currently the range coder — are implemented in
C++ (ec_core.cc) and loaded via ctypes.  The library self-builds with g++
on first import and is cached next to the source; set DAALA_TPU_NATIVE=0
to force the pure-Python fallbacks.

The port's copy of daala_tpu/native/__init__.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ec_core.cc")
_LIB = os.path.join(_DIR, "_ec_core.so")

_lib = None
_tried = False


def available() -> bool:
    return get_lib() is not None


def get_lib():
    """Build (if stale) and load the native library; returns None when
    disabled or the toolchain is unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DAALA_TPU_NATIVE", "1") == "0":
        return None
    # Load a pre-built library verbatim (the sanitizer CI test points
    # this at an ASan/UBSan build of the same sources).
    override = os.environ.get("DAALA_TPU_NATIVE_LIB")
    if override:
        lib = ctypes.CDLL(override)
        _configure(lib)
        _lib = lib
        return _lib
    try:
        newest = os.path.getmtime(_SRC)
        for name in ("lifting_gen.inc", "frame_enc.inc", "me_enc.inc",
                     "frame_dec.inc", "bs_enc.inc"):
            p = os.path.join(_DIR, name)
            if os.path.exists(p):
                newest = max(newest, os.path.getmtime(p))
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < newest:
            # Build to a unique temp name so two processes importing
            # concurrently on a clean checkout (parallel CI, the
            # multiprocessing segment-parallel encoder) cannot interleave
            # g++ output on the same file and cache a truncated .so.
            tmp = "%s.%d.tmp" % (_LIB, os.getpid())
            try:
                # -ffp-contract=off: the RDO decision paths replay the
                # Python implementation's strict-IEEE double math; fused
                # multiply-adds could flip near-tie comparisons.
                try:
                    subprocess.run(
                        ["g++", "-O3", "-march=native", "-fwrapv",
                         "-ffp-contract=off", "-fno-math-errno",
                         "-std=c++17", "-shared", "-pthread",
                         "-fPIC", _SRC, "-o", tmp],
                        check=True, capture_output=True)
                except subprocess.CalledProcessError:
                    # Toolchains without -march=native support.
                    subprocess.run(
                        ["g++", "-O3", "-fwrapv", "-ffp-contract=off",
                         "-fno-math-errno", "-std=c++17", "-shared",
                         "-pthread", "-fPIC", _SRC, "-o",
                         tmp],
                        check=True, capture_output=True)
                # Verify the freshly-built library actually loads before
                # publishing it at the cached path.
                ctypes.CDLL(tmp)
                os.replace(tmp, _LIB)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(_LIB)
    except Exception as e:
        import sys
        print("daala_tpu.native: build/load failed (%s); "
              "falling back to pure Python" % e, file=sys.stderr)
        return None
    _configure(lib)
    _lib = lib
    return _lib


def _configure(lib):
    c = ctypes
    i32p = c.POINTER(c.c_int32)
    i64p = c.POINTER(c.c_int64)
    u8p = c.POINTER(c.c_uint8)
    lib.ec_set_uniform_cdfs.argtypes = [i32p]
    lib.ec_enc_new.restype = c.c_void_p
    lib.ec_enc_free.argtypes = [c.c_void_p]
    lib.ec_enc_reset.argtypes = [c.c_void_p]
    lib.ec_encode.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int]
    lib.ec_encode_q15.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.ec_encode_unscaled.argtypes = [c.c_void_p, c.c_int, c.c_int,
                                       c.c_int]
    lib.ec_encode_bool_q15.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.ec_encode_cdf_q15.argtypes = [c.c_void_p, c.c_int, i32p]
    lib.ec_encode_cdf_unscaled.argtypes = [c.c_void_p, c.c_int, i32p,
                                           c.c_int]
    lib.ec_enc_uint.argtypes = [c.c_void_p, c.c_uint, c.c_uint]
    lib.ec_enc_bits.argtypes = [c.c_void_p, c.c_uint, c.c_int]
    lib.ec_enc_patch_initial_bits.argtypes = [c.c_void_p, c.c_uint,
                                              c.c_int]
    for fn in ("ec_enc_tell", "ec_enc_tell_frac", "ec_enc_done_size",
               "ec_enc_error"):
        getattr(lib, fn).argtypes = [c.c_void_p]
        getattr(lib, fn).restype = c.c_int
    lib.ec_enc_done.argtypes = [c.c_void_p, u8p]
    lib.ec_enc_done.restype = c.c_int
    lib.ec_enc_checkpoint.argtypes = [c.c_void_p, i64p]
    lib.ec_enc_rollback.argtypes = [c.c_void_p, i64p]
    lib.ec_dec_new.argtypes = [u8p, c.c_int]
    lib.ec_dec_new.restype = c.c_void_p
    lib.ec_dec_free.argtypes = [c.c_void_p]
    lib.ec_decode_bool_q15.argtypes = [c.c_void_p, c.c_int]
    lib.ec_decode_bool_q15.restype = c.c_int
    lib.ec_decode_cdf_q15.argtypes = [c.c_void_p, i32p]
    lib.ec_decode_cdf_q15.restype = c.c_int
    lib.ec_decode_cdf.argtypes = [c.c_void_p, i32p, c.c_int]
    lib.ec_decode_cdf.restype = c.c_int
    lib.ec_decode_cdf_unscaled.argtypes = [c.c_void_p, i32p, c.c_int]
    lib.ec_decode_cdf_unscaled.restype = c.c_int
    lib.ec_dec_uint.argtypes = [c.c_void_p, c.c_uint]
    lib.ec_dec_uint.restype = c.c_uint
    lib.ec_dec_bits.argtypes = [c.c_void_p, c.c_int]
    lib.ec_dec_bits.restype = c.c_uint
    lib.ec_dec_set_error.argtypes = [c.c_void_p, c.c_int]
    for fn in ("ec_dec_tell", "ec_dec_tell_frac", "ec_dec_error"):
        getattr(lib, fn).argtypes = [c.c_void_p]
        getattr(lib, fn).restype = c.c_int
    lib.ec_tell_frac.argtypes = [c.c_int, c.c_uint]
    lib.ec_tell_frac.restype = c.c_int
    # Hot per-symbol entry points take raw addresses (c_void_p accepts
    # plain ints from ndarray.ctypes.data) to avoid per-call ctypes
    # pointer-object construction.
    lib.ec_pvq_codeword_encode.argtypes = [c.c_void_p, c.c_void_p,
                                           c.c_int, c.c_int, c.c_void_p,
                                           c.c_void_p, c.c_int, c.c_int]
    lib.ec_pvq_codeword_rate_q3.argtypes = [c.c_void_p, c.c_int, c.c_int,
                                            c.c_void_p, c.c_void_p,
                                            c.c_int, c.c_int]
    lib.ec_pvq_codeword_rate_q3.restype = c.c_int
    lib.ec_pvq_codeword_cost_enc_q3.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_void_p, c.c_void_p,
        c.c_int, c.c_int]
    lib.ec_pvq_codeword_cost_enc_q3.restype = c.c_int
    lib.ec_pvq_codeword_decode.argtypes = [c.c_void_p, c.c_void_p,
                                           c.c_int, c.c_int, c.c_void_p,
                                           c.c_void_p, c.c_int, c.c_int]
    lib.ec_cdf_adapt_enc.argtypes = [c.c_void_p, c.c_int, c.c_void_p,
                                     c.c_int, c.c_int]
    lib.ec_coeff_to_ref.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                    c.c_int, c.c_int, c.c_int]
    lib.ec_cdf_adapt_dec.argtypes = [c.c_void_p, c.c_void_p, c.c_int,
                                     c.c_int]
    lib.ec_cdf_adapt_dec.restype = c.c_int
    lib.ec_pvq_search_rdo_double.argtypes = [c.c_void_p, c.c_int,
                                             c.c_int, c.c_void_p,
                                             c.c_double, c.c_double,
                                             c.c_int]
    lib.ec_pvq_search_rdo_double.restype = c.c_double
    lib.ec_dct2d_batch.argtypes = [c.c_void_p, c.c_int, c.c_int,
                                   c.c_int]
    lib.ec_pvq_theta.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                 c.c_int, c.c_int, c.c_void_p, c.c_int,
                                 c.c_int, c.c_int, c.c_void_p,
                                 c.c_void_p, c.c_double, c.c_int,
                                 c.c_void_p, c.c_void_p, c.c_int,
                                 c.c_int, c.c_void_p, c.c_void_p]
    lib.ec_obmc_pred_l0.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # grid arrays
        c.c_int, c.c_int,                                # nh, nv
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # ref planes
        c.c_int, c.c_int, c.c_int, c.c_int,              # pstride pad decs
        c.c_void_p, c.c_int, c.c_int, c.c_int,           # dst stride vx vy
        c.c_void_p, c.c_int, c.c_int, c.c_int]           # cur stride w h
    lib.ec_obmc_pred_l0.restype = c.c_longlong
    lib.ec_dering.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,  # plane ph pw sby sbx
        c.c_int, c.c_int, c.c_void_p, c.c_int, c.c_int,  # xdec pli bskip h w
        c.c_int, c.c_int, c.c_void_p, c.c_int,           # thr n dirs cshift
        c.c_void_p, c.c_int]                             # out ostride
    # Whole-frame coefficient encoder.
    lib.fc_set_tables.argtypes = [c.c_void_p]
    lib.fc_encode_frame.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                    c.c_void_p]
    lib.fc_encode_frame.restype = c.c_int
    # Whole-frame decoder.
    lib.fd_decode_mvs.argtypes = [c.c_void_p, c.c_void_p]
    lib.fd_decode_mvs.restype = c.c_int
    lib.fc_decode_frame.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.fc_decode_frame.restype = c.c_int
    lib.fc_encode_dering.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                     c.c_void_p]
    lib.fc_encode_dering.restype = c.c_int
    # Open-loop block-size splitter.
    lib.bs_split_superblocks.argtypes = [c.c_void_p]
    # Motion estimation engine.
    lib.me_estimate.argtypes = [c.c_void_p]
    lib.me_sweep_cands.argtypes = [c.c_void_p]
    lib.me_sweep_rates.argtypes = [c.c_void_p]
    lib.me_select_mv_res.argtypes = [c.c_void_p]
    lib.me_select_mv_res.restype = c.c_int
    lib.me_predict_frame_plane.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # grid arrays
        c.c_int, c.c_int,                                # nh, nv
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # ref planes
        c.c_int, c.c_int, c.c_int, c.c_int,              # pstride pad decs
        c.c_void_p, c.c_int]                             # dst stride
    # Install the normative uniform CDF table.
    from daala_tpu_torch.ops import _tables
    flat = _tables.UNIFORM_CDFS_Q15.astype("int32")
    lib.ec_set_uniform_cdfs(flat.ctypes.data_as(i32p))
    # Install the frame-coder tables (kept alive on the module).
    global _FC_TABLES
    import numpy as _np
    from daala_tpu_torch.ops import partition as _part
    _FC_TABLES = [
        _np.ascontiguousarray(_tables.EXP_CDF_TABLE, _np.int32),
        _np.ascontiguousarray(_tables.LAPLACE_OFFSET, _np.int32),
        _np.ascontiguousarray(_tables.CFL_SCALING4, _np.int32),
    ] + [_np.ascontiguousarray(_part.coding_order_indices(n), _np.int32)
         for n in (4, 8, 16, 32, 64)] + [
        _np.ascontiguousarray(getattr(_tables, "BAND_OFFSETS%d" % n),
                              _np.int32)
        for n in (4, 8, 16, 32, 64)]
    ptrs = _np.array([t.ctypes.data for t in _FC_TABLES], _np.int64)
    lib.fc_set_tables(ptrs.ctypes.data)
