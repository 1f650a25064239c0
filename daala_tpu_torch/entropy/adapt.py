"""Per-frame adaptation context: every adaptive CDF and expectation the
codec carries across symbols within a frame.

Mirrors od_adapt_ctx / od_pvq_adapt_ctx and their reset functions
(reference: src/state.h:141-175, src/state.c:535-578, src/pvq.c:275-320).
This state is host-side: the range coder replays adaptation while
serializing (encoder) or parsing (decoder), exactly as the reference does.
CDFs live in contiguous numpy int32 arrays: snapshots (taken at every
RDO checkpoint, like the reference's struct memcpy) are single memcpys,
and the native coder adapts rows in place through their buffer pointers.

The port's copy of daala_tpu/entropy/adapt.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import numpy as np

from daala_tpu_torch.entropy.models import GenericModel, cdf_init
from daala_tpu_torch.ops import _tables as T

OD_NBSIZES = 5
OD_NPLANES_MAX = 4
PVQ_MAX_PARTITIONS = 9
OD_NSB_ADAPT_CTXS = 4
OD_ADAPT_K_Q8 = 0
OD_ADAPT_SUM_EX_Q8 = 1
OD_ADAPT_COUNT_Q8 = 2
OD_ADAPT_COUNT_EX_Q8 = 3
OD_MC_LEVEL_MAX = 6  # 2*OD_LOG_MVB_DELTA0 (reference: src/internal.h:96)
OD_MC_NLEVELS = 7
OD_DERING_LEVELS = 6


def _cdfs(nc, n, val, first=None):
    return [cdf_init(n, val, first) for _ in range(nc)]


def _clone_rows(rows):
    return [list(r) for r in rows]


class Snapshottable:
    """Fast manual checkpoint/restore of the adaptation state.

    The reference memcpys the whole od_adapt_ctx for every RDO checkpoint
    (reference: src/encode.c:742-750); deepcopy is ~50x too slow in Python,
    so each context clones its own flat list structure."""

    _ROW_LISTS = ()    # attributes that are lists of lists of ints
    _FLAT_LISTS = ()   # attributes that are flat lists of ints
    _ARRAYS = ()       # attributes that are numpy arrays (memcpy clone)
    _SCALARS = ()      # attributes that are plain ints
    _CHILDREN = ()     # attributes that are Snapshottable (or lists of)

    def snapshot(self):
        snap = {}
        for a in self._ROW_LISTS:
            snap[a] = _clone_rows(getattr(self, a))
        for a in self._FLAT_LISTS:
            snap[a] = list(getattr(self, a))
        for a in self._ARRAYS:
            snap[a] = getattr(self, a).copy()
        for a in self._SCALARS:
            snap[a] = getattr(self, a)
        for a in self._CHILDREN:
            c = getattr(self, a)
            if isinstance(c, list):
                snap[a] = [x.snapshot() for x in c]
            else:
                snap[a] = c.snapshot()
        return snap

    def restore(self, snap):
        for a in self._ROW_LISTS:
            setattr(self, a, _clone_rows(snap[a]))
        for a in self._FLAT_LISTS:
            setattr(self, a, list(snap[a]))
        for a in self._ARRAYS:
            cur = getattr(self, a, None)
            if isinstance(cur, np.ndarray) and cur.shape == snap[a].shape:
                np.copyto(cur, snap[a])  # keep row views valid
            else:
                setattr(self, a, snap[a].copy())
        for a in self._SCALARS:
            setattr(self, a, snap[a])
        for a in self._CHILDREN:
            c = getattr(self, a)
            if isinstance(c, list):
                for x, xs in zip(c, snap[a]):
                    x.restore(xs)
            else:
                c.restore(snap[a])


class PvqCodewordCtx(Snapshottable):
    """od_pvq_codeword_ctx (reference: src/pvq.h:125-133).

    The CDF tables are contiguous numpy int32 arrays (not lists like the
    other contexts): the codeword coder is the encoder's innermost RDO
    loop and the native engine reads/adapts these rows in place through
    their buffer pointers (daala_tpu/native/ec_core.cc)."""

    _ARRAYS = ("pvq_adapt", "pvq_k1_cdf", "pvq_split_cdf")
    _SCALARS = ("pvq_k1_increment", "pvq_split_increment")

    def reset(self):
        self.pvq_adapt = np.zeros(2 * OD_NBSIZES * OD_NSB_ADAPT_CTXS,
                                  np.int32)
        for i in range(2 * OD_NBSIZES):
            self.pvq_adapt[4 * i + OD_ADAPT_K_Q8] = 384
            self.pvq_adapt[4 * i + OD_ADAPT_SUM_EX_Q8] = 256
            self.pvq_adapt[4 * i + OD_ADAPT_COUNT_Q8] = 104
            self.pvq_adapt[4 * i + OD_ADAPT_COUNT_EX_Q8] = 128
        self.pvq_k1_increment = 128
        self.pvq_k1_cdf = np.array(_cdfs(12, 16, self.pvq_k1_increment),
                                   np.int32)
        self.pvq_split_increment = 128
        self.pvq_split_cdf = np.array(
            _cdfs(14 * 7, 8, self.pvq_split_increment >> 1), np.int32)


class PvqAdaptCtx(Snapshottable):
    """od_pvq_adapt_ctx (reference: src/pvq.h:135-146)."""

    _ARRAYS = ("pvq_gaintheta_cdf", "pvq_skip_dir_cdf", "pvq_ext",
               "pvq_exg")
    _SCALARS = ("pvq_gaintheta_increment", "pvq_skip_dir_increment")
    _CHILDREN = ("pvq_codeword_ctx", "pvq_param_model")

    def reset(self, is_keyframe: bool):
        self.pvq_codeword_ctx = PvqCodewordCtx()
        self.pvq_codeword_ctx.reset()
        self.pvq_param_model = [GenericModel() for _ in range(3)]
        self.pvq_exg = np.full(
            (OD_NPLANES_MAX, OD_NBSIZES, PVQ_MAX_PARTITIONS), 2 << 16,
            np.int64)
        self.pvq_ext = np.full(OD_NBSIZES * PVQ_MAX_PARTITIONS,
                               24576 if is_keyframe else 2 << 16, np.int64)
        self.pvq_gaintheta_increment = 128
        self.pvq_gaintheta_cdf = np.array(
            _cdfs(2 * OD_NBSIZES * PVQ_MAX_PARTITIONS, 16,
                  self.pvq_gaintheta_increment >> 2), np.int32)
        self.pvq_skip_dir_increment = 128
        self.pvq_skip_dir_cdf = np.array(
            _cdfs(2 * (OD_NBSIZES - 1), 7,
                  self.pvq_skip_dir_increment >> 2), np.int32)


class AdaptCtx(Snapshottable):
    """od_adapt_ctx (reference: src/state.h:141-175)."""

    _ARRAYS = ("mv_ref_cdf", "mv_small_cdf", "skip_cdf",
               "haar_coeff_cdf", "haar_split_cdf", "haar_bits_cdf",
               "dering_cdf", "q_cdf", "mv_ex", "mv_ey", "ex_sb_dc",
               "split_flag_cdf", "ex_dc", "ex_g")
    _SCALARS = ("mv_small_increment", "split_flag_increment",
                "skip_increment", "haar_coeff_increment",
                "haar_split_increment", "haar_bits_increment",
                "dering_increment", "q_increment")
    _CHILDREN = ("pvq", "mv_model", "model_dc")

    def reset(self, is_keyframe: bool):
        self.pvq = PvqAdaptCtx()
        self.pvq.reset(is_keyframe)
        self.mv_model = GenericModel()
        self.mv_ref_cdf = np.array(_cdfs(5, 16, 128), np.int32)
        self.mv_ex = np.zeros(OD_MC_NLEVELS, np.int64)
        self.mv_ey = np.zeros(OD_MC_NLEVELS, np.int64)
        self.mv_small_increment = 128
        self.mv_small_cdf = np.array(
            _cdfs(5, 16, self.mv_small_increment,
                  10 * self.mv_small_increment), np.int32)
        self.split_flag_increment = 128
        self.split_flag_cdf = np.array(
            [[[self.split_flag_increment >> 1, self.split_flag_increment]
              for _ in range(9)] for _ in range(OD_MC_LEVEL_MAX)],
            np.int32)
        self.model_dc = [GenericModel() for _ in range(OD_NPLANES_MAX)]
        self.ex_sb_dc = np.array(
            [32768 if pli == 0 else 8 for pli in range(OD_NPLANES_MAX)],
            np.int64)
        # ex_dc: the reference resets only block sizes 0..3 (the loop in
        # od_adapt_ctx_reset is hardcoded `i < 4`, reference:
        # src/state.c:566-571), so the 64x64 slot starts at 0 (state
        # calloc) and PERSISTS across frames. Normative: affects the DC
        # generic-model cdf/shift selection for 64x64 blocks.
        if not hasattr(self, "ex_dc"):
            self.ex_dc = np.zeros((OD_NPLANES_MAX, OD_NBSIZES, 3),
                                  np.int64)
        for pli in range(OD_NPLANES_MAX):
            self.ex_dc[pli, :4, :] = 32768 if pli == 0 else 8
        self.ex_g = np.full((OD_NPLANES_MAX, OD_NBSIZES), 8, np.int64)
        self.skip_increment = 128
        self.skip_cdf = np.array(
            _cdfs(OD_NBSIZES * 2, 5, self.skip_increment >> 2), np.int32)
        self.haar_coeff_increment = 128
        self.haar_coeff_cdf = np.array(
            _cdfs(15 * 3 * (OD_NBSIZES + 1), 16,
                  self.haar_coeff_increment >> 2), np.int32)
        self.haar_split_increment = 128
        self.haar_split_cdf = np.array(
            _cdfs(15 * 2 * 5, 16, self.haar_split_increment >> 2),
            np.int32)
        self.haar_bits_increment = 128
        self.haar_bits_cdf = np.array(
            _cdfs(3, 16, self.haar_bits_increment >> 2), np.int32)
        self.dering_increment = 128
        self.dering_cdf = np.array(
            _cdfs(2 * OD_DERING_LEVELS - 1, OD_DERING_LEVELS,
                  self.dering_increment >> 2), np.int32)
        self.q_increment = 128
        self.q_cdf = np.array(_cdfs(4 * 4, 4, self.q_increment >> 2),
                              np.int32)

    def set_mv_res(self, mv_res: int):
        """od_state_set_mv_res (reference: src/state.c:579-585)."""
        for i in range(OD_MC_NLEVELS):
            self.mv_ex[i] = self.mv_ey[i] = (24 << 16) >> mv_res


try:
    import ctypes as _ct
    from daala_tpu_torch import native as _native_mod
    _NLIB = _native_mod.get_lib()
    _I32P = _ct.POINTER(_ct.c_int32)
except Exception:  # pragma: no cover
    _NLIB = None


def encode_cdf_adapt(enc, val, cdf, n, increment):
    """od_encode_cdf_adapt (reference: src/generic_encoder.c:65-86).
    cdf may be longer than n; only the first n entries are coded and
    adapted (matching the reference, which passes n smaller than the
    allocated row).  Symbol coding + adaptation run in one native call
    when both the coder and the CDF row are native-backed."""
    if (_NLIB is not None and hasattr(enc, "_h")
            and isinstance(cdf, np.ndarray) and cdf.dtype == np.int32
            and cdf.flags.c_contiguous):
        _NLIB.ec_cdf_adapt_enc(enc._h, val, cdf.ctypes.data,
                               n, increment)
        return
    enc.encode_cdf_unscaled(val, cdf[:n])
    _cdf_adapt_increment(val, cdf, n, increment)


def decode_cdf_adapt(dec, cdf, n, increment):
    """od_decode_cdf_adapt (reference: src/generic_decoder.c)."""
    if (_NLIB is not None and hasattr(dec, "_h")
            and not getattr(dec, "_accounting", False)
            and isinstance(cdf, np.ndarray) and cdf.dtype == np.int32
            and cdf.flags.c_contiguous):
        return _NLIB.ec_cdf_adapt_dec(dec._h, cdf.ctypes.data, n,
                                      increment)
    val = dec.decode_cdf_unscaled(cdf[:n])
    _cdf_adapt_increment(val, cdf, n, increment)
    return val


_ADAPT_ARANGE = np.arange(1, 64, dtype=np.int32)


def cost_cdf_adapt(cost, val, cdf, n, increment):
    """Analytic symbol cost + the exact adaptation of encode_cdf_adapt,
    minus the range coder (the cost-only fast trial; frame_enc.inc
    cdf_cost_adapt).  cost: 1-element list accumulator in 1/8-bit
    units."""
    import math
    prev = cdf[val - 1] if val > 0 else 0
    cost[0] += -8.0 * math.log2((cdf[val] - prev) / cdf[n - 1])
    _cdf_adapt_increment(val, cdf, n, increment)


def _cdf_adapt_increment(val, cdf, n, increment):
    if isinstance(cdf, np.ndarray):
        if int(cdf[n - 1]) + increment > 32767:
            cdf[:n] = (cdf[:n] >> 1) + _ADAPT_ARANGE[:n]
        cdf[val:n] += increment
        return
    if cdf[n - 1] + increment > 32767:
        for i in range(n):
            cdf[i] = (cdf[i] >> 1) + i + 1
    for i in range(val, n):
        cdf[i] += increment


def native_ptr_table(a) -> np.ndarray:
    """Pointer table into the numpy-backed adaptation state for the
    native frame coder and decoder (layout: frame_enc.inc
    AdaptPtrs::load).  The native engine mutates these arrays in place,
    so the Python and native paths stay interchangeable mid-stream."""
    pv = a.pvq
    cw = pv.pvq_codeword_ctx
    ptrs = [
        a.skip_cdf.ctypes.data,
        pv.pvq_gaintheta_cdf.ctypes.data,
        pv.pvq_skip_dir_cdf.ctypes.data,
        cw.pvq_k1_cdf.ctypes.data,
        cw.pvq_split_cdf.ctypes.data,
        cw.pvq_adapt.ctypes.data,
        pv.pvq_exg.ctypes.data,
        pv.pvq_ext.ctypes.data,
    ]
    ptrs += [m.cdf.ctypes.data for m in a.model_dc]
    ptrs += [m.cdf.ctypes.data for m in pv.pvq_param_model]
    ptrs += [
        a.ex_dc.ctypes.data,
        a.ex_sb_dc.ctypes.data,
        a.haar_coeff_cdf.ctypes.data,
        a.haar_split_cdf.ctypes.data,
        a.haar_bits_cdf.ctypes.data,
        a.dering_cdf.ctypes.data,
        a.skip_increment,
        pv.pvq_gaintheta_increment,
        pv.pvq_skip_dir_increment,
        cw.pvq_k1_increment,
        cw.pvq_split_increment,
        a.haar_coeff_increment,
        a.haar_split_increment,
        a.haar_bits_increment,
        a.dering_increment,
    ]
    return np.array(ptrs, np.int64)
