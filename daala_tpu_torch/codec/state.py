"""Shared codec state (reference: src/state.h, src/state.c).

Holds the per-stream dimensions, quantization matrices, block size / skip
maps, superblock DC memory, and the adaptation context.  Frame pixel
buffers are 2-D int32 numpy arrays sized to the padded frame.

The port's copy of daala_tpu/codec/state.py; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

import numpy as np

from daala_tpu_torch.entropy.adapt import AdaptCtx
from daala_tpu_torch.ops import _tables as T
from daala_tpu_torch.ops import pvq as P
from daala_tpu_torch.ops.intrin import OD_COEFF_SHIFT

OD_BSIZE_MAX = 64
OD_NBSIZES = 5
OD_BSIZE_GRID = 8
OD_QM_SIZE = 30  # OD_NBSIZES*(OD_NBSIZES + 1) (reference: src/pvq.h:107)
OD_FLAT_QM = 0
OD_HVS_QM = 1

# Scaling compensation for Haar DC (reference: src/state.c:44-62).
OD_DC_QM = [[21, 25], [18, 20], [17, 18], [17, 17]]
OD_HAAR_QM = [[16, 16, 16, 16, 24, 32], [16, 16, 16, 24, 32, 48]]


class CodecState:
    """Mirror of od_state for the parts the intra codec needs."""

    def __init__(self, info):
        self.info = info
        for pli in range(info.nplanes):
            xdec, ydec = info.plane_dec[pli][:2]
            if xdec != ydec:
                # The daala format's per-plane geometry assumes square
                # decimation throughout; the reference decoder asserts
                # xdec == ydec (reference: src/decode.c:617,734) and
                # silently mis-decodes 4:2:2 in release builds.  Fail
                # loudly instead: convert input to 4:2:0 or 4:4:4.
                raise ValueError(
                    "plane %d has asymmetric decimation (xdec=%d, "
                    "ydec=%d): the daala format supports only 4:2:0 "
                    "and 4:4:4; convert 4:2:2 input first "
                    "(tools/convert.py)" % (pli, xdec, ydec))
        if not 1 <= info.bitdepth_mode <= 3:
            # OD_BITDEPTH_MODE_8..12 (reference: src/state.c:365-368).
            raise ValueError("bitdepth_mode must be 1 (8-bit), 2 "
                             "(10-bit) or 3 (12-bit)")
        if info.bitdepth_mode != 1 and not info.full_precision_references:
            # High depth requires FPR (reference: src/state.c:370-373).
            raise ValueError("bitdepth_mode > 8-bit requires "
                             "full_precision_references")
        self.frame_width = info.frame_width
        self.frame_height = info.frame_height
        self.nhsb = self.frame_width >> 6
        self.nvsb = self.frame_height >> 6
        self.quantizer = 0
        self.coded_quantizer = 0
        self.last_qm = -1
        self.qm = None
        self.qm_inv = None
        self.pvq_qm_q4 = [[16] * OD_QM_SIZE for _ in range(4)]
        self.adapt = AdaptCtx()
        nplanes = info.nplanes
        self.sb_dc_mem = [np.zeros(self.nhsb * self.nvsb, np.int32)
                          for _ in range(nplanes)]
        # bsize at 8x8 granularity with one superblock of padding each side
        # (reference: src/state.h:241-258); padding reads as 64x64.
        self.bstride = (self.nhsb + 2) * OD_BSIZE_GRID
        self._bsize_full = np.full(
            ((self.nvsb + 2) * OD_BSIZE_GRID, self.bstride), 4, np.uint8)
        self.bsize = self._bsize_full[OD_BSIZE_GRID:, OD_BSIZE_GRID:]
        # bskip at 4x4 granularity per plane.
        self.bskip = []
        self.skip_stride = self.frame_width >> 2
        for pli in range(nplanes):
            xd = info.plane_dec[pli][0]
            self.bskip.append(np.zeros(
                ((self.frame_height >> xd) >> 2,
                 (self.frame_width >> xd) >> 2), np.uint8))
        self.frame_type = 0
        self.dering_level = np.zeros(
            (self.frame_height >> 6) * (self.frame_width >> 6), np.uint8)

    def bsize4(self, bx4, by4):
        """OD_BLOCK_SIZE4x4 (reference: src/block_size.h:32-35)."""
        return int(self.bsize[by4 >> 1, bx4 >> 1])

    def set_bsize4_region(self, bx4, by4, n4, val):
        """Set the (n4 x n4) 4x4-granular region starting at (bx4, by4)."""
        self.bsize[by4 >> 1:(by4 + n4 + 1) >> 1,
                   bx4 >> 1:(bx4 + n4 + 1) >> 1] = val

    def init_superblock_split(self, bs):
        self.bsize[:self.nvsb * OD_BSIZE_GRID,
                   :self.nhsb * OD_BSIZE_GRID] = bs

    def update_qm(self, qm_choice):
        """od_init_qm on QM change (reference: src/decode.c:1155-1160)."""
        if qm_choice != self.last_qm:
            base = T.QM8_Q4_HVS if qm_choice == OD_HVS_QM else T.QM8_Q4_FLAT
            self.qm, self.qm_inv = P.init_qm(base)
            self.last_qm = qm_choice


def ref_plane_to_coeff(plane, lossless: bool, fpr: bool = False,
                       bitdepth_mode: int = 1) -> np.ndarray:
    """od_ref_buf_to_coeff (reference: src/state.c:1219-1256): 8-bit path
    is (x - 128) << OD_COEFF_SHIFT; the full-precision-reference path
    keeps the 12-bit samples, recentering on 0 ((x - 2048) >> shift with
    shift = OD_COEFF_SHIFT - 2*(bitdepth_mode-1), only for lossless: at
    10/12-bit input depths the lossless coefficients run at the input
    depth)."""
    if fpr:
        shift = (OD_COEFF_SHIFT - 2 * (bitdepth_mode - 1)) if lossless \
            else 0
        v = plane.astype(np.int32) - (1 << (8 + OD_COEFF_SHIFT) >> 1) \
            + (1 << shift >> 1)
        return (v >> shift).astype(np.int32)
    shift = 0 if lossless else OD_COEFF_SHIFT
    return ((plane.astype(np.int32) - 128) * (1 << shift)).astype(np.int32)


def coeff_to_ref_plane(coeffs, lossless: bool, fpr: bool = False,
                       bitdepth_mode: int = 1) -> np.ndarray:
    """od_coeff_to_ref_buf (reference: src/state.c:1283-1327)."""
    if (coeffs.dtype == np.int32 and coeffs.flags.c_contiguous):
        from daala_tpu_torch import native as _native
        lib = _native.get_lib()
        if lib is not None:
            out = np.empty(coeffs.shape,
                           np.uint16 if fpr else np.uint8)
            lib.ec_coeff_to_ref(coeffs.ctypes.data, out.ctypes.data,
                                coeffs.size, int(lossless), int(fpr),
                                int(bitdepth_mode))
            return out
    if fpr:
        shift = (OD_COEFF_SHIFT - 2 * (bitdepth_mode - 1)) if lossless \
            else 0
        v = coeffs * (1 << shift) + (128 << OD_COEFF_SHIFT)
        return np.clip(v, 0, (1 << (8 + OD_COEFF_SHIFT)) - 1) \
            .astype(np.uint16)
    shift = 0 if lossless else OD_COEFF_SHIFT
    v = (coeffs + (1 << shift >> 1)) >> shift
    return np.clip(v + 128, 0, 255).astype(np.uint8)


def img_plane_to_internal(plane, depth: int) -> np.ndarray:
    """Shift a depth-bit input plane up into the 12-bit internal input
    format used with full-precision references (reference:
    src/state.c:146-158 od_img_plane_copy, upshift branch)."""
    up = 8 + OD_COEFF_SHIFT - depth
    v = plane.astype(np.int32) << up
    return np.clip(v, 0, (1 << (8 + OD_COEFF_SHIFT)) - 1).astype(np.uint16)


def internal_to_output(plane, depth: int) -> np.ndarray:
    """Round a 12-bit internal reference plane down to the depth-bit
    output format (reference: src/state.c:160-169, round-down branch).
    Returns uint8 for depth 8, else uint16."""
    dn = 8 + OD_COEFF_SHIFT - depth
    v = (plane.astype(np.int32) + (1 << dn >> 1)) >> dn
    v = np.clip(v, 0, (1 << depth) - 1)
    return v.astype(np.uint8 if depth == 8 else np.uint16)


def img_plane_copy_pad(src, plane_w, plane_h, pic_w, pic_h):
    """od_img_plane_copy_pad low-pass padding extension (reference:
    src/encode.c:752-838).  src: (pic_h, pic_w) uint8 (or uint16 with
    high-depth input); returns (plane_h, plane_w) of the same dtype."""
    dst = np.zeros((plane_h, plane_w), src.dtype)
    dst[:pic_h, :pic_w] = src[:pic_h, :pic_w]
    for x in range(pic_w, plane_w):
        col_c = dst[:pic_h, x - 1].astype(np.int32)
        col_u = np.empty_like(col_c)
        col_u[0] = col_c[0]
        col_u[1:] = dst[:pic_h - 1, x - 1]
        col_d = np.empty_like(col_c)
        col_d[-1] = col_c[-1]
        col_d[:-1] = dst[1:pic_h, x - 1]
        dst[:pic_h, x] = (2 * col_c + col_u + col_d + 2) >> 2
    for y in range(pic_h, plane_h):
        row_c = dst[y - 1, :plane_w].astype(np.int32)
        row_l = np.empty_like(row_c)
        row_l[0] = row_c[0]
        row_l[1:] = dst[y - 1, :plane_w - 1]
        row_r = np.empty_like(row_c)
        row_r[-1] = row_c[-1]
        row_r[:-1] = dst[y - 1, 1:plane_w]
        dst[y, :] = (2 * row_c + row_l + row_r + 2) >> 2
    return dst
