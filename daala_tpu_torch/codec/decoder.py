"""Daala-compatible decoder (intra tools; inter coming online next).

Frame parse mirrors daala_decode_packet_in (reference: src/decode.c:1113-
1249) and od_decode_coefficients (:921-1111).  The per-symbol entropy
decode is host-side and sequential (it must be); the reconstruction math
(inverse transforms, filters) runs on whole-frame tensors.

The port's copy of daala_tpu/codec/decoder.py;
tests/test_torch_copies.py holds it to the original.  Where the original
has its JAX device back end, the copy has the port's, and runs it by
default: `Decoder(info)` (on the card; `device="cpu"` where the caller
asks for the CPU) parses each frame in the native engine's parse-only
mode, reconstructs it on `device`
(models/synthesis.py synthesize_frame: masked inverse DCTs, split and
frame postfilters through the port's kernels) and applies the parsed
dering levels there (models/restore.py), bit-exact with the host
decoder.  The native path derings every superblock of a plane in one
batched call (`_apply_dering_device`); the Python path
(DAALA_TPU_NATIVE_FRAME=0) filters one superblock at a time as the
original does.  Haar-wavelet (lossless) frames decode on the host.
`Decoder(info, use_device_synthesis=False)` is the host decoder.  The
`device_put_fn` attribute is the original's placement hook: with
parallel/sharding.py named_put's, the synthesis runs in tiles over a
mesh whose first device is `device`, with the same frames.
"""

from __future__ import annotations

import functools
import os as _os

import numpy as np

from daala_tpu_torch.codec import headers, quantizer
from daala_tpu_torch.codec import pvq_codec as PC
from daala_tpu_torch.codec.state import (CodecState, OD_DC_QM, OD_QM_SIZE,
                                         coeff_to_ref_plane)
from daala_tpu_torch.entropy import ec as ec_mod
from daala_tpu_torch.entropy.adapt import decode_cdf_adapt
from daala_tpu_torch.ops import dct, filter as filt, intra
from daala_tpu_torch.ops import partition as part
from daala_tpu_torch.ops import pvq as P
from daala_tpu_torch.ops.haar import haar_kernel
from daala_tpu_torch.codec import mc as MC
from daala_tpu_torch.device import resolve
from daala_tpu_torch.utils import devstats

OD_NBSIZES = 5
OD_MAX_REORDER = 16
OD_MAX_CODED_REFS = 2
# The native (C++) whole-frame decoder (frame_dec.inc) is the default
# production path; DAALA_TPU_NATIVE_FRAME=0 forces the pure-Python
# implementation (also used automatically for accounting).
_NATIVE_FRAME_DEFAULT = _os.environ.get("DAALA_TPU_NATIVE_FRAME",
                                        "1") != "0"
BETA_TABLES = {
    # OD_PVQ_BETA[use_masking][pli][bs] flattened: betas per band
    # (reference: src/pvq.c:206-268).
}


def pvq_beta(use_masking, pli, bs):
    nb = [1, 4, 7, 10, 13][bs]
    if use_masking and pli == 0 and bs > 0:
        return [P.BETA_1_5] * nb
    return [P.BETA_1] * nb


def _set_loc(dec, x, y, layer, level):
    """OD_ACCOUNTING_SET_LOCATION analogue (reference: src/decint.h:63-68):
    tags subsequent symbol reads with a (4x4-grid x, y, plane, level)
    location when accounting is enabled."""
    if getattr(dec, "_accounting", False):
        dec.acct_loc = (x, y, layer, level)


class Decoder:
    def __init__(self, info: headers.Info, *, device=None,
                 use_device_synthesis=True):
        self.info = info
        # The device back end (the default): reconstruction and dering
        # on `device`, the card unless the caller names another.  The
        # host decoder is asked for by name (use_device_synthesis=False)
        # and takes no device.
        self.use_device_synthesis = bool(use_device_synthesis)
        if self.use_device_synthesis:
            self.device = resolve("cuda" if device is None else device)
        elif device is not None:
            raise ValueError("Decoder: a device with "
                             "use_device_synthesis=False would go unused")
        else:
            self.device = None
        # The device back end's placement hook (parallel/sharding.py
        # named_put: synthesis in tiles over a mesh whose first device
        # is `device`), or None.
        self.device_put_fn = None
        self.state = CodecState(info)
        self.frames = []
        # Reference image ring (reference: src/state.h:216-219).
        self.ref_imgs = [MC.RefImage(info) for _ in range(4)]
        self.ref_imgi = [-1, -1, -1, -1]
        self.mv_grid = MC.MVGrid(info.frame_width >> 3,
                                 info.frame_height >> 3)
        # Display reorder queue (reference: src/state.c:1115-1214).
        self._out_slots = [None] * OD_MAX_REORDER
        self._out_index = 0
        # Optional bit accounting (reference: src/accounting.h:34-60):
        # when enabled, every symbol decode records (label, bits_q3).
        self.accounting_enabled = False
        self.accounting = None

    # -- MV mesh decode (reference: src/decode.c:829-919,200-251) ----------

    def _decode_mv(self, dec, num_refs, vx, vy, level, mv_res, width,
                   height):
        st = self.state
        grid = self.mv_grid
        _set_loc(dec, vx, vy, -1, level)
        if num_refs > 1:
            ref_offset = 1 if st.frame_type == 2 else 0  # OD_B_FRAME
            ref_pred = MC.get_ref_predictor(grid, st.frame_type, vx, vy,
                                            level) - ref_offset
            # mv_ref_cdf uses od_decode_cdf_adapt with increment 256.
            ref = decode_cdf_adapt(dec, st.adapt.mv_ref_cdf[ref_pred],
                                   num_refs, 256) + ref_offset
            grid.ref[vy, vx] = ref
        else:
            grid.ref[vy, vx] = MC.OD_FRAME_PREV
        ref = int(grid.ref[vy, vx])
        pred, equal_mvs = MC.get_predictor(grid, vx, vy, level, mv_res, ref)
        model = st.adapt.mv_model
        sym = decode_cdf_adapt(dec, st.adapt.mv_small_cdf[equal_mvs], 16,
                               st.adapt.mv_small_increment)
        oy = sym >> 2
        ox = sym & 3
        if ox == 3:
            x, st.adapt.mv_ex[level] = model.decode(
                dec, width << (3 - mv_res), st.adapt.mv_ex[level], 6)
            ox += x
        if oy == 3:
            y, st.adapt.mv_ey[level] = model.decode(
                dec, height << (3 - mv_res), st.adapt.mv_ey[level], 6)
            oy += y
        if ox and dec.decode_bits(1):
            ox = -ox
        if oy and dec.decode_bits(1):
            oy = -oy
        if ref == MC.OD_FRAME_NEXT:
            grid.mv1[vy, vx, 0] = (pred[0] + ox) * (1 << mv_res)
            grid.mv1[vy, vx, 1] = (pred[1] + oy) * (1 << mv_res)
        else:
            grid.mv[vy, vx, 0] = (pred[0] + ox) * (1 << mv_res)
            grid.mv[vy, vx, 1] = (pred[1] + oy) * (1 << mv_res)

    def _dec_mv_unpack(self, dec, num_refs):
        st = self.state
        grid = self.mv_grid
        grid.clear()
        nhmvbs = grid.nhmvbs
        nvmvbs = grid.nvmvbs
        mv_res = dec.decode_uint(3)
        st.adapt.set_mv_res(mv_res)
        width = (self.info.frame_width + 32) << (3 - mv_res)
        height = (self.info.frame_height + 32) << (3 - mv_res)
        D0 = MC.OD_MVB_DELTA0
        for vy in range(0, nvmvbs + 1, D0):
            for vx in range(0, nhmvbs + 1, D0):
                grid.valid[vy, vx] = 1
                self._decode_mv(dec, num_refs, vx, vy, 0, mv_res, width,
                                height)
        level = 1
        log_mvb_sz = MC.OD_LOG_MVB_DELTA0 - 1
        while log_mvb_sz >= 0:
            mvb_sz = 1 << log_mvb_sz
            for vy in range(mvb_sz, nvmvbs + 1, 2 * mvb_sz):
                for vx in range(mvb_sz, nhmvbs + 1, 2 * mvb_sz):
                    if (grid.valid[vy - mvb_sz, vx - mvb_sz]
                            and grid.valid[vy - mvb_sz, vx + mvb_sz]
                            and grid.valid[vy + mvb_sz, vx + mvb_sz]
                            and grid.valid[vy + mvb_sz, vx - mvb_sz]):
                        ctx = MC.mv_split_flag_ctx(grid, vx, vy, level)
                        cdf = st.adapt.split_flag_cdf[level - 1][ctx]
                        valid = decode_cdf_adapt(
                            dec, cdf, 2, st.adapt.split_flag_increment)
                        grid.valid[vy, vx] = valid
                        if valid:
                            self._decode_mv(dec, num_refs, vx, vy, level,
                                            mv_res, width, height)
            level += 1
            for vy in range(0, nvmvbs + 1, mvb_sz):
                vx0 = mvb_sz if not (vy & mvb_sz) else 0
                for vx in range(vx0, nhmvbs + 1, 2 * mvb_sz):
                    ok = ((vy - mvb_sz < 0
                           or grid.valid[vy - mvb_sz, vx])
                          and (vx - mvb_sz < 0
                               or grid.valid[vy, vx - mvb_sz])
                          and (vy + mvb_sz > nvmvbs
                               or grid.valid[vy + mvb_sz, vx])
                          and (vx + mvb_sz > nhmvbs
                               or grid.valid[vy, vx + mvb_sz]))
                    if ok:
                        ctx = MC.mv_split_flag_ctx(grid, vx, vy, level)
                        cdf = st.adapt.split_flag_cdf[level - 1][ctx]
                        valid = decode_cdf_adapt(
                            dec, cdf, 2, st.adapt.split_flag_increment)
                        grid.valid[vy, vx] = valid
                        if valid:
                            self._decode_mv(dec, num_refs, vx, vy, level,
                                            mv_res, width, height)
            level += 1
            log_mvb_sz -= 1

    # -- native whole-frame decode (frame_dec.inc) --------------------------

    def _use_native_frame(self, dec) -> bool:
        """Native decode covers the production path (including FPR and
        high-depth); accounting needs per-symbol Python hooks."""
        if not getattr(self, "use_native_frame", _NATIVE_FRAME_DEFAULT):
            return False
        if self.accounting_enabled or not hasattr(dec, "_h"):
            return False
        from daala_tpu_torch import native as native_mod
        return native_mod.get_lib() is not None

    def _dec_mv_unpack_native(self, dec, num_refs):
        """One-call native MV mesh unpack (frame_dec.inc fd_decode_mvs),
        byte-identical to _dec_mv_unpack below."""
        from daala_tpu_torch import native as native_mod
        lib = native_mod.get_lib()
        st = self.state
        a = st.adapt
        g = self.mv_grid
        cfg = np.array([
            g.nhmvbs, g.nvmvbs,
            g.valid.ctypes.data, g.ref.ctypes.data,
            g.mv.ctypes.data, g.mv1.ctypes.data,
            a.mv_ref_cdf.ctypes.data, a.mv_small_cdf.ctypes.data,
            a.split_flag_cdf.ctypes.data,
            a.mv_ex.ctypes.data, a.mv_ey.ctypes.data,
            a.mv_model.cdf.ctypes.data,
            a.mv_small_increment, a.split_flag_increment,
            st.frame_type, num_refs,
            self.info.frame_width, self.info.frame_height], np.int64)
        lib.fd_decode_mvs(dec._h, cfg.ctypes.data)

    def _decode_coefficients_native(self, dec, is_keyframe,
                                    use_activity_masking,
                                    use_haar_wavelet, self_img):
        """One-call native coefficient decode (frame_dec.inc
        fc_decode_frame): SB loops, postfilter, dering.  Byte-identical
        to the Python loops in decode_packet (differential test:
        tests/test_frame_native.py)."""
        from daala_tpu_torch import native as native_mod
        from daala_tpu_torch.entropy.adapt import native_ptr_table
        lib = native_mod.get_lib()
        st = self.state
        info = self.info
        nplanes = info.nplanes
        # The host span parse_buffers: the parse's output buffers, the
        # prediction planes made contiguous, the pointer tables.
        with devstats.host_span("parse_buffers"):
            pvq_qm = np.zeros((4, 30), np.int32)
            for pli in range(nplanes):
                pvq_qm[pli, :] = st.pvq_qm_q4[pli]
            nvdr = st.frame_height >> 6
            nhdr = st.frame_width >> 6
            lv = np.zeros(nvdr * nhdr, np.uint8)
            cfg = np.zeros(64, np.int64)
            cfg[0] = nplanes
            cfg[1] = st.frame_width
            cfg[2] = st.frame_height
            cfg[3] = info.pic_width
            cfg[4] = info.pic_height
            cfg[5] = st.nhsb
            cfg[6] = st.nvsb
            cfg[7] = st.quantizer
            cfg[8] = st.coded_quantizer
            cfg[10] = 1 if is_keyframe else 0
            cfg[11] = 1 if use_haar_wavelet else 0
            cfg[13] = 1 if use_activity_masking else 0
            cfg[18] = st.bsize.ctypes.data
            cfg[19] = st.bsize.strides[0]
            cfg[20] = st.qm.ctypes.data
            cfg[21] = st.qm_inv.ctypes.data
            cfg[22] = pvq_qm.ctypes.data
            cfg[23] = lv.ctypes.data
            keep = [pvq_qm, lv]
            ctmp = []
            for pli in range(nplanes):
                xd, yd = info.plane_dec[pli]
                out_c = np.zeros((st.frame_height >> yd,
                                  st.frame_width >> xd), np.int32)
                ctmp.append(out_c)
                if not is_keyframe:
                    mc = np.ascontiguousarray(self_img.plane_view(pli))
                    keep.append(mc)
                    cfg[25 + 6 * pli] = mc.ctypes.data
                cfg[26 + 6 * pli] = out_c.ctypes.data
                cfg[27 + 6 * pli] = st.bskip[pli].ctypes.data
                cfg[29 + 6 * pli] = st.sb_dc_mem[pli].ctypes.data
                cfg[48 + 2 * pli] = xd
                cfg[49 + 2 * pli] = yd
            if info.full_precision_references:
                # 12-bit uint16 reference buffers (frame_dec.inc mc_fpr).
                cfg[56] = info.bitdepth_mode
            # Device synthesis back-end: native parse-only mode (emit_d)
            # fills the d planes and dering levels; the device reconstructs
            # (models/synthesis.py masked IDCT + postfilters, then
            # models/restore.py dering) bit-exactly.
            device_synth = (bool(getattr(self, "use_device_synthesis",
                                         False))
                            and not use_haar_wavelet)
            dtmp = None
            if device_synth:
                cfg[57] = 1
                dtmp = []
                for pli in range(nplanes):
                    xd, yd = info.plane_dec[pli]
                    d_out = np.zeros((st.frame_height >> yd,
                                      st.frame_width >> xd), np.int32)
                    dtmp.append(d_out)
                    cfg[28 + 6 * pli] = d_out.ctypes.data
            ap = native_ptr_table(st.adapt)
        with devstats.host_span("parse_frame"):
            lib.fc_decode_frame(dec._h, ap.ctypes.data, cfg.ctypes.data)
        if st.quantizer != 0:
            st.dering_level = lv.reshape(nvdr, nhdr).astype(np.int32)
        if device_synth:
            from daala_tpu_torch.models.synthesis import synthesize_frame
            ctmp = synthesize_frame(st, info, dtmp, self.device,
                                    device_put_fn=self.device_put_fn)
            if st.quantizer != 0:
                self._apply_dering_device(
                    ctmp, lv.reshape(nvdr, nhdr), is_keyframe)
        del keep
        return ctmp

    def _apply_dering_device(self, ctmp, levels, is_keyframe):
        """Apply the parsed dering levels on the device, bit-exact with
        the host filter chain: every superblock with a nonzero level in
        one batched call per plane (models/restore.py
        dering_frame_device), where the original filters one superblock
        and plane at a time.  Every superblock reads the unfiltered
        int16 copy etmp, so the order does not change the result."""
        from daala_tpu_torch.models import restore as R
        from daala_tpu_torch.ops import dering as dering_mod
        st = self.state
        info = self.info
        nhdr = st.frame_width >> 6
        nvdr = st.frame_height >> 6
        base_threshold = float(st.quantizer) ** 0.84182
        # The host stretches on either side of the device's
        # dering_frame are the host span dering_host.
        with devstats.host_span("dering_host"):
            etmp = [c.astype(np.int16) for c in ctmp]
            sbs = np.flatnonzero(levels)
            if not len(sbs):
                return
            lv = levels.reshape(-1)
            thresholds = [[int(dering_mod.OD_DERING_GAIN_TABLE[int(lv[i])]
                               * base_threshold * (1 if pli == 0 else 0.6))
                           for i in sbs] for pli in range(info.nplanes)]
            xdecs = [info.plane_dec[pli][0] for pli in range(info.nplanes)]
        outs = R.dering_frame_device(etmp, st.bskip, xdecs, nvdr, nhdr, sbs,
                                     thresholds, device=self.device)
        with devstats.host_span("dering_host"):
            for pli in range(info.nplanes):
                ln = 6 - xdecs[pli]
                n = 1 << ln
                for k, i in enumerate(sbs):
                    sby, sbx = divmod(int(i), nhdr)
                    ctmp[pli][sby << ln:(sby << ln) + n,
                              sbx << ln:(sbx << ln) + n] = outs[pli][k]

    # -- keyframe DC (reference: src/decode.c:605-654) ----------------------

    def _decode_haar_dc_sb(self, dec, pli, sbx, sby, xdec, has_ur, d):
        _set_loc(dec, sbx << 4, sby << 4, pli, 4)
        st = self.state
        if st.quantizer == 0:
            dc_quant = 1
        else:
            dc_quant = max(1, st.quantizer *
                           st.pvq_qm_q4[pli][P.qm_get_index(OD_NBSIZES - 1,
                                                            0)] >> 4)
        nhsb = st.nhsb
        sb_dc_mem = st.sb_dc_mem[pli]
        ln = 6 - xdec
        if sby > 0 and sbx > 0:
            if has_ur:
                sb_dc_pred = (22 * sb_dc_mem[sby * nhsb + sbx - 1]
                              - 9 * sb_dc_mem[(sby - 1) * nhsb + sbx - 1]
                              + 15 * sb_dc_mem[(sby - 1) * nhsb + sbx]
                              + 4 * sb_dc_mem[(sby - 1) * nhsb + sbx + 1]
                              + 16) >> 5
            else:
                sb_dc_pred = (23 * sb_dc_mem[sby * nhsb + sbx - 1]
                              - 10 * sb_dc_mem[(sby - 1) * nhsb + sbx - 1]
                              + 19 * sb_dc_mem[(sby - 1) * nhsb + sbx]
                              + 16) >> 5
        elif sby > 0:
            sb_dc_pred = sb_dc_mem[(sby - 1) * nhsb + sbx]
        elif sbx > 0:
            sb_dc_pred = sb_dc_mem[sby * nhsb + sbx - 1]
        else:
            sb_dc_pred = 0
        adapt = st.adapt
        q, adapt.ex_sb_dc[pli] = adapt.model_dc[pli].decode(
            dec, -1, adapt.ex_sb_dc[pli], 2)
        if q and dec.decode_bits(1):
            q = -q
        sb_dc_curr = q * dc_quant + int(sb_dc_pred)
        d[sby << ln, sbx << ln] = sb_dc_curr
        sb_dc_mem[sby * nhsb + sbx] = sb_dc_curr
        vgrad = hgrad = 0
        if sby > 0:
            vgrad = int(sb_dc_mem[(sby - 1) * nhsb + sbx]) - sb_dc_curr
        if sbx > 0:
            hgrad = int(sb_dc_mem[sby * nhsb + sbx - 1]) - sb_dc_curr
        return hgrad, vgrad

    def _decode_haar_dc_level(self, dec, pli, bx, by, bsi, xdec, hgrad,
                              vgrad, d):
        """Reference: src/decode.c:656-714.  bx/by in units of level-bsi
        blocks (doubled by caller)."""
        st = self.state
        if st.quantizer == 0:
            dc_quant = 1
            ac_quant = [1, 1]
        else:
            dc_quant = max(1, st.quantizer *
                           st.pvq_qm_q4[pli][P.qm_get_index(OD_NBSIZES - 1,
                                                            0)] >> 4)
            ac_quant = [(dc_quant * OD_DC_QM[bsi - xdec][0] + 8) >> 4,
                        (dc_quant * OD_DC_QM[bsi - xdec][1] + 8) >> 4]
        ln = bsi - xdec + 2
        adapt = st.adapt
        x = [int(d[by << ln, bx << ln]), 0, 0, 0]
        for i in range(1, 4):
            exl = adapt.ex_dc[pli][bsi]
            q, exl[i - 1] = adapt.model_dc[pli].decode(dec, -1, exl[i - 1], 2)
            if q and dec.decode_bits(1):
                q = -q
            x[i] = q * ac_quant[1 if i == 3 else 0]
        x[1] += hgrad // 5 if hgrad >= 0 else -((-hgrad) // 5)
        x[2] += vgrad // 5 if vgrad >= 0 else -((-vgrad) // 5)
        hgrad = x[1]
        vgrad = x[2]
        x0, x1, x2, x3 = haar_kernel(x[0], x[1], x[2], x[3])
        d[by << ln, bx << ln] = x0
        d[by << ln, (bx + 1) << ln] = x1
        d[(by + 1) << ln, bx << ln] = x2
        d[(by + 1) << ln, (bx + 1) << ln] = x3
        return hgrad, vgrad

    # -- block decode (reference: src/decode.c:482-599) ---------------------

    def _block_decode(self, dec, ctx, bs, pli, bx, by, skip):
        st = self.state
        n = 1 << (bs + 2)
        # Convert to 4x4-block coordinates (reference: src/decode.c:504-505).
        bx <<= bs
        by <<= bs
        _set_loc(dec, bx, by, pli, bs)
        xdec = self.info.plane_dec[pli][0]
        w = st.frame_width >> xdec
        c = ctx["c"]
        d = ctx["d"][pli]
        y0, x0 = by << 2, bx << 2
        is_keyframe = ctx["is_keyframe"]
        use_haar = ctx.get("use_haar_wavelet", False)
        # Prediction.
        pred = np.zeros((n, n), np.int32)
        if is_keyframe:
            if pli == 0 or use_haar:
                pred = np.zeros((n, n), np.int32)
                if pli == 0 and not use_haar:
                    predr = np.zeros(n * n, np.int32)
                    intra.hv_intra_pred(predr, d.reshape(-1), w, bx, by,
                                        st.bsize4, bs)
                    pred = predr.reshape(n, n)
            else:
                pred = ctx["l"][:n, :n]
        else:
            mcp = ctx["mc"][pli]
            mdp = ctx["md"][pli]
            if use_haar:
                from daala_tpu_torch.ops.haar import haar2d
                mdp[y0:y0 + n, x0:x0 + n] = haar2d(
                    mcp[y0:y0 + n, x0:x0 + n][None])[0]
            else:
                mdp[y0:y0 + n, x0:x0 + n] = dct.fdct2d(
                    mcp[y0:y0 + n, x0:x0 + n][None])[0]
            pred = mdp[y0:y0 + n, x0:x0 + n].copy()
        if use_haar:
            from daala_tpu_torch.codec import wavelet
            from daala_tpu_torch.ops.haar import haar2d_inv
            quant0 = st.quantizer
            blk = wavelet.wavelet_unquantize(dec, st.adapt, bs + 2,
                                             pred.astype(np.int64),
                                             quant0, pli)
            if is_keyframe:
                blk[0, 0] = d[y0, x0]
            else:
                # Inter DC (has_dc_skip = 0 in wavelet mode;
                # dc_quant carries the per-plane PVQ QM factor —
                # identical for luma, different for chroma; reference:
                # src/decode.c:558-576).
                from daala_tpu_torch.ops.pvq import qm_get_index
                dc_quant = 1 if quant0 == 0 else max(
                    1, quant0 * st.pvq_qm_q4[pli][qm_get_index(bs, 0)]
                    >> 4)
                adapt = st.adapt
                exl = adapt.ex_dc[pli][bs]
                q, exl[0] = adapt.model_dc[pli].decode(dec, -1, exl[0], 2)
                if q and dec.decode_bits(1):
                    q = -q
                blk[0, 0] = q * dc_quant + int(pred[0, 0])
            d[y0:y0 + n, x0:x0 + n] = blk
            c[y0:y0 + n, x0:x0 + n] = haar2d_inv(
                blk.astype(np.int32)[None])[0]
            return
        predt = part.raster_to_coding(pred[None])[0].astype(np.int64)
        quant = max(1, st.quantizer)
        lossless = st.quantizer == 0
        if lossless:
            dc_quant = 1
        else:
            dc_quant = max(1, quant *
                           st.pvq_qm_q4[pli][P.qm_get_index(bs, 0)] >> 4)
        nodesync = 1
        off = P.qm_offset(bs, xdec)
        slen = part.scan_length(n)
        out = np.zeros(slen, np.int64)
        beta = pvq_beta(ctx["use_activity_masking"], pli, bs)
        PC.pvq_decode_block(dec, st.adapt, predt, out, quant, pli, bs, beta,
                            nodesync, is_keyframe, skip,
                            st.qm[off:off + slen],
                            st.qm_inv[off:off + slen], st.pvq_qm_q4[pli])
        if not is_keyframe:
            # has_dc_skip DC coding (reference: src/decode.c:565-576).
            adapt = st.adapt
            if out[0]:
                exl = adapt.ex_dc[pli][bs]
                q, exl[0] = adapt.model_dc[pli].decode(dec, -1, exl[0], 2)
                out[0] = 1 + q
                if out[0] and dec.decode_bits(1):
                    out[0] = -out[0]
            out[0] = out[0] * dc_quant + predt[0]
        else:
            out[0] = d[y0, x0]
        # Scatter back to raster; unscanned coeffs are zero on keyframes,
        # and take the prediction on inter frames (od_init_skipped_coeffs).
        base = np.zeros((n, n), np.int32) if is_keyframe else pred.copy()
        blk = part.coding_to_raster(out[None].astype(np.int32), n,
                                    base=base[None])[0]
        d[y0:y0 + n, x0:x0 + n] = blk
        if not ctx.get("device_synthesis", False):
            c[y0:y0 + n, x0:x0 + n] = dct.idct2d(blk[None])[0]

    # -- recursive parse (reference: src/decode.c:726-826) ------------------

    def _decode_recursive(self, dec, ctx, pli, bx, by, bsi, xdec, hgrad,
                          vgrad):
        st = self.state
        obs = st.bsize4(bx << bsi, by << bsi)
        w = st.frame_width >> xdec
        _set_loc(dec, bx << bsi, by << bsi, pli, bsi)
        skip = 0
        if ctx.get("use_haar_wavelet", False):
            obs = bsi
        elif pli == 0:
            skip = decode_cdf_adapt(
                dec, st.adapt.skip_cdf[2 * bsi], 4 + (1 if bsi > 0 else 0),
                st.adapt.skip_increment)
            obs = bsi if skip < 4 else -1
        bs = max(obs, xdec)
        # Corrupt streams can leave an inconsistent bsize map; the
        # reference's OD_ASSERT compiles out in production and decode
        # proceeds -- clamp instead of crashing.
        bs = min(bs, bsi)
        if bs == bsi:
            bs -= xdec
            if pli == 0:
                st.set_bsize4_region(bx << bsi, by << bsi, 1 << bsi, bsi)
            if (ctx["l"] is not None and ctx["is_keyframe"]
                    and not ctx.get("use_haar_wavelet", False)):
                assert pli > 0
                n = 1 << (bs + 2)
                dl = ctx["d"][0]
                ly = by << (2 + bsi)
                lx = bx << (2 + bsi)
                src = dl[ly:ly + 2 * n + 2, lx:lx + 2 * n + 2]
                ctx["l"] = intra.resample_luma_coeffs(
                    src, xdec, self.info.plane_dec[pli][1], bs, obs, n)
            if pli > 0 and not ctx.get("use_haar_wavelet", False):
                skip = decode_cdf_adapt(
                    dec, st.adapt.skip_cdf[2 * bsi + 1], 4,
                    st.adapt.skip_increment)
            self._block_decode(dec, ctx, bs, pli, bx, by, skip)
            sk = self.state.bskip[pli]
            val = 1 if (skip == 0 and not ctx["is_keyframe"]) else 0
            sk[(by << bs):(by << bs) + (1 << bs),
               (bx << bs):(bx << bs) + (1 << bs)] = val
        else:
            bs = bsi - xdec
            f = 0  # OD_FILT_SIZE is constant 0
            y0 = by << (2 + bs)
            x0 = bx << (2 + bs)
            hfilter = ((bx + 1) << (2 + bs)) <= self.info.pic_width
            vfilter = ((by + 1) << (2 + bs)) <= self.info.pic_height
            if not ctx["is_keyframe"]:
                filt.prefilter_split(ctx["mc"][pli], y0, x0, bs, f,
                                     hfilter, vfilter)
            if ctx["is_keyframe"]:
                hgrad, vgrad = self._decode_haar_dc_level(
                    dec, pli, 2 * bx, 2 * by, bsi - 1, xdec, hgrad, vgrad,
                    ctx["d"][pli])
            for sub in ((0, 0), (1, 0), (0, 1), (1, 1)):
                self._decode_recursive(dec, ctx, pli, 2 * bx + sub[0],
                                       2 * by + sub[1], bsi - 1, xdec,
                                       hgrad, vgrad)
            if not ctx.get("device_synthesis", False):
                filt.postfilter_split(ctx["c"], y0, x0, bs, f, hfilter,
                                      vfilter)

    def _decode_coefficients(self, dec, is_keyframe, use_activity_masking,
                             use_haar_wavelet, self_img):
        """od_decode_coefficients, pure-Python path (reference:
        src/decode.c:921-1111).  Used for accounting and as the
        differential reference for the native decoder."""
        st = self.state
        info = self.info
        nplanes = info.nplanes
        fw, fh = st.frame_width, st.frame_height
        lossless = st.quantizer == 0
        fpr = bool(info.full_precision_references)
        ctmp = [np.zeros((fh >> info.plane_dec[p][1],
                          fw >> info.plane_dec[p][0]), np.int32)
                for p in range(nplanes)]
        dtmp = [np.zeros_like(ctmp[p]) for p in range(nplanes)]
        mctmp = [None] * nplanes
        mdtmp = [None] * nplanes
        if not is_keyframe:
            from daala_tpu_torch.codec.state import ref_plane_to_coeff
            for pli in range(nplanes):
                xd, yd = info.plane_dec[pli]
                mctmp[pli] = ref_plane_to_coeff(
                    self_img.plane_view(pli), lossless, fpr=fpr,
                    bitdepth_mode=info.bitdepth_mode)
                if not use_haar_wavelet:
                    filt.apply_prefilter_frame_sbs(mctmp[pli], st.nhsb,
                                                   st.nvsb, xd, yd)
                mdtmp[pli] = np.zeros_like(mctmp[pli])
        device_synth = (bool(getattr(self, "use_device_synthesis", False))
                        and not use_haar_wavelet)
        ctx = {"is_keyframe": bool(is_keyframe), "use_activity_masking":
               use_activity_masking, "d": dtmp, "l": None,
               "use_haar_wavelet": use_haar_wavelet,
               "mc": mctmp, "md": mdtmp,
               "device_synthesis": device_synth}
        for sby in range(st.nvsb):
            for sbx in range(st.nhsb):
                for pli in range(nplanes):
                    xdec = info.plane_dec[pli][0]
                    ctx["c"] = ctmp[pli]
                    ctx["l"] = (np.zeros((64, 64), np.int32) if pli > 0
                                else None)
                    hgrad = vgrad = 0
                    if is_keyframe:
                        hgrad, vgrad = self._decode_haar_dc_sb(
                            dec, pli, sbx, sby, xdec,
                            sby > 0 and sbx < st.nhsb - 1, dtmp[pli])
                    self._decode_recursive(dec, ctx, pli, sbx, sby,
                                           OD_NBSIZES - 1, xdec, hgrad,
                                           vgrad)
        if device_synth:
            # Device back-end: one masked IDCT + postfilter pass per
            # plane (daala_tpu_torch/models/synthesis.py), bit-exact with
            # the host loop above.
            from daala_tpu_torch.models.synthesis import synthesize_frame
            ctmp = synthesize_frame(st, info, dtmp, self.device,
                                    device_put_fn=self.device_put_fn)
        elif not use_haar_wavelet:
            for pli in range(nplanes):
                xdec = info.plane_dec[pli][0]
                filt.apply_postfilter_frame_sbs(ctmp[pli], st.nhsb,
                                                st.nvsb, xdec,
                                                info.plane_dec[pli][1])
        if st.quantizer != 0:
            self._decode_dering(dec, ctmp, is_keyframe)
        return ctmp

    # -- frame decode -------------------------------------------------------

    def sync_to_packet(self, data: bytes):
        """Align the display-reorder queue for a mid-stream start
        (seeking): the next expected display number becomes this
        packet's coded frame number."""
        dec = ec_mod.Decoder(data)
        if dec.decode_bool_q15(16384):
            return
        if not dec.decode_bool_q15(16384):  # keyframe flag
            dec.decode_bool_q15(16384)
            dec.decode_uint(OD_MAX_CODED_REFS)
        self._out_index = dec.decode_uint(OD_MAX_REORDER) % OD_MAX_REORDER

    def decode_packet(self, data: bytes):
        """daala_decode_packet_in (reference: src/decode.c:1113-1249).
        Returns the list of frames ready for display (in display order)."""
        st = self.state
        info = self.info
        dec = ec_mod.Decoder(data)
        if self.accounting_enabled:
            self.accounting = _install_accounting(dec)
        if dec.decode_bool_q15(16384):
            # Reserved bit set: the reference returns OD_EBADPACKET and
            # emits no frame (reference: src/decode.c:1129-1132).
            self.error = 1
            return []
        is_keyframe = dec.decode_bool_q15(16384)
        if is_keyframe:
            frame_type = 0  # OD_I_FRAME
        else:
            frame_type = 2 if dec.decode_bool_q15(16384) else 1
        st.frame_type = frame_type
        if frame_type != 0:
            num_refs = dec.decode_uint(OD_MAX_CODED_REFS) + 1
        else:
            num_refs = 0
        frame_number = dec.decode_uint(OD_MAX_REORDER)
        use_activity_masking = dec.decode_bool_q15(16384)
        qm = dec.decode_bool_q15(16384)
        st.update_qm(qm)
        use_haar_wavelet = dec.decode_bool_q15(16384)
        is_golden = dec.decode_bool_q15(16384)
        if is_keyframe:
            for pli in range(info.nplanes):
                for i in range(OD_QM_SIZE):
                    st.pvq_qm_q4[pli][i] = dec.decode_bits(8)
        # Reference buffer state (reference: src/decode.c:1174-1209).
        if frame_type == 1:  # P
            self.ref_imgi[MC.OD_FRAME_PREV] = self.ref_imgi[MC.OD_FRAME_NEXT]
        if not is_keyframe:
            if (self.ref_imgi[MC.OD_FRAME_GOLD] < 0
                    or self.ref_imgi[MC.OD_FRAME_PREV] < 0):
                self.ref_imgi[MC.OD_FRAME_GOLD] = 0
                self.ref_imgi[MC.OD_FRAME_PREV] = 0
                self.ref_imgi[MC.OD_FRAME_SELF] = 0
                self.ref_imgs[0].blank()
        refi = 0
        while refi in (self.ref_imgi[MC.OD_FRAME_GOLD],
                       self.ref_imgi[MC.OD_FRAME_PREV],
                       self.ref_imgi[MC.OD_FRAME_NEXT]):
            refi += 1
        self.ref_imgi[MC.OD_FRAME_SELF] = refi
        st.adapt.reset(is_keyframe)
        self_img = self.ref_imgs[refi]
        use_native = self._use_native_frame(dec)
        if not is_keyframe:
            with devstats.host_span("decode_mvs"):
                if use_native:
                    self._dec_mv_unpack_native(dec, num_refs)
                else:
                    self._dec_mv_unpack(dec, num_refs)
            with devstats.host_span("mc_predict"):
                MC.mc_predict_frame(self.mv_grid, self.ref_imgs,
                                    self.ref_imgi, info, self_img)
        # -- od_decode_coefficients ----------------------------------------
        st.coded_quantizer = dec.decode_uint(quantizer.N_CODED_QUANTIZERS)
        st.quantizer = quantizer.codedquantizer_to_quantizer(
            st.coded_quantizer)
        nplanes = info.nplanes
        fw, fh = st.frame_width, st.frame_height
        lossless = st.quantizer == 0
        fpr = bool(info.full_precision_references)
        if use_native:
            ctmp = self._decode_coefficients_native(
                dec, is_keyframe, use_activity_masking, use_haar_wavelet,
                self_img)
        else:
            ctmp = self._decode_coefficients(dec, is_keyframe,
                                             use_activity_masking,
                                             use_haar_wavelet, self_img)
        # Store reconstruction into the SELF reference image, and crop the
        # output planes (host span store_recon).
        with devstats.host_span("store_recon"):
            for pli in range(nplanes):
                self_img.plane_view(pli)[:, :] = coeff_to_ref_plane(
                    ctmp[pli], lossless, fpr=fpr,
                    bitdepth_mode=info.bitdepth_mode)
            self_img.edge_ext()
            if is_golden:
                self.ref_imgi[MC.OD_FRAME_GOLD] = refi
            if frame_type != 2:  # not B
                if (self.ref_imgi[MC.OD_FRAME_PREV] < 0
                        and self.ref_imgi[MC.OD_FRAME_NEXT] < 0):
                    self.ref_imgi[MC.OD_FRAME_PREV] = refi
                    self.ref_imgi[MC.OD_FRAME_NEXT] = refi
                else:
                    self.ref_imgi[MC.OD_FRAME_PREV] = \
                        self.ref_imgi[MC.OD_FRAME_NEXT]
                    self.ref_imgi[MC.OD_FRAME_NEXT] = refi
            # Output via the display reorder queue (cropped planes).
            planes = []
            for pli in range(nplanes):
                xd, yd = info.plane_dec[pli]
                full = self_img.plane_view(pli)
                crop = full[:(info.pic_height + (1 << yd) - 1) >> yd,
                            :(info.pic_width + (1 << xd) - 1) >> xd]
                if fpr:
                    # Round the 12-bit reference down to the output depth
                    # (8/10/12 bits by bitdepth_mode; reference:
                    # src/state.c:138-180 od_img_plane_copy,
                    # od_output_queue_init src/state.c:1127).
                    from daala_tpu_torch.codec.state import internal_to_output
                    depth = 8 + 2 * (info.bitdepth_mode - 1)
                    planes.append(internal_to_output(crop, depth))
                else:
                    planes.append(crop.copy())
        # Coding-order recon, exposed for the encoder's self-check
        # (reference: src/encode.c:3231-3272 reads OD_FRAME_SELF).
        self.last_recon = planes
        from daala_tpu_torch.utils import dump as _dump
        if _dump.images_dir():
            # OD_DUMP_IMAGES analogue: decoded frames in coding order.
            _dump.dump_yuv(_dump.images_dir(), "out", planes, info)
        slot = frame_number % OD_MAX_REORDER
        # A garbage frame_number can collide with an occupied reorder
        # slot; the reference's OD_ASSERT compiles out in release
        # builds and the slot is overwritten, dropping the pending
        # frame (reference: src/state.c od_output_queue_add).
        self._out_slots[slot] = planes
        ready = []
        while self._out_slots[self._out_index] is not None:
            ready.append(self._out_slots[self._out_index])
            self._out_slots[self._out_index] = None
            self._out_index = (self._out_index + 1) % OD_MAX_REORDER
        return ready

    def _decode_dering(self, dec, ctmp, is_keyframe):
        """Parse dering levels and apply the filter (reference:
        src/decode.c:1000-1092)."""
        from daala_tpu_torch.ops import dering as dering_mod
        st = self.state
        info = self.info
        nhdr = st.frame_width >> 6
        nvdr = st.frame_height >> 6
        nplanes = info.nplanes
        base_threshold = float(st.quantizer) ** 0.84182
        levels = np.zeros((nvdr, nhdr), np.int32)
        # The dering input plane is int16 (reference: src/state.h:270 etmp).
        etmp = [c.astype(np.int16) for c in ctmp]
        for sby in range(nvdr):
            for sbx in range(nhdr):
                bsk = st.bskip[0][sby << 4:(sby + 1) << 4,
                                  sbx << 4:(sbx + 1) << 4]
                if np.all(bsk):
                    levels[sby, sbx] = 0
                    continue
                if is_keyframe:
                    left = up = 0
                    if sby > 0:
                        left = up = int(levels[sby - 1, sbx])
                    if sbx > 0:
                        left = int(levels[sby, sbx - 1])
                        if sby == 0:
                            up = left
                    c = up + left
                else:
                    c = 0
                level = decode_cdf_adapt(dec, st.adapt.dering_cdf[c], 6,
                                         st.adapt.dering_increment)
                levels[sby, sbx] = level
                if level:
                    dirs = None
                    use_dev = bool(getattr(self, "use_device_synthesis",
                                           False))
                    if use_dev:
                        from daala_tpu_torch.models import restore as _R
                        filt_fn = functools.partial(_R.od_dering_device,
                                                    device=self.device)
                    else:
                        filt_fn = dering_mod.od_dering
                    for pli in range(nplanes):
                        xdec = info.plane_dec[pli][0]
                        ydec = info.plane_dec[pli][1]
                        ln = 6 - xdec
                        n = 1 << ln
                        threshold = int(
                            dering_mod.OD_DERING_GAIN_TABLE[level]
                            * base_threshold * (1 if pli == 0 else 0.6))
                        out, dirs = filt_fn(
                            etmp[pli], sby, sbx, xdec, pli,
                            st.bskip[pli], threshold, n, dirs=dirs)
                        ctmp[pli][sby << ln:(sby << ln) + n,
                                  sbx << ln:(sbx << ln) + n] = out
        st.dering_level = levels


def _install_accounting(dec):
    """Wrap the EC decoder's symbol methods to record per-symbol bit usage
    (equivalent of OD_ACCOUNTING builds, reference: src/accounting.c).
    Sets dec._accounting so batched native decode paths fall back to
    per-symbol Python calls (otherwise their symbols would be missed)."""
    records = []
    try:
        dec._accounting = True
    except Exception:
        pass
    for name in ("decode_bool_q15", "decode_cdf_q15", "decode_cdf",
                 "decode_cdf_unscaled", "decode_uint", "decode_bits",
                 "decode_cdf_dyadic"):
        orig = getattr(dec, name)

        def wrap(orig=orig, name=name):
            def g(*a, **k):
                t0 = dec.tell_frac()
                r = orig(*a, **k)
                # (label, bits_q3, x, y, layer, level): the location is
                # whatever the pipeline last declared via dec.acct_loc
                # (reference: OD_ACCOUNTING_SET_LOCATION,
                # src/decint.h:63-68, records src/accounting.h:34-46).
                x, y, layer, level = dec.acct_loc
                records.append((name, dec.tell_frac() - t0, x, y, layer,
                                level))
                return r
            return g
        setattr(dec, name, wrap())
    dec.acct_loc = (-1, -1, -1, -1)
    return records
