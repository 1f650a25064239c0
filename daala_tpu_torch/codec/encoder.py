"""Daala-compatible encoder (full intra + inter toolset).

The frame pipeline mirrors od_encode_frame / od_encode_coefficients
(reference: src/encode.c:2963-2961,2539-2860): pad input, motion
estimation + OBMC prediction and MV coding on inter frames, lift to
coefficient domain, frame prefilter, per-superblock DCT pyramid with Haar
DC tree (keyframes), PVQ band search + entropy coding, frame postfilter,
dering RDO.  B-frames (reorder queue depth 0-4), 10/12-bit input,
full-precision references, lossless (Haar wavelet), CBR/2-pass rate
control and complexity gates 0-10 are all supported.

Block-size decision: complexity >= 2 runs the reference's trial-encode
RDO merge pass (od_encode_recursive rdo_only, src/encode.c:1660) with
full EC + adaptation checkpoints; complexity 0-1 uses the open-loop
variance splitter; fixed_bsize overrides for tests.

The coefficient and motion-estimation passes run in the native engine
(native/frame_enc.inc, me_enc.inc), byte-identical to the Python
reference implementation of daala_tpu/codec/encoder.py; the device
front end (models/keyframe.py) precomputes the transform pyramids for
both the RDO and final passes, again byte-identically.

The port's copy of daala_tpu/codec/encoder.py;
tests/test_torch_copies.py holds it to the original.  It is the port's
`Encoder`, with the port's device tier built in where the original has
its JAX one; every other method is the original's:

- `device` ('cuda[:N]' by default, or 'cpu' where the caller asks
  for it) is where the device tier runs; without a card 'cuda'
  raises.  Its two switches carry the original's attribute names:
  - `use_device_analysis` (default True), the byte-identical tier:
    models/keyframe.py computes the RDO trial pass's transform pyramid
    and the final pass's planes on `device` for every frame, and the
    native frame pass consumes them byte-identically;
  - `use_device_pvq` (default False), the lean tier: the final pass's
    analysis stays on `device` as the input of the PVQ band search
    (models/pvqsearch.py search_frame), only its decision table comes
    back, and the native pass replays it (`_device_pvq_tab`) and
    computes its own transforms.  bench.py's `device` configuration is
    use_device_analysis=False, use_device_pvq=True.
  With either on, the full-pel SAD fields of inter frames
  (models/mefield.py) run on `device` and the native motion search
  reads them as exact lookups.  Only the native pass reads the planes,
  so `_encode_coefficients` raises unless it runs, and the original's
  Python coefficient path (`_compute_dcts`, `_block_encode`,
  `_encode_recursive`, the Haar DC quantizers, `_encode_dering`,
  `_dering_rdo`) is left out.
- `mv_refine_mode` 'sweep' runs the colour-sweep MV refinement on
  `device` (mvest.refine_sweep) after the native motion search, where
  the original runs its JAX one; it raises without the native motion
  search.
- With `use_device_analysis`, the dering RDO's candidates (every
  superblock x the 5 gains) are filtered on `device`
  (models/restore.py dering_candidates_device, `_device_dering`) and
  the deferred native dering pass consumes them, byte-identically; the
  lean tier keeps the native engine's dering, as the original's.
- The sharding hook (`device_put_fn`), which the port does not have,
  is left out.
"""

from __future__ import annotations

import copy
import math

import numpy as np

from daala_tpu_torch.codec import headers, quantizer
from daala_tpu_torch.codec.state import (
    CodecState, OD_QM_SIZE, OD_FLAT_QM, OD_HVS_QM, coeff_to_ref_plane,
    img_plane_copy_pad)
from daala_tpu_torch.codec import mc as MC
from daala_tpu_torch.codec import mvest
from daala_tpu_torch.device import resolve
from daala_tpu_torch.utils import logging as LOG
from daala_tpu_torch.entropy import ec as ec_mod
from daala_tpu_torch.entropy.adapt import encode_cdf_adapt
from daala_tpu_torch.ops import _tables as T
from daala_tpu_torch.ops import pvq as P
from daala_tpu_torch.ops.intrin import OD_COEFF_SHIFT

OD_NBSIZES = 5
OD_MAX_REORDER = 16
OD_PVQ_LAMBDA = 0.147

# The native whole-frame coefficient pass (frame_enc.inc) is the only
# one here; with DAALA_TPU_NATIVE_FRAME=0 the encoder raises.
import os as _os
_NATIVE_FRAME_DEFAULT = _os.environ.get("DAALA_TPU_NATIVE_FRAME",
                                        "1") != "0"

# QM interpolation anchors (reference: src/encode.c:117-139).
_QM_ENTRIES = [
    # [use_masking][anchor] = (interp_q, scales per plane, qm rows)
    [(4, (256, 448, 320)), (318, (256, 140, 100)), None],
]


def interp_qm(q, use_masking, pli):
    """od_interp_qm for one plane (reference: src/encode.c:2903-2941)."""
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


class Encoder:
    def __init__(self, info: headers.Info, quant=10, complexity=7,
                 use_activity_masking=True, qm=OD_HVS_QM, use_dering=True,
                 bitrate=0, trial_rate_approx=False,
                 trial_prune_boost=1.0, trial_prune_rate_gate=0.5,
                 trial_prune_gate_kf=0.05, *, device="cuda",
                 mv_refine_mode="greedy", use_device_analysis=True,
                 use_device_pvq=False):
        self.info = info
        self.state = CodecState(info)
        # OD_SET_QUANT semantics (reference: src/encode.c OD_SET_QUANT).
        self.quality = (quant << 4) - 8 if quant > 0 else 0
        if quant < 0:
            self.quality = -1
        from daala_tpu_torch.codec.rate import RateControl
        self.rc = RateControl(self, bitrate)
        # OD_DUMP_BSIZE_DIST analogue (reference: src/encode.c:369-529,
        # 1828-1838, 3176-3186): per-frame chosen 32x32-level RDO
        # distortion per plane, written to the env-named file.  Needs
        # the Python frame path (the env also disables the native one).
        self._bsize_dist = [0.0] * 4
        self._bsize_dist_total = [0.0] * 4
        self._bsize_dist_file = None
        _bd = _os.environ.get("DAALA_TPU_DUMP_BSIZE_DIST")
        if _bd:
            self._bsize_dist_file = open(_bd, "w")
        self.complexity = complexity
        self.use_activity_masking = use_activity_masking
        self.qm_choice = qm
        self.use_dering = use_dering
        self.pvq_norm_lambda = OD_PVQ_LAMBDA
        self.frame_count = 0
        self.ip_frame_count = 0
        # Mesh subdivision depth for the encoder-side ME (reference
        # default mv_level_max = 4, src/encode.c:393).  Level 3 is the
        # measured RD sweet spot of the greedy-split mesh optimizer on
        # mixed content (-1.19% BD-rate vs -0.79% at 2 and -0.85% at 4,
        # ~1% encode time); shallower at low complexity.  Complexity >=
        # 8 switches to the reference-shaped thorough pipeline
        # (mv_decimate=5: subdivide-all -> refine -> decimate ->
        # refine) at level 4, the measured requirement for reference
        # parity on natural-statistics content (BD-rate vs reference:
        # -6.1% smooth / +0.8% texture / +2.6% mixed / -0.0% natural,
        # vs +10.4% natural for the greedy default; ~2.2x encode time).
        if complexity >= 8:
            self.mv_max_level = 4
            self.mv_decimate = 5
        elif complexity >= 7:
            # Default tier: selective-thorough pipeline (decimate=6,
            # me_enc.inc subdivide_sel) — the thorough pipeline's
            # subdivide-all/refine/decimate/refine shape, but forced
            # fine-level (3-4) subdivision only where the coarse mesh
            # leaves concentrated residual (>= mv_sel_gate/16 x the
            # frame-mean 8x8-cell SAD); cold windows keep the coarse
            # mesh.  Measured on the synthetic corpus vs the greedy
            # level-3 default it replaces (tools/rd_compare.py):
            # natural +10.37% -> +0.28%, smooth -9.3% -> -6.3%,
            # texture +0.5%, mixed +0.9% BD-rate at ~1.2-1.3x encode
            # time; the full thorough tier (c>=8) stays at ~2.2x.
            self.mv_max_level = 4
            self.mv_decimate = 6
            self.mv_sel_gate = 16
            # Recoverability bypass: frames whose level-0 (BMA) mesh
            # already predicts within mv_sel_disp/256 of the per-block
            # BMA SAD floor skip the thorough machinery entirely and
            # run the greedy level-3 pipeline — the thorough passes can
            # only recover the OBMC blending gap over that floor, which
            # is negligible under global motion / noise and large at
            # occlusion and parallax boundaries.  Measured at 1080p:
            # the translation clip returns to greedy speed (was 1.67x)
            # while the natural-statistics BD fix is preserved (see
            # tools/rd_compare.py sweeps in the commit log).
            self.mv_sel_disp = 16
        else:
            self.mv_max_level = 3 if complexity >= 6 else 2
            self.mv_decimate = 0
        # Fast trial pass (speed=2): the block-size RDO trial encode
        # evaluates only the PVQ projection candidate (nearest
        # quantized gain/theta) with the closed-form codeword-rate
        # model — the same approximation family the reference trusts
        # for its whole search below complexity 5 (src/encode.c:1359),
        # applied one step further.  Only the trial pass's split
        # decisions are affected; the final pass always searches and
        # codes exactly, so streams stay reference-decodable.  BD-rate
        # cost is within noise (tests/test_fast_trial.py); off by
        # default so the default configuration stays byte-identical to
        # the reference encoder.
        self.trial_rate_approx = bool(trial_rate_approx)
        # Multiplier on the fast trial pass's fitted subtree-prune
        # envelopes (the native kf_prune_thr/if_prune_thr read it from
        # dcfg[3]).  1.0 = the fitted <=3%
        # wrongly-pruned envelopes; larger values trade BD-rate for
        # trial-pass speed (swept in tools/sweep_trial.py — the
        # production preset in bench.py uses the measured knee).  Only
        # read when trial_rate_approx is on.
        self.trial_prune_boost = float(trial_prune_boost)
        # Rate gate on the boosted prune, in q3 (1/8-bit) units per
        # pixel of the node's unsplit trial rate: the boosted envelope
        # only applies to nodes that also coded cheaply (mostly-skip).
        # Native mirror: dcfg[4].
        self.trial_prune_rate_gate = float(trial_prune_rate_gate)
        # Keyframe variant of the rate gate (native mirror: dcfg[5]).
        # Much tighter than the inter gate: on smooth intra content the
        # split's better lapping carries real rate even when the
        # unsplit trial codes near-free (+7.6% BD at 832x480 with the
        # inter gate applied to keyframes, tools/sweep_trial.py), so
        # only true near-skip nodes may take the boosted prune.
        self.trial_prune_gate_kf = float(trial_prune_gate_kf)
        # OD_SET_MV_RES_MIN analogue (reference: daalaenc.h:188,
        # src/mcenc.c:1808,6349): floor on the coded MV resolution
        # (0 = 1/8 pel .. 2 = 1/2 pel).
        self.mv_res_min = 0
        # OD_SET_MV_LEVEL_MIN analogue (reference: daalaenc.h:194,
        # src/mcenc.c:6405): forced mesh-subdivision floor.
        self.mv_level_min = 0
        self.keyframe_rate = info.keyframe_rate
        self.b_frames = 0
        self._pending = []   # display-order frames awaiting coding
        self._display_idx = 0
        self.search_range = 16
        self.ref_imgs = [MC.RefImage(info) for _ in range(4)]
        self.ref_imgi = [-1, -1, -1, -1]
        self.mv_grid = MC.MVGrid(info.frame_width >> 3,
                                 info.frame_height >> 3)
        # --enable-encoder-check equivalent: an embedded decoder
        # re-decodes every packet and the recon planes are compared
        # (reference: src/encode.c:3231-3272).
        self.enable_encoder_check = False
        self._check_dec = None
        # The device tier: the analysis front end (byte-identical tier)
        # or the PVQ band search on its resident output (lean tier), the
        # SAD fields with either, and the colour sweep when
        # mv_refine_mode is "sweep", run on `device`.
        self.device = resolve(device)
        self.use_device_analysis = bool(use_device_analysis)
        self.use_device_pvq = bool(use_device_pvq)
        if not (self.use_device_analysis or self.use_device_pvq):
            raise ValueError("the port's Encoder runs a device tier: set "
                             "use_device_analysis or use_device_pvq")
        self.mv_refine_mode = mv_refine_mode
        # Called right after motion estimation with (frame_count, grid,
        # ctx); None for no hook.
        self.mv_override_cb = None

    @property
    def mv_refine_mode(self):
        """'greedy' (the native engine's refinement) or 'sweep' (the
        colour sweep on `device`, at complexity >= 3)."""
        return self._mv_refine_mode

    @mv_refine_mode.setter
    def mv_refine_mode(self, mode):
        if mode not in ("greedy", "sweep"):
            raise ValueError("mv_refine_mode must be 'greedy' or 'sweep', "
                             "got %r" % (mode,))
        self._mv_refine_mode = mode

    def flush_headers(self):
        return [headers.encode_info_header(self.info),
                headers.encode_comment_header(),
                headers.encode_setup_header()]

    # -- quantizer selection (no rate control; reference:
    #    src/rate.c:776-840) --------------------------------------------

    def _select_quantizers(self, frame_type=0, is_golden=1):
        st = self.state
        if self.rc.target_bitrate > 0:
            # CBR mode (reference: src/rate.c:840-1065).
            lossy_q_min = quantizer.codedquantizer_to_quantizer(1)
            lossy_q_max = quantizer.codedquantizer_to_quantizer(
                quantizer.N_CODED_QUANTIZERS - 1)
            target, base = self.rc.select_quantizer(
                frame_type, is_golden, self.frame_count,
                max(1, self.keyframe_rate), 1, 0, self.quality,
                self.frame_count, lossy_q_min, lossy_q_max)
            self.base_quantizer = base
            self.target_quantizer = target
            st.coded_quantizer = quantizer.quantizer_to_codedquantizer(
                target)
            st.quantizer = quantizer.codedquantizer_to_quantizer(
                st.coded_quantizer)
            self.bs_rdo_lambda = OD_PVQ_LAMBDA * (1.0 / (1 << 3)) * \
                self.target_quantizer ** 2
            self.dering_lambda = 0.67 * OD_PVQ_LAMBDA * \
                self.target_quantizer ** 2
            return
        if self.quality == 0:
            self.base_quantizer = 0
            self.target_quantizer = 0
            st.coded_quantizer = 0
            st.quantizer = 0
            return
        self.base_quantizer = quantizer.quality_to_quantizer(self.quality)
        # Per-frame-type quantizer modulation, exact Q57/Q45/Q33
        # fixed-point path (reference: src/rate.c:796-838; constants
        # src/encint.h:68-73: MQP I/P/B = 1.0/1.05/1.1, DQP = -2/0/+1,
        # golden P modulated like I).
        from daala_tpu_torch.codec.rate import blog64, bexp64
        MQP_Q12 = (4096, int(1.05 * 4096), int(1.1 * 4096), 4096)
        DQP_Q45 = ((-2) << 45, 0, 1 << 45, (-2) << 45)
        subtype = 3 if (is_golden and frame_type == 1) else frame_type
        lossy_q_min = quantizer.codedquantizer_to_quantizer(1)
        lossy_q_max = quantizer.codedquantizer_to_quantizer(
            quantizer.N_CODED_QUANTIZERS - 1)
        log_q = blog64(self.base_quantizer) - (OD_COEFF_SHIFT << 57)
        log_q >>= 36                                       # Q21
        log_q *= 0x0064EB                                  # Q33
        log_q += 0x0000C7851EB851EC >> 12                  # Q33
        log_q *= MQP_Q12[subtype]                          # Q45
        log_q += DQP_Q45[subtype]
        log_q = (log_q - 0x0000C7851EB851EC) * 0x000289 \
            + (OD_COEFF_SHIFT << 57)
        self.target_quantizer = min(max(lossy_q_min, bexp64(log_q)),
                                    lossy_q_max)
        cq45 = (quantizer.quantizer_to_codedquantizer(self.base_quantizer)
                << 33) * MQP_Q12[subtype] + DQP_Q45[subtype]
        st.coded_quantizer = min(max(1, cq45 >> 45),
                                 quantizer.N_CODED_QUANTIZERS - 1)
        st.quantizer = quantizer.codedquantizer_to_quantizer(
            st.coded_quantizer)
        self.bs_rdo_lambda = OD_PVQ_LAMBDA * (1.0 / (1 << 3)) * \
            self.target_quantizer ** 2
        self.dering_lambda = 0.67 * OD_PVQ_LAMBDA * self.target_quantizer ** 2

    # -- EC + adaptation checkpointing (reference: src/encode.c:742-750) ----

    def _checkpoint_full(self):
        """Full EC + adaptation checkpoint for block-size RDO, matching the
        reference's od_encode_checkpoint (reference: src/encode.c:742-750),
        which memcpys the whole od_adapt_ctx."""
        return (self.enc.checkpoint(), self.state.adapt.snapshot())

    def _rollback_full(self, cp):
        self.enc.rollback(cp[0])
        self.state.adapt.restore(cp[1])

    def _select_mv_res(self, cur_luma):
        """Choose the frame's MV resolution (0 = 1/8 pel .. 2 = 1/2 pel)
        by RD over the whole-frame OBMC prediction, mirroring the intent
        of od_mv_subpel_refine's resolution loop (reference:
        src/mcenc.c:6349-6380): start coarse, keep refining only while
        the prediction gain beats the MV rate cost.  The grid's MVs are
        rounded in place to the chosen resolution."""
        grid = self.mv_grid
        info = self.info
        h, w = info.pic_height, info.pic_width
        cur = cur_luma[:h, :w].astype(np.int32)
        ref_imgs = self.ref_imgs
        if info.full_precision_references:
            # Decide on 8-bit shadows (non-normative selection).
            ref_imgs = [None if r is None else _shadow8(r)
                        for r in self.ref_imgs]
        # Reference mv lambda (src/rate.c:1072-1075), Q22 constant.
        lam = max(40, (145000 * self.target_quantizer) >> 20)
        saved_mv = grid.mv.copy()
        saved_mv1 = grid.mv1.copy()
        scratch_info = info
        if info.full_precision_references:
            import dataclasses
            scratch_info = dataclasses.replace(
                info, full_precision_references=0)
        scratch = MC.RefImage(scratch_info)
        sre = mvest.mv_small_rate_est(self.state.adapt)
        frame_type = self.state.frame_type
        best = None
        res_min = getattr(self, "mv_res_min", 0)
        for res in (2, 1, 0):
            if res < res_min:
                continue
            if res:
                half = 1 << (res - 1)
                grid.mv[:] = ((saved_mv + half) >> res) << res
                grid.mv1[:] = ((saved_mv1 + half) >> res) << res
            else:
                np.copyto(grid.mv, saved_mv)
                np.copyto(grid.mv1, saved_mv1)
            MC.mc_predict_frame(grid, ref_imgs, self.ref_imgi, info,
                                scratch)
            pred = scratch.plane_view(0)
            sad = int(np.abs(pred[:h, :w].astype(np.int32) - cur).sum())
            rate8 = mvest.grid_rate_q3(grid, sre, res, frame_type)
            cost = (sad << 5) + lam * rate8
            if best is None or cost < best[0]:
                best = (cost, res, grid.mv.copy(), grid.mv1.copy())
        _, res, mv, mv1 = best
        np.copyto(grid.mv, mv)
        np.copyto(grid.mv1, mv1)
        return res

    # -- MV mesh encode (reference: src/encode.c:1847-1896,2441-2527) ------

    def _encode_mv(self, enc, num_refs, vx, vy, level, mv_res, range_x,
                   range_y):
        st = self.state
        grid = self.mv_grid
        ref = int(grid.ref[vy, vx])
        if num_refs > 1:
            ref_offset = 1 if st.frame_type == 2 else 0
            ref_pred = MC.get_ref_predictor(grid, st.frame_type, vx, vy,
                                            level) - ref_offset
            encode_cdf_adapt(enc, ref - ref_offset,
                             st.adapt.mv_ref_cdf[ref_pred], num_refs, 256)
        pred, equal_mvs = MC.get_predictor(grid, vx, vy, level, mv_res, ref)
        if ref == MC.OD_FRAME_NEXT:
            ox = (int(grid.mv1[vy, vx, 0]) >> mv_res) - pred[0]
            oy = (int(grid.mv1[vy, vx, 1]) >> mv_res) - pred[1]
        else:
            ox = (int(grid.mv[vy, vx, 0]) >> mv_res) - pred[0]
            oy = (int(grid.mv[vy, vx, 1]) >> mv_res) - pred[1]
        model = st.adapt.mv_model
        sym = min(abs(oy), 3) * 4 + min(abs(ox), 3)
        encode_cdf_adapt(enc, sym, st.adapt.mv_small_cdf[equal_mvs], 16,
                         st.adapt.mv_small_increment)
        if abs(ox) >= 3:
            st.adapt.mv_ex[level] = model.encode(
                enc, abs(ox) - 3, range_x, st.adapt.mv_ex[level], 6)
        if abs(oy) >= 3:
            st.adapt.mv_ey[level] = model.encode(
                enc, abs(oy) - 3, range_y, st.adapt.mv_ey[level], 6)
        if abs(ox):
            enc.encode_bits(1 if ox < 0 else 0, 1)
        if abs(oy):
            enc.encode_bits(1 if oy < 0 else 0, 1)

    def _encode_mvs(self, enc, num_refs, mv_res=0):
        st = self.state
        grid = self.mv_grid
        nhmvbs = grid.nhmvbs
        nvmvbs = grid.nvmvbs
        enc.encode_uint(mv_res, 3)
        st.adapt.set_mv_res(mv_res)
        # Note the reference's extra <<1 on the range here vs the decoder
        # (reference: src/encode.c:2463-2464); kept for parity.
        range_x = (self.info.frame_width + 32) << ((3 - mv_res) + 1)
        range_y = (self.info.frame_height + 32) << ((3 - mv_res) + 1)
        D0 = MC.OD_MVB_DELTA0
        for vy in range(0, nvmvbs + 1, D0):
            for vx in range(0, nhmvbs + 1, D0):
                self._encode_mv(enc, num_refs, vx, vy, 0, mv_res, range_x,
                                range_y)
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
                        encode_cdf_adapt(enc, int(grid.valid[vy, vx]), cdf,
                                         2, st.adapt.split_flag_increment)
                        if grid.valid[vy, vx]:
                            self._encode_mv(enc, num_refs, vx, vy, level,
                                            mv_res, range_x, range_y)
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
                        encode_cdf_adapt(enc, int(grid.valid[vy, vx]), cdf,
                                         2, st.adapt.split_flag_increment)
                        if grid.valid[vy, vx]:
                            self._encode_mv(enc, num_refs, vx, vy, level,
                                            mv_res, range_x, range_y)
            level += 1
            log_mvb_sz -= 1

    # -- keyframe DC tree ---------------------------------------------------

    # -- DCT pyramid (reference: src/encode.c:1455-1513) --------------------

    # -- block encode (reference: src/encode.c:1229-1453) -------------------

    # -- recursive encode (reference: src/encode.c:1660-1845) ---------------

    # -- frame encode -------------------------------------------------------

    def encode_frame(self, planes_u8):
        """Push one display-order frame; returns the list of packets
        ready (with B-frames, packets can lag or batch).

        With bitdepth_mode 2/3 the planes are uint16 10/12-bit samples;
        they are shifted up into the 12-bit internal input format here
        (reference: od_input_queue_add + od_img_plane_copy,
        src/encode.c:212-218, src/state.c:146-158)."""
        if self.info.bitdepth_mode != 1:
            from daala_tpu_torch.codec.state import img_plane_to_internal
            depth = 8 + 2 * (self.info.bitdepth_mode - 1)
            planes_u8 = [img_plane_to_internal(np.asarray(p), depth)
                         for p in planes_u8]
        self._pending.append((self._display_idx, planes_u8))
        self._display_idx += 1
        out = []
        delay = self.b_frames + 1
        if self._display_idx == 1:
            d, fr = self._pending.pop(0)
            out.append(self._encode_one(fr, 0, d))
        elif len(self._pending) == delay:
            # Code the last frame of the group as I/P, then the ones in
            # between as B (open-GOP batching, reference:
            # src/encode.c:240-366).
            d, fr = self._pending[-1]
            out.append(self._encode_one(fr, self._closed_form_type(), d))
            for d, fr in self._pending[:-1]:
                out.append(self._encode_one(fr, 2, d))
            self._pending = []
        return out

    def flush(self):
        """Drain remaining queued frames (end of input)."""
        out = []
        if self._pending:
            d, fr = self._pending[-1]
            out.append(self._encode_one(fr, self._closed_form_type(), d))
            for d, fr in self._pending[:-1]:
                out.append(self._encode_one(fr, 2, d))
            self._pending = []
        if self._bsize_dist_file is not None:
            # Final totals row (reference: daala_encode_free,
            # src/encode.c:3176-3186).
            import math as _math
            self._bsize_dist_file.write("Total: ")
            for pli in range(self.info.nplanes):
                v = self._bsize_dist_total[pli]
                self._bsize_dist_file.write(
                    "%-7G\t" % (10 * _math.log10(v) if v > 0
                                else float("-inf")))
            self._bsize_dist_file.write("\n")
            self._bsize_dist_file.flush()
        return out

    def _closed_form_type(self):
        """I or P for the group-ending frame (open GOP: I every
        keyframe_rate coded frames)."""
        if self.keyframe_rate <= 1:
            return 0
        ft, _, _ = self.rc.frame_type(self.frame_count,
                                      max(1, self.keyframe_rate),
                                      self.b_frames + 1, self.b_frames)
        return 0 if ft == 0 else 1

    def _bs_prune_enabled(self):
        """Block-size RDO subtree pruning (BS_PRUNE_THR): on by default
        up to complexity 7; complexity >= 8 keeps the exhaustive trial
        tree (the thorough pipeline).  Set the bs_prune attribute to
        force it on/off."""
        v = getattr(self, "bs_prune", None)
        if v is not None:
            return bool(v)
        return self.complexity <= 7

    def _mv_refine_iters(self):
        """Iterations of the rate-aware MV refinement sweep: the greedy
        coordinate descent needs ~4 passes to converge (BD-rate on
        motion-heavy content improves ~1.5% going 2 -> 4 and another
        ~4% by 8) at ~5% encode time per extra pass."""
        it = getattr(self, "mv_refine_iters", None)
        if it is not None:
            return it
        if self.complexity >= 9:
            return 8
        if getattr(self, "mv_decimate", 0) == 6:
            # Selective-thorough default tier: the refine pass runs
            # twice (pre- and post-decimation), so 2 iterations each
            # converge like the greedy tier's single 4-pass run
            # (natural-class sweeps: 4+4 buys 0.3% bits at +28% time).
            return 2
        if self.complexity >= 5:
            return 4
        return 2

    def _native_adapt_ptrs(self):
        """Pointer table into the numpy-backed adaptation state for the
        native frame coder (adapt.native_ptr_table; layout:
        frame_enc.inc AdaptPtrs::load)."""
        from daala_tpu_torch.entropy.adapt import native_ptr_table
        return native_ptr_table(self.state.adapt)

    def _encode_coefficients_native(self, padded_in, self_img, is_keyframe,
                                    use_haar_wavelet, rdo_only):
        """One-call native frame coefficient pass (frame_enc.inc
        fc_encode_frame), byte-identical to the Python implementation
        below (tests/test_frame_native.py)."""
        from daala_tpu_torch import native as native_mod
        lib = native_mod.get_lib()
        st = self.state
        info = self.info
        nplanes = 1 if rdo_only else info.nplanes
        pvq_qm = np.zeros((4, 30), np.int32)
        for pli in range(info.nplanes):
            pvq_qm[pli, :] = st.pvq_qm_q4[pli]
        cfg = np.zeros(80, np.int64)
        cfg[0] = nplanes
        cfg[1] = st.frame_width
        cfg[2] = st.frame_height
        cfg[3] = info.pic_width
        cfg[4] = info.pic_height
        cfg[5] = st.nhsb
        cfg[6] = st.nvsb
        cfg[7] = st.quantizer
        cfg[8] = st.coded_quantizer
        cfg[9] = quantizer.N_CODED_QUANTIZERS
        cfg[10] = 1 if is_keyframe else 0
        cfg[11] = 1 if use_haar_wavelet else 0
        cfg[12] = rdo_only
        cfg[13] = 1 if self.use_activity_masking else 0
        cfg[14] = 1 if self.qm_choice == 0 else 0
        cfg[15] = 1 if self.use_dering else 0
        cfg[16] = st.frame_type
        cfg[17] = self.complexity
        cfg[18] = st.bsize.ctypes.data
        cfg[19] = st.bsize.strides[0]
        cfg[20] = st.qm.ctypes.data
        cfg[21] = st.qm_inv.ctypes.data
        cfg[22] = pvq_qm.ctypes.data
        cfg[23] = st.dering_level.ctypes.data
        keep = [pvq_qm]
        ctmp = []
        for pli in range(nplanes):
            xd, yd = info.plane_dec[pli]
            out_c = np.zeros((st.frame_height >> yd,
                              st.frame_width >> xd), np.int32)
            ctmp.append(out_c)
            mc = None
            if not is_keyframe:
                mc = np.ascontiguousarray(self_img.plane_view(pli))
                keep.append(mc)
            cfg[24 + 6 * pli] = padded_in[pli].ctypes.data
            cfg[25 + 6 * pli] = 0 if mc is None else mc.ctypes.data
            cfg[26 + 6 * pli] = out_c.ctypes.data
            cfg[27 + 6 * pli] = st.bskip[pli].ctypes.data
            pre_d = getattr(self, "_device_d", None)
            pre_md = getattr(self, "_device_md", None)
            if (pre_d is not None and not rdo_only
                    and not use_haar_wavelet
                    and (is_keyframe or pre_md is not None)):
                dd = np.ascontiguousarray(pre_d[pli], np.int32)
                keep.append(dd)
                cfg[28 + 6 * pli] = dd.ctypes.data
                if not is_keyframe:
                    mdd = np.ascontiguousarray(pre_md[pli], np.int32)
                    keep.append(mdd)
                    cfg[58 + pli] = mdd.ctypes.data
            cfg[29 + 6 * pli] = st.sb_dc_mem[pli].ctypes.data
            cfg[48 + 2 * pli] = xd
            cfg[49 + 2 * pli] = yd
        # Device RDO transform pyramid for the luma trial pass
        # (frame_enc.inc Frame::pre_rd/pre_rmd/pre_d_rdo).
        rdo_pyr = getattr(self, "_device_rdo", None)
        if rdo_pyr is not None and rdo_only and not use_haar_wavelet:
            d_l, md_l, d_m = rdo_pyr
            for l in range(5):
                dd = np.ascontiguousarray(d_l[l], np.int32)
                keep.append(dd)
                cfg[62 + l] = dd.ctypes.data
                if md_l is not None:
                    mdd = np.ascontiguousarray(md_l[l], np.int32)
                    keep.append(mdd)
                    cfg[67 + l] = mdd.ctypes.data
            if d_m is not None:
                dm = np.ascontiguousarray(d_m, np.int32)
                keep.append(dm)
                cfg[72] = dm.ctypes.data
        # Full-precision buffer modes (frame_enc.inc Frame::in_fpr/mc_fpr):
        # input planes are 12-bit uint16 only with high-depth input;
        # reference (MC prediction) planes are 12-bit whenever FPR is on.
        if padded_in[0].dtype == np.uint16:
            cfg[56] = info.bitdepth_mode
        if info.full_precision_references:
            cfg[57] = info.bitdepth_mode
        dcfg = np.array([self.pvq_norm_lambda,
                         getattr(self, "bs_rdo_lambda", 0.0),
                         getattr(self, "dering_lambda", 0.0),
                         getattr(self, "trial_prune_boost", 1.0),
                         getattr(self, "trial_prune_rate_gate", 0.5),
                         getattr(self, "trial_prune_gate_kf", 0.05)],
                        np.float64)
        # Device dering: defer the native dering stage, batch the 5
        # filtered gain candidates for every superblock on `device`
        # (models/restore.py dering_candidates_device), then let the
        # native RDO/signaling pass consume them — byte-identical.
        defer_dering = (getattr(self, "_device_dering", False)
                        and not rdo_only and not use_haar_wavelet
                        and self.use_dering and st.quantizer != 0)
        if defer_dering:
            cfg[73] = 1
        cfg[76] = 1 if self._bs_prune_enabled() else 0
        cfg[78] = 1 if self.trial_rate_approx else 0
        # Device PVQ decision table (models/pvqsearch.py): flatten the
        # per-(block, band) decisions into dense arrays so the native
        # EC pass replays them through ec_pvq_theta_forced — keeping
        # the C++ entropy throughput AND the device search.
        tab = getattr(self, "_device_pvq_tab", None)
        if (tab is not None and not rdo_only
                and not use_haar_wavelet):
            # Vectorized flattening (models/pvqsearch.py
            # DevicePVQTable.native_arrays): per-plane 4x4 grids,
            # concatenated (the native side derives the same plane
            # base offsets from F.pl dims).
            idx, meta, yoff, ypool, sd = tab.native_arrays(st, info)
            idx = np.ascontiguousarray(idx, np.int32)
            meta = np.ascontiguousarray(meta, np.int32)
            yoff = np.ascontiguousarray(yoff, np.int64)
            ypool = np.ascontiguousarray(ypool, np.int32)
            sd = np.ascontiguousarray(sd, np.float64)
            tabp = np.array([idx.ctypes.data, meta.ctypes.data,
                             yoff.ctypes.data, ypool.ctypes.data,
                             sd.ctypes.data], np.int64)
            keep.extend([idx, meta, yoff, ypool, sd, tabp])
            cfg[77] = tabp.ctypes.data
        ap = self._native_adapt_ptrs()
        err = lib.fc_encode_frame(self.enc._h, ap.ctypes.data,
                                  cfg.ctypes.data, dcfg.ctypes.data)
        if err:
            raise RuntimeError("native frame encode: EC error %d" % err)
        if defer_dering:
            from daala_tpu_torch.models import restore as R
            nvdr = st.frame_height >> 6
            nhdr = st.frame_width >> 6
            cands, dirs = R.dering_candidates_device(
                ctmp[0].astype(np.int16), st.bskip[0], st.quantizer,
                nvdr, nhdr, device=self.device)
            cands = np.ascontiguousarray(cands, np.int16)
            dirs = np.ascontiguousarray(dirs, np.int32)
            cfg[74] = cands.ctypes.data
            cfg[75] = dirs.ctypes.data
            err = lib.fc_encode_dering(self.enc._h, ap.ctypes.data,
                                       cfg.ctypes.data,
                                       dcfg.ctypes.data)
            if err:
                raise RuntimeError(
                    "native dering encode: EC error %d" % err)
        del keep
        return ctmp

    def _encode_coefficients(self, padded_in, self_img, is_keyframe,
                             use_haar_wavelet, planes_u8, rdo_only=0):
        """od_encode_coefficients (reference: src/encode.c:2539-2855),
        through the native frame pass, which consumes the device
        analysis (the original's Python path would ignore it).

        With rdo_only=1, runs the luma-only block-size RDO pass: coeffs
        are coded for rate measurement and all coded state is rolled
        back by the caller; the merged bsize/bskip maps persist as the
        pass's output (reference: od_split_superblocks_rdo,
        src/encode.c:2942-2948)."""
        if not (getattr(self, "use_native_frame", _NATIVE_FRAME_DEFAULT)
                and hasattr(self.enc, "_h")
                and self._bsize_dist_file is None):
            raise RuntimeError(
                "daala_tpu_torch's Encoder needs the native frame pass "
                "(the only consumer of its analysis planes): native engine "
                "missing, DAALA_TPU_NATIVE_FRAME=0 or "
                "DAALA_TPU_DUMP_BSIZE_DIST set")
        return self._encode_coefficients_native(
            padded_in, self_img, is_keyframe, use_haar_wavelet, rdo_only)

    def _encode_one(self, planes_u8, frame_type, display_order):
        st = self.state
        info = self.info
        self._orig_coeff_luma = None
        if self.ref_imgi[MC.OD_FRAME_PREV] < 0:
            frame_type = 0
        if self.quality == 0 and frame_type == 2:
            # Lossless B-frames are not implemented (the haar wavelet
            # inter path covers single-reference P frames); code them
            # as P instead.
            frame_type = 1
        is_keyframe = frame_type == 0
        st.frame_type = frame_type
        is_golden = is_keyframe or (frame_type != 2
                                    and self.ip_frame_count % 10 == 0)
        self._select_quantizers(frame_type, int(is_golden))
        use_haar_wavelet = st.quantizer == 0
        num_refs = 0
        if frame_type == 1:
            num_refs = 1
        elif frame_type == 2:
            num_refs = 2  # PREV + NEXT per-vertex selection
        # Reference rotation before coding (reference:
        # src/encode.c:2984-2990).
        if self.b_frames != 0 and frame_type == 1:
            self.ref_imgi[MC.OD_FRAME_PREV] = self.ref_imgi[MC.OD_FRAME_NEXT]
        # P frames code two references (PREV + GOLD) unless they are the
        # same image (reference: src/encode.c:3007-3017).
        if (frame_type == 1
                and self.ref_imgi[MC.OD_FRAME_GOLD] >= 0
                and self.ref_imgi[MC.OD_FRAME_GOLD]
                    != self.ref_imgi[MC.OD_FRAME_PREV]):
            num_refs = 2
        # Select a free SELF slot (reference: src/encode.c:2999-3002).
        refi = 0
        while refi in (self.ref_imgi[MC.OD_FRAME_GOLD],
                       self.ref_imgi[MC.OD_FRAME_PREV],
                       self.ref_imgi[MC.OD_FRAME_NEXT]):
            refi += 1
        self.ref_imgi[MC.OD_FRAME_SELF] = refi
        self_img = self.ref_imgs[refi]
        self.enc = enc = ec_mod.Encoder()
        # Frame flags (reference: src/encode.c:3031-3051).
        enc.encode_bool_q15(0, 16384)
        enc.encode_bool_q15(1 if is_keyframe else 0, 16384)
        if not is_keyframe:
            enc.encode_bool_q15(1 if frame_type == 2 else 0, 16384)
            enc.encode_uint(num_refs - 1, 2)  # OD_MAX_CODED_REFS
        enc.encode_uint(display_order % OD_MAX_REORDER, OD_MAX_REORDER)
        enc.encode_bool_q15(1 if self.use_activity_masking else 0, 16384)
        enc.encode_bool_q15(self.qm_choice, 16384)
        enc.encode_bool_q15(1 if use_haar_wavelet else 0, 16384)
        enc.encode_bool_q15(1 if is_golden else 0, 16384)
        st.update_qm(self.qm_choice)
        if is_keyframe:
            # QM interpolation + signaling (reference:
            # src/encode.c:3052-3079).
            for pli in range(info.nplanes):
                st.pvq_qm_q4[pli] = interp_qm(self.base_quantizer,
                                              self.use_activity_masking,
                                              pli)
            for pli in range(info.nplanes):
                for i in range(OD_QM_SIZE):
                    enc.encode_bits(st.pvq_qm_q4[pli][i], 8)
        st.adapt.reset(is_keyframe)
        # Pad the input planes once (reference: daala_image_copy_pad).
        nplanes = info.nplanes
        fw, fh = st.frame_width, st.frame_height
        padded_in = []
        for pli in range(nplanes):
            xd, yd = info.plane_dec[pli]
            pw, ph = fw >> xd, fh >> yd
            pic_w = (info.pic_width + (1 << xd) - 1) >> xd
            pic_h = (info.pic_height + (1 << yd) - 1) >> yd
            padded_in.append(img_plane_copy_pad(planes_u8[pli], pw, ph,
                                                pic_w, pic_h))
        # The non-normative searches (ME, open-loop block-size) run on
        # 8-bit data; with high-depth input use a rounded-down shadow
        # (the same non-normative choice as the FPR reference shadows).
        search_luma = padded_in[0]
        if search_luma.dtype == np.uint16:
            search_luma = np.clip(
                (search_luma.astype(np.int32) + (1 << 4 >> 1)) >> 4,
                0, 255).astype(np.uint8)
        if not is_keyframe:
            # Motion estimation + OBMC prediction into SELF.
            lam_mv = max(40, (145000 * self.target_quantizer) >> 20)
            if self.b_frames:
                # Reference B-frame lambda scaling (src/mcenc.c:6411-6418).
                lam_mv = int(lam_mv * 1.30)
            refs = [(MC.OD_FRAME_PREV,
                     self.ref_imgs[self.ref_imgi[MC.OD_FRAME_PREV]])]
            if frame_type == 2:
                refs.append((MC.OD_FRAME_NEXT,
                             self.ref_imgs[self.ref_imgi[
                                 MC.OD_FRAME_NEXT]]))
            elif num_refs > 1 and lam_mv < 150:
                # Golden-frame reference for P frames; at very high
                # lambdas the multiref signaling overhead is too high
                # (reference: src/mcenc.c:6472-6479).
                refs.append((MC.OD_FRAME_GOLD,
                             self.ref_imgs[self.ref_imgi[
                                 MC.OD_FRAME_GOLD]]))
            if info.full_precision_references:
                # The search (non-normative) runs on 8-bit shadows of the
                # 12-bit references; the normative OBMC prediction below
                # uses the true full-precision planes.
                refs = [(ri, _shadow8(rimg)) for ri, rimg in refs]
            vis = (info.pic_height, info.pic_width)
            # Threshold models the split-flag + MV-delta cost at the
            # reference's mv lambda (src/rate.c:1072-1075).  The
            # lam_sad_scale knob scales the subdivision acceptance
            # margin; sweeps on the natural-statistics corpus put 2x
            # within noise of 1x (−0.4pp natural, +0.3pp mixed), so the
            # default stays at the modeled value.
            lam_sad = max(16, (self.target_quantizer * 11) >> 7)
            lam_sad = int(lam_sad * getattr(self, "lam_sad_scale", 1))
            fp_fields = None
            if self.use_device_analysis or self.use_device_pvq:
                # Device full-pel SAD fields (models/mefield.py): the
                # BMA window costs batch on `device`; the native search
                # consumes them as exact lookups, decisions unchanged.
                from daala_tpu_torch.models import mefield as MF
                fp_fields = MF.fullpel_sad_fields(
                    search_luma,
                    [rimg.planes[0] for _, rimg in refs],
                    MC.OD_BUFFER_PADDING, vis, self.mv_grid.nvmvbs,
                    self.mv_grid.nhmvbs, r=self.search_range,
                    device=self.device)
            # "sweep" runs the refinement as batched device color
            # sweeps (mvest.refine_sweep) instead of the host greedy
            # loop; BMA + mesh subdivision stay in the native engine.
            sweep = self.mv_refine_mode == "sweep" and self.complexity >= 3
            use_native_me = (getattr(self, "use_native_me",
                                     _NATIVE_FRAME_DEFAULT)
                             and mvest.estimate_all_native(
                                 self.mv_grid, search_luma, refs, info,
                                 self.search_range, lam_mv, st.adapt, vis,
                                 self.complexity, lam_sad, frame_type,
                                 max_level=self.mv_max_level,
                                 iters=0 if sweep
                                 else self._mv_refine_iters(),
                                 decimate=getattr(self, "mv_decimate",
                                                  0),
                                 min_level=self.mv_level_min,
                                 fp_fields=fp_fields,
                                 telescope=getattr(self, "mv_telescope",
                                                   0),
                                 use_satd=getattr(self, "mv_satd", 0),
                                 sel_gate_q4=getattr(self, "mv_sel_gate",
                                                     0),
                                 sel_disp_q8=getattr(self, "mv_sel_disp",
                                                     0)))
            if sweep:
                if not use_native_me:
                    raise RuntimeError(
                        "mv_refine_mode='sweep' needs the native motion "
                        "search (use_native_me and the native engine)")
                mvest.refine_sweep(
                    self.mv_grid, search_luma, refs, info, lam_mv,
                    st.adapt, vis, frame_type,
                    iters=self._mv_refine_iters(), device=self.device,
                    decimate=getattr(self, "mv_decimate", 0))
            if not use_native_me:
                mvest.estimate_multi(self.mv_grid, search_luma, refs,
                                     info, self.search_range, lam=lam_mv,
                                     adapt=st.adapt, vis=vis)
                if self.complexity >= 2:
                    # Adaptive mesh subdivision (reference: the
                    # decimation + refinement stages of od_mv_est,
                    # src/mcenc.c:4019,5211; here redesigned as greedy
                    # splitting, see mvest.refine_mesh).
                    mvest.refine_mesh(self.mv_grid, search_luma,
                                      dict(refs), info, lam_sad, vis=vis,
                                      max_level=self.mv_max_level,
                                      lam=lam_mv, adapt=st.adapt,
                                      frame_type=frame_type,
                                      min_level=self.mv_level_min)
                    if self.complexity >= 3:
                        # Rate-aware OBMC refinement with the reference's
                        # MV lambda (src/rate.c:1072-1075).
                        mvest.refine_mvs(self.mv_grid, search_luma,
                                         dict(refs), info, lam_mv,
                                         adapt=st.adapt,
                                         frame_type=frame_type, vis=vis,
                                         iters=self._mv_refine_iters())
            hook = getattr(self, "mv_override_cb", None)
            if hook is not None:
                hook(self.frame_count, self.mv_grid,
                     dict(refs=refs, padded_in=padded_in, info=info,
                          vis=vis, lam_mv=lam_mv, lam_sad=lam_sad,
                          adapt=st.adapt, frame_type=frame_type))
            mv_res = None
            if use_native_me:
                # _select_mv_res uses the unscaled mv lambda
                # (src/rate.c:1072-1075), without the B-frame factor.
                lam_res = max(40, (145000 * self.target_quantizer) >> 20)
                mv_res = mvest.select_mv_res_native(
                    self.mv_grid, search_luma, refs, info, lam_res,
                    st.adapt, vis, st.frame_type,
                    res_min=self.mv_res_min)
            if mv_res is None:
                mv_res = self._select_mv_res(search_luma)
            MC.mc_predict_frame(self.mv_grid, self.ref_imgs, self.ref_imgi,
                                info, self_img)
            self._encode_mvs(enc, num_refs, mv_res=mv_res)
        # Block size decision (reference: src/encode.c:3086-3096):
        # complexity >= 2 runs the full trial-encode RDO merge pass from
        # an all-4x4 map; complexity 0-1 uses the open-loop variance
        # splitter; fixed_bsize overrides for tests.
        # The device analysis front end (use_device_analysis) runs for
        # every frame but the Haar-wavelet (lossless keyframe) ones.
        device_on = self.use_device_analysis and not use_haar_wavelet
        self._device_rdo = None
        # Device dering: the RDO gain candidates batch on `device`
        # (consumed by the deferred native dering pass).
        self._device_dering = device_on
        if use_haar_wavelet:
            st.init_superblock_split(4)
        elif hasattr(self, "fixed_bsize"):
            st.init_superblock_split(self.fixed_bsize)
        elif self.complexity >= 2:
            st.init_superblock_split(0)
            if device_on:
                # Device RDO transform pyramid: the trial pass's forward
                # transforms are decision-independent, so they batch as
                # one device pass (models/keyframe.py rdo_pyramid_luma).
                from daala_tpu_torch.models import keyframe as KF
                mc_pl = None
                if not is_keyframe:
                    mc_pl = [self_img.plane_view(0)]
                self._device_rdo = KF.analyze_rdo_pyramid(
                    st, info, padded_in, mc_pl, st.quantizer == 0,
                    self.device)
            cp = self._checkpoint_full()
            self._encode_coefficients(padded_in, self_img, is_keyframe,
                                      use_haar_wavelet, planes_u8,
                                      rdo_only=1)
            self._rollback_full(cp)
            self._device_rdo = None
        else:
            from daala_tpu_torch.codec import blocksize
            pred_luma = None
            if not is_keyframe:
                pred_luma = self_img.plane_view(0)
                if pred_luma.dtype == np.uint16:
                    # Shadow the full-precision prediction down to the
                    # 8-bit scale of the open-loop split metric.
                    pred_luma = np.clip(
                        (pred_luma.astype(np.int32) + (1 << 4 >> 1)) >> 4,
                        0, 255).astype(np.uint8)
            blocksize.split_superblocks(st, search_luma, pred_luma,
                                        st.quantizer)
        # Device analysis front end (models/keyframe.py): the frame's
        # DCT pyramid on `device` for the final pass (the block-size map
        # is final here at every complexity).  Two tiers:
        #   use_device_analysis: the native frame pass consumes the
        #     fetched planes byte-identically;
        #   use_device_pvq: the planes stay on `device` as the input of
        #     the PVQ band search (models/pvqsearch.py); only its
        #     decision table comes back and the native pass computes its
        #     own transforms.
        self._device_d = None
        self._device_md = None
        self._device_pvq_tab = None
        device_search = (self.use_device_pvq
                         and not use_haar_wavelet
                         and st.quantizer != 0)
        if device_on or device_search:
            from daala_tpu_torch.models import keyframe as KF
            dev_d = dev_md = None
            if is_keyframe:
                dev_d, fetch_np = KF.analyze_keyframe(
                    st, info, padded_in, st.quantizer == 0, self.device)
            else:
                # Inter front-end: input + OBMC prediction through the
                # same device transform pipeline.
                mc_planes = [self_img.plane_view(pli)
                             for pli in range(info.nplanes)]
                dev_d, dev_md, fetch_np = KF.analyze_inter(
                    st, info, padded_in, mc_planes, st.quantizer == 0,
                    self.device)
            # Device PVQ band search, queued on the still-resident
            # analysis coefficients and finished after the analysis
            # fetch (reference search: src/pvq_encoder.c:333).
            finish_pvq = None
            if device_search:
                from daala_tpu_torch.models import pvqsearch as PS
                finish_pvq = PS.search_frame(
                    st, info, st.quantizer, dev_d, dev_md,
                    self.pvq_norm_lambda, is_keyframe=bool(is_keyframe),
                    use_masking=bool(self.use_activity_masking))
            if device_on:
                if is_keyframe:
                    self._device_d = fetch_np()
                else:
                    self._device_d, self._device_md = fetch_np()
            if finish_pvq is not None:
                self._device_pvq_tab = finish_pvq()
        ctmp = self._encode_coefficients(padded_in, self_img, is_keyframe,
                                         use_haar_wavelet, planes_u8,
                                         rdo_only=0)
        self._device_d = None
        self._device_md = None
        self._device_pvq_tab = None
        # Store the reconstruction into SELF + rotate references.
        fpr = bool(info.full_precision_references)
        for pli in range(nplanes):
            self_img.plane_view(pli)[:, :] = coeff_to_ref_plane(
                ctmp[pli], st.quantizer == 0, fpr=fpr,
                bitdepth_mode=info.bitdepth_mode)
        self_img.edge_ext()
        if is_golden:
            self.ref_imgi[MC.OD_FRAME_GOLD] = refi
        # Reference updates after coding (reference:
        # src/encode.c:3145-3178).
        if self.b_frames == 0:
            self.ref_imgi[MC.OD_FRAME_PREV] = refi
        elif frame_type != 2:
            if (self.ref_imgi[MC.OD_FRAME_PREV] < 0
                    and self.ref_imgi[MC.OD_FRAME_NEXT] < 0):
                self.ref_imgi[MC.OD_FRAME_PREV] = refi
                self.ref_imgi[MC.OD_FRAME_NEXT] = refi
            else:
                self.ref_imgi[MC.OD_FRAME_PREV] = \
                    self.ref_imgi[MC.OD_FRAME_NEXT]
                self.ref_imgi[MC.OD_FRAME_NEXT] = refi
        self.frame_count += 1
        if frame_type != 2:
            self.ip_frame_count += 1
        packet = enc.done()
        LOG.od_log(LOG.OD_LOG_ENCODER, LOG.OD_LOG_INFO,
                   "frame %d type %d display %d quantizer %d bytes %d",
                   self.frame_count, frame_type, display_order,
                   st.quantizer, len(packet))
        if getattr(self, "record_pass1", False):
            self.rc.record_pass1(frame_type, int(is_golden),
                                 len(packet) * 8, st.quantizer)
        if self.rc.target_bitrate > 0:
            self.rc.update(len(packet) * 8, int(is_golden), frame_type,
                           0, self.target_quantizer)
        self._packet = packet
        self.recon = []
        for pli in range(nplanes):
            xd, yd = info.plane_dec[pli]
            full = self_img.plane_view(pli)
            crop = full[:(info.pic_height + (1 << yd) - 1) >> yd,
                        :(info.pic_width + (1 << xd) - 1) >> xd]
            if fpr:
                from daala_tpu_torch.codec.state import internal_to_output
                crop = internal_to_output(
                    crop, 8 + 2 * (info.bitdepth_mode - 1))
                self.recon.append(crop)
            else:
                self.recon.append(crop.copy())
        if self._bsize_dist_file is not None:
            import math as _math
            for pli in range(nplanes):
                v = self._bsize_dist[pli]
                self._bsize_dist_file.write(
                    "%-7G\t" % (10 * _math.log10(v) if v > 0
                                else float("-inf")))
                self._bsize_dist_total[pli] += v
                self._bsize_dist[pli] = 0.0
            self._bsize_dist_file.write("\n")
        from daala_tpu_torch.utils import dump as _dump
        if _dump.images_dir():
            # OD_DUMP_IMAGES analogue: the encoder's input frames.
            _dump.dump_yuv(_dump.images_dir(), "input", planes_u8, info)
        if _dump.recons_dir():
            # OD_DUMP_RECONS analogue (reference: src/state.c:736-828).
            _dump.dump_yuv(_dump.recons_dir(), "recon", self.recon, info)
        if self.enable_encoder_check:
            self._encoder_check(packet)
        return self._packet

    def _encoder_check(self, packet):
        """Re-decode the packet with an embedded decoder and compare its
        coding-order recon to ours (reference: src/encode.c:3231-3272).
        Raises on mismatch rather than printing like the reference.  The
        embedded decoder is the host decoder, as the original's."""
        import numpy as np
        if self._check_dec is None:
            from daala_tpu_torch.codec.decoder import Decoder
            self._check_dec = Decoder(self.info, use_device_synthesis=False)
        self._check_dec.decode_packet(packet)
        for pli, (ours, theirs) in enumerate(
                zip(self.recon, self._check_dec.last_recon)):
            if not np.array_equal(ours, theirs):
                raise AssertionError(
                    "encoder_check: pixel mismatch frame %d plane %d"
                    % (self.frame_count - 1, pli))


def _shadow8(rimg):
    """An 8-bit shadow of a full-precision reference image for the
    non-normative motion search (rounded like od_img_plane_copy,
    reference: src/state.c:170-180)."""
    import dataclasses
    info8 = dataclasses.replace(rimg.info, full_precision_references=0)
    out = MC.RefImage(info8)
    for pli, p in enumerate(rimg.planes):
        out.planes[pli][:, :] = np.clip(
            (p.astype(np.int32) + (1 << 4 >> 1)) >> 4, 0, 255)
    return out

