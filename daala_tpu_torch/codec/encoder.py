"""The encoder with its device analysis front end and colour-sweep MV
refinement on PyTorch.

`Encoder` is daala_tpu's host encoder (daala_tpu/codec/encoder.py); for
the analysis it overrides one method, `_encode_coefficients`.
`encode_frame` clears `_device_rdo`, `_device_d` and `_device_md` and
then calls `_encode_coefficients` twice per frame at complexity >= 2
(the luma block-size RDO trial pass with rdo_only=1, then the final
pass); the native frame pass reads those three attributes back and
consumes the planes in place of its own transforms, byte-identically.
The override fills them from the port's analysis (models/keyframe.py)
on `device`, calls the host method and clears them.

Only the native frame pass reads the planes; the Python coefficient
path would silently ignore them.  So the override raises unless the
native pass is the one that will run.  The JAX device tiers
(`use_device_analysis`, `use_device_pvq`) are never switched on, so
nothing of daala_tpu.models, which imports jax, is ever imported.

`mv_refine_mode="sweep"` runs the colour-sweep MV refinement on
`device` (codec/mvest.py refine_sweep) in place of the host's greedy
one.  The host would run its own, jax-reaching sweep for an attribute
`mv_refine_mode == "sweep"`, so the choice is kept under `sweep` and the
port takes two other seams of `_encode_one`, which call it exactly where
the host's sweep runs (daala_tpu/codec/encoder.py:1653-1710):

- `_mv_refine_iters` returns 0 while the sweep is on, so the native
  motion search skips its greedy refinement (the host's `iters=0 if
  sweep`).  It raises if a caller set the host attribute
  `mv_refine_mode`: the host evaluates it as an argument of its own
  `mvest.refine_sweep` call, before that imports jax.
- `mv_override_cb`, the hook the host calls right after motion
  estimation, is a property: its getter returns a function that runs
  the port's sweep and then the callback a caller assigned.
"""

from __future__ import annotations

import numpy as np

from daala_tpu.codec import encoder as _host
from daala_tpu_torch.codec import mvest
from daala_tpu_torch.device import resolve
from daala_tpu_torch.models import keyframe as KF


class Encoder(_host.Encoder):
    def __init__(self, info, *args, device, mv_refine_mode="greedy",
                 **kwargs):
        """As daala_tpu.codec.encoder.Encoder, plus `device` ('cpu' or
        'cuda[:N]', required) for the analysis front end and the sweep,
        and `mv_refine_mode`: 'greedy' (the host's refinement) or
        'sweep' (the colour sweep on `device`, at complexity >= 3)."""
        if mv_refine_mode not in ("greedy", "sweep"):
            raise ValueError("mv_refine_mode must be 'greedy' or 'sweep', "
                             "got %r" % (mv_refine_mode,))
        self.sweep = mv_refine_mode == "sweep"
        self._caller_mv_cb = None
        super().__init__(info, *args, **kwargs)
        self.device = resolve(device)

    def _sweep_on(self):
        return self.sweep and self.complexity >= 3

    def _mv_refine_iters(self):
        if "mv_refine_mode" in vars(self):
            raise ValueError("set mv_refine_mode through the constructor of "
                             "daala_tpu_torch's Encoder; the attribute would "
                             "run daala_tpu's JAX sweep")
        return 0 if self._sweep_on() else super()._mv_refine_iters()

    @property
    def mv_override_cb(self):
        if not self._sweep_on():
            return self._caller_mv_cb
        return self._sweep_then_caller

    @mv_override_cb.setter
    def mv_override_cb(self, fn):
        self._caller_mv_cb = fn

    def _sweep_then_caller(self, frame_count, grid, ctx):
        """The port's colour sweep, where the host runs its own: after
        the native motion search, on the same 8-bit search planes."""
        if not getattr(self, "use_native_me", _host._NATIVE_FRAME_DEFAULT):
            raise RuntimeError("mv_refine_mode='sweep' needs the native "
                               "motion search (use_native_me)")
        search_luma = ctx["padded_in"][0]
        if search_luma.dtype == np.uint16:
            search_luma = np.clip(
                (search_luma.astype(np.int32) + (1 << 4 >> 1)) >> 4,
                0, 255).astype(np.uint8)
        mvest.refine_sweep(grid, search_luma, ctx["refs"], ctx["info"],
                           ctx["lam_mv"], ctx["adapt"], ctx["vis"],
                           ctx["frame_type"],
                           iters=super()._mv_refine_iters(),
                           device=self.device,
                           decimate=getattr(self, "mv_decimate", 0))
        if self._caller_mv_cb is not None:
            self._caller_mv_cb(frame_count, grid, ctx)

    def _native_frame_pass(self):
        """The condition under which the host runs the native frame pass
        (daala_tpu/codec/encoder.py _encode_coefficients)."""
        return bool(getattr(self, "use_native_frame",
                            _host._NATIVE_FRAME_DEFAULT)
                    and hasattr(self.enc, "_h")
                    and self._bsize_dist_file is None)

    def _encode_coefficients(self, padded_in, self_img, is_keyframe,
                             use_haar_wavelet, planes_u8, rdo_only=0):
        if (getattr(self, "use_device_analysis", False)
                or getattr(self, "use_device_pvq", False)):
            raise ValueError("use_device_analysis / use_device_pvq select "
                             "the JAX device tiers; this encoder's device "
                             "front end is always on")
        if not self._native_frame_pass():
            raise RuntimeError(
                "daala_tpu_torch Encoder needs the native frame pass (the "
                "only consumer of its analysis planes): native engine "
                "missing, DAALA_TPU_NATIVE_FRAME=0 or "
                "DAALA_TPU_DUMP_BSIZE_DIST set")
        if not use_haar_wavelet:
            st, info = self.state, self.info
            lossless = st.quantizer == 0
            if rdo_only:
                mc = None if is_keyframe else [self_img.plane_view(0)]
                self._device_rdo = KF.analyze_rdo_pyramid(
                    st, info, padded_in, mc, lossless, self.device)
            elif is_keyframe:
                self._device_d = KF.analyze_keyframe(
                    st, info, padded_in, lossless, self.device)
            else:
                mc_planes = [self_img.plane_view(pli)
                             for pli in range(info.nplanes)]
                self._device_d, self._device_md = KF.analyze_inter(
                    st, info, padded_in, mc_planes, lossless, self.device)
        try:
            return super()._encode_coefficients(
                padded_in, self_img, is_keyframe, use_haar_wavelet,
                planes_u8, rdo_only=rdo_only)
        finally:
            self._device_rdo = None
            self._device_d = None
            self._device_md = None
