"""The analysis front end (models/keyframe.py analyze_keyframe,
analyze_inter): coefficients of the d (and md) planes against the
lapped transform of the source frame (and of the OBMC prediction) under
the frame's block-size map.  The control lifts in int16."""

import numpy as np

from codecbench import check as C
from codecbench.stages import front_planes


def _planes(sps):
    """The whole planes of a list of ShardedPlanes as tensors on their
    device (no copy for a single tile)."""
    return [sp.to(sp.device) for sp in sps]


def _keyframe(orig, slot):
    def f(state, info, padded_planes, lossless, device, **kw):
        out, finish = orig(state, info, padded_planes, lossless, device,
                           **kw)
        rec = slot()
        if rec is not None:
            rec.update(bsize=np.array(state.bsize), mc=None,
                       d=_planes(out), md=None)
        return out, finish
    return f


def _inter(orig, slot):
    def f(state, info, padded_planes, mc_planes, lossless, device, **kw):
        d, md, finish = orig(state, info, padded_planes, mc_planes,
                             lossless, device, **kw)
        rec = slot()
        if rec is not None:
            rec.update(bsize=np.array(state.bsize),
                       mc=[np.array(p) for p in mc_planes],
                       d=_planes(d), md=_planes(md))
        return d, md, finish
    return f


ENTRIES = (("daala_tpu_torch.models.keyframe", "analyze_keyframe",
            _keyframe),
           ("daala_tpu_torch.models.keyframe", "analyze_inter", _inter))
NUMBERS = {"coeffs_off": 0}


def compare(fr, frame):
    d, md = front_planes(frame, frame.idt)
    return {"coeffs_off": C.all_off(fr["d"] + (fr["md"] or []),
                                    d + (md or []))}
