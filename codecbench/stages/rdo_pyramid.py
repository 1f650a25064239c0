"""The trial pass's luma transform pyramid (models/keyframe.py
analyze_rdo_pyramid, the analysis tier): entries of each level the port
returns (d 0-4, md 0-4 on inter frames, the keyframe's Haar-merged
level 0) that differ from the reference pyramid (reference/pyramid.py)
of the source luma and, on inter frames, of the OBMC prediction as the
port made it.  The control lifts in int16."""

import numpy as np

from codecbench import check as C
from codecbench.reference import pyramid as RY


def _wrap(orig, slot):
    def f(state, info, padded_planes, mc_planes, lossless, device, **kw):
        out = orig(state, info, padded_planes, mc_planes, lossless, device,
                   **kw)
        rec = slot()
        if rec is not None:
            rec.update(mc=None if mc_planes is None
                       else np.array(mc_planes[0]), out=out)
        return out
    return f


ENTRIES = (("daala_tpu_torch.models.keyframe", "analyze_rdo_pyramid",
            _wrap),)
NUMBERS = {"rdo_pyramid_off": 0}


def _planes(levels):
    return [] if levels is None else [levels[k] for k in sorted(levels)]


def compare(rec, frame):
    d, md, merged = rec["out"]
    want = RY.rdo_pyramid(frame.source[0], frame.w, frame.h, rec["mc"],
                          frame.dev, frame.idt)
    gots = _planes(d) + _planes(md) + ([] if merged is None else [merged])
    wants = _planes(want[0]) + _planes(want[1]) + (
        [] if want[2] is None else [want[2]])
    return {"rdo_pyramid_off": C.all_off(gots, wants)}
