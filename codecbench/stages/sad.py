"""SAD fields (models/mefield.py fullpel_sad_fields): full-pel SAD field
entries against their definition on the source luma and the reference
planes as the port padded them.  The control sums in int16."""

import numpy as np

from codecbench import check as C
from codecbench.reference import sad as RS


def _wrap(orig, slot):
    def f(cur, refs_padded, pad, vis, nvmvbs, nhmvbs, r=16, **kw):
        out = orig(cur, refs_padded, pad, vis, nvmvbs, nhmvbs, r, **kw)
        rec = slot()
        if rec is not None:
            rec.update(refs=[np.array(p) for p in refs_padded], pad=pad,
                       vis=tuple(vis), nvmvbs=nvmvbs, nhmvbs=nhmvbs, r=r,
                       out=[np.array(o) for o in out])
        return out
    return f


ENTRIES = (("daala_tpu_torch.models.mefield", "fullpel_sad_fields", _wrap),)
INTER_ONLY = True
NUMBERS = {"sad_fields_off": 0}


def compare(s, frame):
    return {"sad_fields_off": C.all_off(s["out"], [
        RS.sad_fields(frame.source[0], ref, s["pad"], s["vis"], s["nvmvbs"],
                      s["nhmvbs"], s["r"], frame.dev, frame.idt)
        for ref in s["refs"]])}
