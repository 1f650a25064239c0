"""The dering RDO's candidates (models/restore.py
dering_candidates_device, the analysis tier): candidate pixels
(superblocks x 5 gains x 64 x 64) and luma directions that differ from
the reference's (reference/backend.py dering_candidates) on the
pre-dering luma, skip map and quantizer as the port's coding pass made
them.  The control accumulates the direction search's costs in int16
in place of int32."""

import numpy as np

from codecbench import check as C
from codecbench.reference import backend as RB


def _wrap(orig, slot):
    def f(luma_i16, bskip0, quantizer, nvdr, nhdr, coeff_shift=4, *,
          device):
        out = orig(luma_i16, bskip0, quantizer, nvdr, nhdr, coeff_shift,
                   device=device)
        rec = slot()
        if rec is not None:
            rec.update(luma=np.array(luma_i16), bskip=np.array(bskip0),
                       quantizer=int(quantizer), nvdr=nvdr, nhdr=nhdr,
                       coeff_shift=coeff_shift, out=out)
        return out
    return f


ENTRIES = (("daala_tpu_torch.models.restore", "dering_candidates_device",
            _wrap),)
NUMBERS = {"dering_cands_off": 0}


def compare(rec, frame):
    want = RB.dering_candidates(
        rec["luma"], rec["bskip"], rec["quantizer"], rec["nvdr"],
        rec["nhdr"], rec["coeff_shift"], frame.dev,
        RB._wrap16 if frame.control else RB._wrap32)
    return {"dering_cands_off": C.all_off(list(rec["out"]), list(want))}
