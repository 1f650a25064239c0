"""The colour sweep's leaf batches (models/mesweep.py leaf_cells_batch,
kernel obmc_leaf_cells): 8x8-cell SADs against the reference's OBMC
prediction of the same leaves (the same MVs, corner sources and splits)
against the source luma.  The control wraps the OBMC filter's
accumulator to int16."""

import numpy as np
import torch

from codecbench import check as C
from codecbench.reference import obmc as RO


def _wrap(orig, slot):
    def f(state, lms, pos, srcs, mvs, ocs, ss):
        out = orig(state, lms, pos, srcs, mvs, ocs, ss)
        rec = slot()
        if rec is not None:
            if not rec:
                rec.update(planes4=state.planes4, pad=state.pad, calls=[])
            rec["calls"].append((lms, *(np.array(a) for a in (
                pos, srcs, mvs, ocs, ss, out))))
        return out
    return f


ENTRIES = (("daala_tpu_torch.models.mesweep", "leaf_cells_batch", _wrap),)
INTER_ONLY = True
NUMBERS = {"sweep_cells_off": 0}


def compare(sw, frame):
    planes4 = sw["planes4"].to(frame.dev)
    cur = frame.source[0]
    cur_t = torch.from_numpy(np.ascontiguousarray(
        cur[:frame.h, :frame.w])).to(frame.dev)
    off = 0
    for lms, pos, srcs, mvs, ocs, ss, got in sw["calls"]:
        log_n = lms + 3
        scal = torch.from_numpy(RO.leaf_args(
            pos, srcs, mvs, ocs, ss, sw["pad"], log_n, log_n,
            tuple(planes4.shape[1:]))).to(frame.dev)
        off += C.count_off(got, RO.leaf_cells(planes4, cur_t, scal, log_n,
                                              frame.control))
    return {"sweep_cells_off": off}
