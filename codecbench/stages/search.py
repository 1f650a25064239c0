"""The PVQ band search (models/pvqsearch.py search_frame): band rows
whose decision (noref, gain, theta, max theta, k, valid, pulses,
skip_diff) differs from the reference band search on the reference's
planes (the `front` stage's), under the quantisation matrices that the
reference works out from the configuration.  The control searches
planes rounded to bfloat16."""

import numpy as np
import torch

from codecbench.reference import pvq as RV
from codecbench.reference import search as RP
from codecbench.stages import front_planes


def _wrap(orig, slot):
    def f(st, info, quantizer, d_planes, md_planes, lam, is_keyframe=False,
          use_masking=True, **kw):
        finish = orig(st, info, quantizer, d_planes, md_planes, lam,
                      is_keyframe=is_keyframe, use_masking=use_masking, **kw)
        rec = slot()
        if rec is None:
            return finish
        cw = st.adapt.pvq.pvq_codeword_ctx
        rec.update(k1=np.array(cw.pvq_k1_cdf), split=np.array(
            cw.pvq_split_cdf), quantizer=quantizer, lam=float(lam),
            is_keyframe=bool(is_keyframe))

        def finished():
            table = finish()
            rec["table"] = port_table(table)
            return table
        return finished
    return f


ENTRIES = (("daala_tpu_torch.models.pvqsearch", "search_frame", _wrap),)
REQUIRES = ("front",)
NUMBERS = {"pvq_rows_off": 0}


def complete(rec):
    return "table" in rec


def port_table(table):
    """The port's DevicePVQTable as the reference's dict: (plane, leaf
    size, band) -> by4, bx4, ints, y, skip_diff."""
    out = {}
    for g in table.groups:
        for band, r in g["bands"].items():
            out[(g["pli"], g["bs"], band)] = dict(
                by4=np.array(g["by4"]), bx4=np.array(g["bx4"]),
                ints=np.stack([r[k] for k in ("noref", "qg", "itheta",
                                              "ts", "k", "valid")], 1),
                y=np.array(r["y"]), skip_diff=np.array(r["skip_diff"]))
    return out


def rows_off(got, want):
    """Rows of the reference table `want` that `got` lacks or decides
    otherwise, plus rows of `got` the reference does not have.  A NaN
    skip_diff (a band of zero gain) equals a NaN."""
    off = sum(len(t["ints"]) for k, t in got.items() if k not in want)
    for key, w in want.items():
        g = got.get(key)
        m = len(w["ints"])
        if (g is None or not np.array_equal(g["by4"], w["by4"])
                or not np.array_equal(g["bx4"], w["bx4"])):
            off += m
            continue
        gs, ws = g["skip_diff"], w["skip_diff"]
        same = ((g["ints"] == w["ints"]).all(1) & (g["y"] == w["y"]).all(1)
                & ((gs == ws) | (np.isnan(gs) & np.isnan(ws))))
        off += int(m - same.sum())
    return off


def stated_qm(config, nplanes=3):
    """The quantisation matrices that the configuration states, worked
    out by the reference from its quant, its `qm` (1, Daala's default,
    the HVS matrix; 0 flat) and its activity masking (on by default):
    nothing of them is taken from the port."""
    enc = config["encoder"]
    return RV.stated_qm(config["quant"], enc.get("qm", 1) == 1,
                        enc.get("use_activity_masking", True), nplanes)


def bf16_round(p):
    """An int32 plane with each value rounded to the nearest bfloat16,
    back in int32: the data path of a search one precision below
    float32."""
    return p.to(torch.float32).to(torch.bfloat16).to(torch.float32) \
        .round().to(torch.int32)


def compare(sr, frame):
    d_in, md_in = front_planes(frame, torch.int32)
    if frame.control:
        d_in = [bf16_round(p) for p in d_in]
        md_in = None if md_in is None else [bf16_round(p) for p in md_in]
    qm, pvq_qm = stated_qm(frame.config, len(frame.plane_dec))
    masking = frame.config["encoder"].get("use_activity_masking", True)
    want = RP.search(d_in, md_in, frame.rec["front"]["bsize"], qm, pvq_qm,
                     sr["k1"], sr["split"], sr["quantizer"], sr["lam"],
                     frame.fw, frame.fh, frame.plane_dec, sr["is_keyframe"],
                     masking)
    return {"pvq_rows_off": rows_off(sr["table"], want)}
