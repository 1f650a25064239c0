"""The lean tier's PVQ band search over a whole frame, in plain
PyTorch: a frozen copy of the port's models/pvqsearch.py `_dispatch`
(the bands of a frame bucketed by length, one band search per length)
over the frozen plain band and pulse searches.

`search(...)` returns the decision table as a dict keyed by (plane,
leaf size, band) with the rows in the port's order: each entry holds
the by4 and bx4 of its blocks and, per row, `ints` (noref, qg, itheta,
max_theta, k, valid), the pulses `y` and `skip_diff`.
"""

from __future__ import annotations

import numpy as np
import torch

from codecbench.reference import partition as part
from codecbench.reference import pvq as P
from codecbench.reference.band import band_epilogue_plain, band_prologue_plain
from codecbench.reference.pulse import pulse_search_plain


def band_search(dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15, lam,
                n, iters, k1_cdf, split_cdf, is_keyframe):
    xs, lane_ok, src, cf, ci, rf = band_prologue_plain(
        dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15, lam, n,
        is_keyframe)
    y_c, cos_dist, ok_p = pulse_search_plain(
        xs, ci[5].reshape(-1), cf[0].reshape(-1), lam, lane_ok, iters, src)
    return band_epilogue_plain(y_c, cos_dist, ok_p, cf, ci, rf, lam, n,
                               k1_cdf, split_cdf, is_keyframe)


def search(d_planes, md_planes, bsize, qm, pvq_qm_q4, k1_cdf, split_cdf,
           quantizer, lam, fw, fh, plane_dec, is_keyframe, use_masking):
    """The frame's table from its coefficient planes (tensors on one
    device; md_planes None on a keyframe, which searches luma alone)."""
    nplanes = 1 if is_keyframe else len(d_planes)
    dev = d_planes[0].device
    bs8 = np.asarray(bsize)
    plane_base = [0]
    for pli in range(nplanes):
        plane_base.append(plane_base[-1] + d_planes[pli].numel())
    dflat = torch.cat([p.reshape(-1).to(torch.int32)
                       for p in d_planes[:nplanes]])
    mdflat = dflat if is_keyframe else torch.cat(
        [p.reshape(-1).to(torch.int32) for p in md_planes[:nplanes]])
    buckets, tabs, tab_rows, table = {}, {}, {}, {}
    for pli in range(nplanes):
        xdec, ydec = plane_dec[pli]
        stride = int(d_planes[pli].shape[1])
        by4g, bx4g = np.mgrid[0:(fh >> ydec) >> 2, 0:(fw >> xdec) >> 2]
        bs_map = np.maximum(
            bs8[(by4g << ydec) >> 1, (bx4g << xdec) >> 1], xdec) - xdec
        lead = (((by4g & ((1 << bs_map) - 1)) == 0)
                & ((bx4g & ((1 << bs_map) - 1)) == 0))
        for bs in range(int(bs_map.max()) + 1):
            sel = lead & (bs_map == bs)
            if not sel.any():
                continue
            by4s, bx4s = (a.astype(np.int32) for a in np.nonzero(sel))
            n = 4 << bs
            offs = part.band_offsets(n)
            slen = part.scan_length(n)
            off_qm = P.qm_offset(bs, xdec)
            qm_slice = np.asarray(qm[off_qm:off_qm + slen], np.int32)
            beta15 = bool(use_masking and pli == 0 and bs > 0)
            m_grp = len(by4s)
            blk_base = (plane_base[pli]
                        + ((by4s.astype(np.int64) >> bs) * n) * stride
                        + (bx4s.astype(np.int64) >> bs) * n).astype(np.int32)
            co = part.coding_order_indices(n)
            for band in range(len(offs) - 1):
                o0, o1 = int(offs[band]), int(offs[band + 1])
                nn = o1 - o0
                q_band = max(1, max(1, quantizer) * int(
                    pvq_qm_q4[pli][P.qm_get_index(bs, band + 1)]) >> 4)
                bk = buckets.setdefault(nn, dict(base=[], tsel=[], q0=[],
                                                 b15=[], segs=[], m=0))
                tmap = tabs.setdefault(nn, {})
                tkey = (stride, bs, band, off_qm)
                if tkey not in tmap:
                    tmap[tkey] = len(tmap)
                    cb = co[o0:o1]
                    tab_rows.setdefault(nn, []).append(
                        (((cb // n) * stride + cb % n).astype(np.int32),
                         qm_slice[o0:o1]))
                bk["base"].append(blk_base)
                bk["tsel"].append(np.full(m_grp, tmap[tkey], np.int32))
                bk["q0"].append(np.full(m_grp, q_band, np.int32))
                bk["b15"].append(np.full(m_grp, beta15, np.bool_))
                bk["segs"].append(((pli, bs, band), bk["m"], m_grp))
                bk["m"] += m_grp
                table[(pli, bs, band)] = dict(by4=by4s, bx4=bx4s)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    k1 = put(np.asarray(k1_cdf, np.int32))
    sp = put(np.asarray(split_cdf, np.int32))
    for nn in sorted(buckets):
        bk = buckets[nn]
        rows = tab_rows[nn]
        ints, y, skip_diff = band_search(
            dflat, mdflat, put(np.concatenate(bk["base"])),
            put(np.concatenate(bk["tsel"])),
            put(np.stack([r[0] for r in rows])),
            put(np.stack([r[1] for r in rows])),
            put(np.concatenate(bk["q0"])), put(np.concatenate(bk["b15"])),
            float(lam), nn, int(nn + 64), k1, sp, bool(is_keyframe))
        ints, y = ints.cpu().numpy(), y.cpu().numpy().astype(np.int32)
        skip_diff = skip_diff.cpu().numpy().astype(np.float64)
        for key, start, m_grp in bk["segs"]:
            sl = slice(start, start + m_grp)
            table[key].update(ints=ints[sl], y=y[sl],
                              skip_diff=skip_diff[sl])
    return table
