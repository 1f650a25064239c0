"""Device PVQ band search on torch tensors: the per-band gain/theta/
codeword RDO batched over every band of a frame, one call per band
length.

The counterpart of daala_tpu/models/pvqsearch.py.  The reference's
per-band search (od_pvq_encode -> pvq_theta, src/pvq_encoder.c:333-636)
is embarrassingly parallel across the bands of a frame: with the
reference's own fast rate model (the `speed > 0` branch of od_pvq_rate,
src/pvq_encoder.c:247-262) the search depends only on the input
coefficients, the MC-prediction coefficients, the frame quantizer and
the QM tables, none of the sequentially adapted entropy state.  So the
whole search runs on the device against the analysis coefficients that
stay there; only a compact decision table comes back, and the native
entropy pass replays it (frame_enc.inc ec_pvq_theta_forced).

Decision parity: the integer stages (gains, companding, Householder, k)
follow the reference's fixed-point semantics exactly, in int64 (torch's
shifts by 64 or more, or by a negative amount, give what XLA's do: 0
for a left shift, the sign for an arithmetic right shift).  The float
RDO (distortions, pulse search, rate model) runs in float32 and
computes what XLA:CPU makes of JAX's jitted band_search, so that on
the CPU every output, skip_diff included, equals JAX's bit for bit
(tests/test_torch_band_order.py); the host searches any band the
device marks invalid (pulse budget overflow) itself, as in JAX.  The
forms XLA:CPU takes, read in its optimized HLO and LLVM IR:

- the pulse search (ops/cuda/pulse_kernels.py): its three `1 / sqrt`
  are `_rsqrt`, the rsqrt XLA rewrites them into (an estimate and two
  Newton steps, not the correctly rounded value); the phase-2 score
  and the rate penalty's delta + j accel are fused multiply-adds; its
  row sums take XLA:CPU's order (chains of fused multiply-adds, or
  32-lane chunks for n = 128; `ordered_dot`);
- the rest (ops/cuda/band_kernels.py, whose docstring lists them): the
  inter skip distortion, the theta = 0 candidate's, the theta gate's,
  every candidate's distortion, its cost (fma(lam, rate, dist), save in
  the inter fusion that picks the pulses, which rounds lam rate first)
  and the theta rate are fused multiply-adds where LLVM contracts them,
  each rounded once;
  the correlation's quotient, the theta scale and 0.9 log2 are XLA's
  rewrites of them; log is XLA's polynomial, arccos glibc's atan2f of
  XLA's argument; the rate trees' node sums take XLA's order.

Each of these moved a pulse, a decision or the last bit of a
distortion on some rows (ROADMAP §3).

On the card a band_search call is three launches, no host sync:
band_prologue (the band gather, gains, Householder reflection and
candidates), pulse_search, band_epilogue (distortions, rates, costs
and the selection); on the CPU their plain versions, the code the
kernels equal bit for bit.

Differences from the JAX module, none of which changes a result:

- the 12 theta and 2 noref candidates run as ONE pulse search of C*m
  rows (each candidate's row an index into the 2 m rows the candidates
  search: the reflected row and x16), and the sequential `better`
  selection over
  them is evaluated in closed form (`_select`), so the number of
  launches per call depends on neither the row count nor the candidate
  count (on the CPU, the pulse loop's trip count, which the data sets,
  adds to them);
- no row chunking and no padding ladder: one call per band length and
  frame type, whatever the row count;
- the band gather masks out-of-range offsets explicitly where JAX used
  `mode="fill"`.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.ops import partition as part
from daala_tpu_torch.ops import pvq as P
# The fixed-point helpers and rate models live beside the kernels that
# compute them; they are named here too, as in the JAX module.
from daala_tpu_torch.ops.cuda.band_kernels import (  # noqa: F401
    _apply_householder, _codeword_rate, _compute_gain, _compute_k,
    _compute_max_theta, _compute_theta, _cos_pi_2, _fast_rate, _gain_compand,
    _gain_expand, _ilog, _ilog_c, _mult16_16_q15, _mult16_16_q16,
    _mult16_32_qbeta, _od_exp2, _od_log2, _od_pow, _od_rcp, _od_sqrt,
    _pvq_cos, _pvq_sin, _rsqrt_norm, _shl32, _shr_round, _sqrt_norm, _vshr,
    _vshr_round, _wrap16, band_epilogue, band_prologue)
from daala_tpu_torch.ops.cuda.pulse_kernels import (  # noqa: F401
    _fma32, _rsqrt, pulse_search)
from daala_tpu_torch.parallel.sharding import stage_hook
from daala_tpu_torch.utils import devstats


# ---------------------------------------------------------------------------
# Pulse search (reference: pvq_search_rdo_double, src/pvq_encoder.c:93-227)
# ---------------------------------------------------------------------------

def _pulse_search(xc, k, g2, lam, n, iters, lane_ok=None):
    """Vectorized greedy RDO pulse allocation.

    xc: (m, n) f32 signed coefficients; lane_ok: (m, n) bool, lanes
    outside the coded sub-vector (the theta path searches n-1 dims) are
    excluded from every argmax and contribute zero; k: (m,) int target
    pulses; g2: (m,) distortion scale; lam: host float.  Returns (y
    signed (m, n) int32, cos_dist (m,), ok (m,): False when `iters`
    steps were not enough).  Fresh search per call.

    The whole search is ops/cuda/pulse_kernels.py pulse_search: on the
    card one kernel launch that runs each row's own trip count (the
    pulses it still needs, capped at `iters`), with no host sync; on
    the CPU the plain version, which reads the largest trip count once
    per call and masks the rows that finish early, as in the JAX
    while_loop.  Its row sums take XLA:CPU's order."""
    if lane_ok is None:
        lane_ok = torch.ones(xc.shape, dtype=torch.bool, device=xc.device)
    return pulse_search(xc, k, g2, lam, lane_ok, iters)


# ---------------------------------------------------------------------------
# The per-band-length band search.
# ---------------------------------------------------------------------------


def band_search(dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15,
                lam, n, iters, k1_cdf=None, split_cdf=None,
                is_keyframe=False):
    """Batched pvq_theta for inter bands and keyframe-luma bands, on the
    device of its tensors (JAX's band_search, with its arguments as
    torch tensors on one device and n, iters, lam, is_keyframe host
    values).

      dflat, mdflat: 1-D int32 concatenations of the frame's input /
          MC-prediction coefficient planes (the analysis outputs, still
          on the device; keyframes: pass dflat twice).
      base: (m,) flat offset of each row's block origin inside dflat.
      tabsel: (m,) row -> gather-table id; tab: (T, n) flat offsets of
          the band's coefficients relative to the block origin, in
          coding order; qmtab: (T, n) the tables' QM slices.
      q0: (m,) band quantizers; beta15: (m,) bool, the row uses the
          activity-masking beta 1.5 (else beta 1).
      k1_cdf, split_cdf: the frame-start codeword CDF tables (int); None
          selects the fast rate model.

    is_keyframe gates the keyframe differences of pvq_theta: the skip
    distortion is the plain gain energy, no theta=0 reference-gain
    candidate, and no theta machinery (R == 0 makes it dead).

    Returns ints (m, 6) int32 = [noref, qg, itheta, max_theta, k,
    valid], y (m, n) int16 and skip_diff (m,) f32, as JAX's."""
    with torch.profiler.record_function("band_search"):
        return _band_search(dflat, mdflat, base, tabsel, tab, qmtab, q0,
                            beta15, lam, n, iters, k1_cdf, split_cdf,
                            is_keyframe)


def _band_search(dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15, lam,
                 n, iters, k1_cdf, split_cdf, is_keyframe):
    xs, lane_ok, src, cf, ci, rf = band_prologue(
        dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15, lam, n,
        is_keyframe)
    y_c, cos_dist, ok_p = pulse_search(xs, ci[5].reshape(-1),
                                       cf[0].reshape(-1), lam, lane_ok,
                                       iters, src)
    return band_epilogue(y_c, cos_dist, ok_p, cf, ci, rf, lam, n, k1_cdf,
                         split_cdf, is_keyframe)


# ---------------------------------------------------------------------------
# Frame-level entry point: bucket the bands of a frame by length, search on
# the device, emit a decision table for the host entropy pass.
# ---------------------------------------------------------------------------


class DevicePVQTable:
    """Dense per-frame device PVQ decision table (a copy of
    daala_tpu.models.pvqsearch.DevicePVQTable, which lives in a module
    that imports jax).

    groups: one entry per (plane, block size) with vector block
    coordinates and per-band result arrays — the natural shape of the
    batched device search, consumed without per-block Python:

      * native_arrays() flattens to the (idx, meta, yoff, ypool, sd)
        arrays frame_enc.inc's ec_pvq_theta_forced replay reads,
        entirely with numpy scatters;
      * get((pli, by4, bx4, band)) provides the tuple view the pure-
        Python coefficient path consumes (lazy index, test/debug path),
        and counts the valid entries it hands out under the devstats
        counter "forced_bands".
    """

    def __init__(self):
        self.groups = []
        self._index = None

    def get(self, key):
        pli, by4, bx4, band = key
        if self._index is None:
            self._index = {}
            for g in self.groups:
                for i in range(len(g["by4"])):
                    self._index[(g["pli"], int(g["by4"][i]),
                                 int(g["bx4"][i]))] = (g, i)
        hit = self._index.get((pli, by4, bx4))
        if hit is None:
            return None
        g, i = hit
        r = g["bands"].get(band)
        if r is None:
            return None
        valid = bool(r["valid"][i])
        if valid:
            devstats.count("forced_bands", 1)
        return (int(r["noref"][i]), int(r["qg"][i]),
                int(r["itheta"][i]), int(r["ts"][i]), int(r["k"][i]),
                r["y"][i], float(r["skip_diff"][i]), valid)

    def native_arrays(self, st, info):
        """Flatten to the native replay arrays (idx int32 per-plane 4x4
        grid concat -> slot | -1, meta (nslots, 16, 6) int32,
        yoff (nslots,) int64, ypool int32, sd (nslots, 16) f64), slot
        order = sorted (pli, by4, bx4)."""
        base = [0] * (info.nplanes + 1)
        n4h_p = [0] * info.nplanes
        for pli in range(info.nplanes):
            xd, yd = info.plane_dec[pli]
            n4h_p[pli] = (st.frame_width >> xd) >> 2
            base[pli + 1] = base[pli] + \
                ((st.frame_height >> yd) >> 2) * n4h_p[pli]
        if not self.groups:
            return (np.full(max(1, base[info.nplanes]), -1, np.int32),
                    np.zeros((1, 16, 6), np.int32),
                    np.zeros(1, np.int64), np.zeros(1, np.int32),
                    np.zeros((1, 16), np.float64))
        flat = np.concatenate([
            base[g["pli"]] + g["by4"].astype(np.int64) * n4h_p[g["pli"]]
            + g["bx4"] for g in self.groups])
        slen_all = np.concatenate([
            np.full(len(g["by4"]), part.scan_length(4 << g["bs"]),
                    np.int64) for g in self.groups])
        order = np.argsort(flat, kind="stable")
        nslots = len(flat)
        slot_of = np.empty(nslots, np.int64)
        slot_of[order] = np.arange(nslots)
        idx = np.full(base[info.nplanes], -1, np.int32)
        idx[flat] = slot_of.astype(np.int32)
        slen_sorted = slen_all[order]
        yoff = np.zeros(nslots, np.int64)
        yoff[1:] = np.cumsum(slen_sorted)[:-1]
        ypool = np.zeros(max(1, int(slen_sorted.sum())), np.int32)
        meta = np.zeros((nslots, 16, 6), np.int32)
        sd = np.zeros((nslots, 16), np.float64)
        row0 = 0
        for g in self.groups:
            m_grp = len(g["by4"])
            slots = slot_of[row0:row0 + m_grp]
            row0 += m_grp
            offs = part.band_offsets(4 << g["bs"])
            yo = yoff[slots]
            for band, r in g["bands"].items():
                meta[slots, band, 0] = r["noref"]
                meta[slots, band, 1] = r["qg"]
                meta[slots, band, 2] = r["itheta"]
                meta[slots, band, 3] = r["ts"]
                meta[slots, band, 4] = r["k"]
                meta[slots, band, 5] = r["valid"]
                sd[slots, band] = r["skip_diff"]
                o0 = int(offs[band])
                nn = r["y"].shape[1]
                ypool[yo[:, None]
                      + (o0 + np.arange(nn, dtype=np.int64))[None, :]] \
                    = r["y"]
        return idx, meta, yoff, ypool, sd


def search_frame(st, info, quantizer, d_planes, md_planes, lam,
                 is_keyframe=False, use_masking=True, device_put_fn=None):
    """Device PVQ search for a whole frame's bands, on the device of
    the planes, or with a placement hook (`device_put_fn`) on its first
    device: the search gathers its bands from one flat buffer of every
    plane's coefficients, so the planes (ShardedPlanes, parallel/
    sharding.py) are assembled there whatever the hook's spec says, as
    JAX's search replicates its 1-D buffers (splitting the rows by the
    tile that owns them is left for later).

    st: codec state (bsize map, qm tables, pvq_qm_q4, the frame-start
    codeword CDFs); d_planes / md_planes: per-plane whole-frame
    frequency-domain input / reference coefficients, as tensors or
    ShardedPlanes (the deferred analysis outputs; md_planes None on
    keyframes), assembled on the search's device (a plane that is one
    tile there is used as it is).  For inter frames every plane searches
    against its MC prediction; for keyframes only luma is searched,
    against a zero reference (chroma/CfL keyframe bands reference the
    coded luma and stay on the host, reference
    src/pvq_encoder.c:858-875).

    One band_search call per band length: the rows carry only compact
    descriptors (block base offset, gather-table id, quantizer, beta);
    the coefficients never leave the device.

    Returns a zero-argument `finish()`: every call has been queued and
    finish() fetches the results as a DevicePVQTable.  Both parts run in
    the devstats span "search_frame"."""
    with devstats.span("search_frame"):
        dev = stage_hook(device_put_fn, d_planes[0].device).device
        d_planes = [p.to(dev) for p in d_planes]
        if md_planes is not None:
            md_planes = [p.to(dev) for p in md_planes]
        finish = _dispatch(st, info, quantizer, d_planes, md_planes, lam,
                        is_keyframe, use_masking)

    def timed_finish():
        with devstats.span("search_frame"):
            return finish()
    return timed_finish


def _dispatch(st, info, quantizer, d_planes, md_planes, lam, is_keyframe,
           use_masking):
    cw = st.adapt.pvq.pvq_codeword_ctx
    table = DevicePVQTable()
    buckets = {}   # n -> dict(base=[], tsel=[], q0=[], b15=[], segs=[])
    tabs = {}      # nn -> {(stride, bs, band, off_qm): tab_id}
    tab_rows = {}  # nn -> [(off_row int32[nn], qm_row int32[nn])]
    nplanes = 1 if is_keyframe else len(d_planes)
    bs8 = np.asarray(st.bsize)
    dev = d_planes[0].device

    def _flatten(planes):
        return torch.cat([p.reshape(-1).to(torch.int32)
                          for p in planes[:nplanes]])

    plane_base = [0] * (nplanes + 1)
    for pli in range(nplanes):
        plane_base[pli + 1] = plane_base[pli] + \
            int(np.prod(tuple(d_planes[pli].shape)))
    dflat = _flatten(d_planes)
    mdflat = dflat if is_keyframe else _flatten(md_planes)
    for pli in range(nplanes):
        xdec, ydec = info.plane_dec[pli]
        stride = int(d_planes[pli].shape[1])
        n4v = (st.frame_height >> ydec) >> 2
        n4h = (st.frame_width >> xdec) >> 2
        # Plane leaf size: the luma block-size recursion clamped at the
        # plane decimation (decode_recursive's `bs = max(obs, xdec) -
        # xdec`), vectorized over the plane 4x4 grid.
        by4g, bx4g = np.mgrid[0:n4v, 0:n4h]
        bs_map = np.maximum(
            bs8[(by4g << ydec) >> 1, (bx4g << xdec) >> 1], xdec) - xdec
        lead = (((by4g & ((1 << bs_map) - 1)) == 0)
                & ((bx4g & ((1 << bs_map) - 1)) == 0))
        for bs in range(int(bs_map.max()) + 1):
            sel = lead & (bs_map == bs)
            if not sel.any():
                continue
            by4s, bx4s = np.nonzero(sel)
            by4s = by4s.astype(np.int32)
            bx4s = bx4s.astype(np.int32)
            n = 4 << bs
            offs = part.band_offsets(n)
            nb_bands = len(offs) - 1
            slen = part.scan_length(n)
            off_qm = P.qm_offset(bs, xdec)
            qm_slice = np.asarray(st.qm[off_qm:off_qm + slen], np.int32)
            beta15 = bool(use_masking and pli == 0 and bs > 0)
            m_grp = len(by4s)
            # Flat offset of each block's raster origin inside dflat.
            blk_base = (plane_base[pli]
                        + ((by4s.astype(np.int64) >> bs) * n) * stride
                        + (bx4s.astype(np.int64) >> bs) * n) \
                .astype(np.int32)
            grp = dict(pli=pli, bs=bs, by4=by4s, bx4=bx4s, bands={})
            table.groups.append(grp)
            co = part.coding_order_indices(n)
            for band in range(nb_bands):
                o0, o1 = int(offs[band]), int(offs[band + 1])
                nn = o1 - o0
                q_band = max(1, max(1, quantizer)
                             * int(st.pvq_qm_q4[pli][P.qm_get_index(
                                 bs, band + 1)]) >> 4)
                bk = buckets.setdefault(
                    nn, dict(base=[], tsel=[], q0=[], b15=[],
                             segs=[], m=0))
                tkey = (stride, bs, band, off_qm)
                tmap = tabs.setdefault(nn, {})
                tid = tmap.get(tkey)
                if tid is None:
                    tid = len(tmap)
                    tmap[tkey] = tid
                    cb = co[o0:o1]
                    off_row = ((cb // n) * stride + cb % n) \
                        .astype(np.int32)
                    tab_rows.setdefault(nn, []).append(
                        (off_row, qm_slice[o0:o1]))
                bk["base"].append(blk_base)
                bk["tsel"].append(np.full(m_grp, tid, np.int32))
                bk["q0"].append(np.full(m_grp, q_band, np.int32))
                bk["b15"].append(np.full(m_grp, beta15, np.bool_))
                bk["segs"].append((grp, band, bk["m"], m_grp))
                bk["m"] += m_grp
    # Queue every band_search call first, then fetch all results.
    pending = []  # (segs, device results tuple)
    k1_cdf = devstats.upload(np.asarray(cw.pvq_k1_cdf, np.int32), dev)
    split_cdf = devstats.upload(np.asarray(cw.pvq_split_cdf, np.int32), dev)
    for nn in sorted(buckets):
        bk = buckets[nn]
        rows = tab_rows[nn]
        args = [devstats.upload(a, dev) for a in (
            np.concatenate(bk["base"]), np.concatenate(bk["tsel"]),
            np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
            np.concatenate(bk["q0"]), np.concatenate(bk["b15"]))]
        devstats.dispatch()
        pending.append((bk["segs"], band_search(
            dflat, mdflat, *args, float(lam), nn, int(nn + 64),
            k1_cdf=k1_cdf, split_cdf=split_cdf,
            is_keyframe=bool(is_keyframe))))

    def finish():
        devstats.prefetch(*[r for _, res in pending for r in res])
        for segs, res in pending:
            ints = devstats.fetch(res[0])
            y = devstats.fetch(res[1], None).astype(np.int32)
            skip_diff = devstats.fetch(res[2], None).astype(np.float64)
            devstats.count("pvq_rows", len(ints))
            devstats.count("pvq_invalid_rows", int((ints[:, 5] == 0).sum()))
            for grp, band, start, m_grp in segs:
                sl = slice(start, start + m_grp)
                grp["bands"][band] = dict(
                    noref=ints[sl, 0], qg=ints[sl, 1],
                    itheta=ints[sl, 2], ts=ints[sl, 3], k=ints[sl, 4],
                    y=y[sl], skip_diff=skip_diff[sl],
                    valid=ints[sl, 5])
        return table
    return finish
