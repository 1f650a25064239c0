"""Whether a run's window produced what the plain reference produces.

The window records, for a sample of its frames drawn from the seed,
what each device layer of the port took and gave (`Capture`): holding
references to the outputs, copying the host arrays that the encoder
reuses, and touching neither the device nor the port's counters.  Once
the window has closed, `check` works every sampled output out again
with codecbench/reference/ (plain PyTorch that imports nothing of the
port) and counts what differs:

encode cells (the frame's keyframe and inter frames as they came):
  sad_fields_off   full-pel SAD field entries, against their definition
                   on the source luma and the reference planes
  sweep_cells_off  (sweep configurations) 8x8-cell SADs of the colour
                   sweep's leaf batches, against the reference's OBMC
                   prediction of the same leaves and MVs on the source
  coeffs_off       coefficients of the front end's d (and md) planes,
                   against the lapped transform of the source frame
                   (and of the OBMC prediction) under the frame's
                   block-size map
  pvq_rows_off     band rows whose decision (noref, gain, theta, max
                   theta, k, valid, pulses, skip_diff) differs from the
                   reference band search on the reference's planes,
                   under the quantisation matrices that the reference
                   works out from the configuration
  recon_off        pixels of the window's first frames where the port's
                   decoder, on the stream, differs from the encoder's
                   reconstruction
decode cells:
  planes_off       decoded pixels against the reference synthesis and
                   dering of the frame's parsed coefficients
both:
  stages_missing   sampled frames whose device layers were never seen

The stages that run on the host (the block-size and motion decisions,
the sweep's candidates and their acceptance, the OBMC prediction of the
frame, the entropy coding and the parse) are taken as the
port made them: the reference follows them step by step, and recon_off
holds the stream to the reconstruction end to end.  Every comparison
is exact, so every limit is 0 (PERF.md gives the readings).

`control` makes the same comparisons with the reference computed one
precision below the one the codec states (int16 in place of int32, the
OBMC filter's accumulator wrapped to int16, the PVQ search's planes
rounded to bfloat16) put in the port's place.
"""

from __future__ import annotations

import numpy as np
import torch

from codecbench.reference import backend as RB
from codecbench.reference import frontend as RF
from codecbench.reference import obmc as RO
from codecbench.reference import pvq as RV
from codecbench.reference import sad as RS
from codecbench.reference import search as RP

LIMITS = {"sad_fields_off": 0, "sweep_cells_off": 0, "coeffs_off": 0,
          "pvq_rows_off": 0, "recon_off": 0, "planes_off": 0,
          "stages_missing": 0}
PLANE_DEC = ((0, 0), (1, 1), (1, 1))  # 4:2:0


def sample_frames(seed, within, count):
    """`count` of the `within` frames that every window finishes: the
    keyframe (frame 0), the last of them (after the encoder's state,
    reference slots and buffers have turned over), and count - 2 others
    drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(np.arange(1, within - 1), size=count - 2,
                      replace=False)
    return sorted({0, within - 1} | {int(i) for i in pick})


def _planes(sps):
    """The whole planes of a list of ShardedPlanes as tensors on their
    device (no copy for a single tile)."""
    return [sp.to(sp.device) for sp in sps]


class Capture:
    """Wraps the port's stage entry points for the sampled frames; the
    window sets `frame` before each frame."""

    def __init__(self, sample):
        self.sample = set(sample)
        self.frame = None
        self.rec = {}
        self._undo = []

    def _on(self):
        return self.frame in self.sample

    def _slot(self):
        return self.rec.setdefault(self.frame, {})

    def _patch(self, mod, name, make):
        orig = getattr(mod, name)
        setattr(mod, name, make(orig))
        self._undo.append((mod, name, orig))

    def uninstall(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo = []

    def install_encode(self):
        from daala_tpu_torch.models import keyframe as KF
        from daala_tpu_torch.models import mefield as MF
        from daala_tpu_torch.models import mesweep as MS
        from daala_tpu_torch.models import pvqsearch as PS

        def sad(orig):
            def f(cur, refs_padded, pad, vis, nvmvbs, nhmvbs, r=16, **kw):
                out = orig(cur, refs_padded, pad, vis, nvmvbs, nhmvbs, r,
                           **kw)
                if self._on():
                    self._slot()["sad"] = dict(
                        refs=[np.array(p) for p in refs_padded], pad=pad,
                        vis=tuple(vis), nvmvbs=nvmvbs, nhmvbs=nhmvbs, r=r,
                        out=[np.array(o) for o in out])
                return out
            return f

        def keyframe(orig):
            def f(state, info, padded_planes, lossless, device, **kw):
                out, finish = orig(state, info, padded_planes, lossless,
                                   device, **kw)
                if self._on():
                    self._slot()["front"] = dict(
                        bsize=np.array(state.bsize), mc=None,
                        d=_planes(out), md=None)
                return out, finish
            return f

        def inter(orig):
            def f(state, info, padded_planes, mc_planes, lossless, device,
                  **kw):
                d, md, finish = orig(state, info, padded_planes, mc_planes,
                                     lossless, device, **kw)
                if self._on():
                    self._slot()["front"] = dict(
                        bsize=np.array(state.bsize),
                        mc=[np.array(p) for p in mc_planes],
                        d=_planes(d), md=_planes(md))
                return d, md, finish
            return f

        def search(orig):
            def f(st, info, quantizer, d_planes, md_planes, lam,
                  is_keyframe=False, use_masking=True, **kw):
                finish = orig(st, info, quantizer, d_planes, md_planes, lam,
                              is_keyframe=is_keyframe,
                              use_masking=use_masking, **kw)
                if not self._on():
                    return finish
                cw = st.adapt.pvq.pvq_codeword_ctx
                slot = self._slot()
                slot["search"] = dict(
                    k1=np.array(cw.pvq_k1_cdf),
                    split=np.array(cw.pvq_split_cdf), quantizer=quantizer,
                    lam=float(lam), is_keyframe=bool(is_keyframe))

                def finished():
                    table = finish()
                    slot["search"]["table"] = port_table(table)
                    return table
                return finished
            return f

        def leaf_cells(orig):
            def f(state, lms, pos, srcs, mvs, ocs, ss):
                out = orig(state, lms, pos, srcs, mvs, ocs, ss)
                if self._on():
                    slot = self._slot().setdefault(
                        "sweep", dict(planes4=state.planes4, pad=state.pad,
                                      calls=[]))
                    slot["calls"].append((lms, *(np.array(a) for a in (
                        pos, srcs, mvs, ocs, ss, out))))
                return out
            return f

        self._patch(MF, "fullpel_sad_fields", sad)
        self._patch(MS, "leaf_cells_batch", leaf_cells)
        self._patch(KF, "analyze_keyframe", keyframe)
        self._patch(KF, "analyze_inter", inter)
        self._patch(PS, "search_frame", search)

    def install_decode(self):
        from daala_tpu_torch.models import synthesis as SY

        def synth(orig):
            def f(state, info, d_planes, device, **kw):
                if self._on():
                    self._slot()["synth"] = dict(
                        d=[np.array(p) for p in d_planes],
                        bsize=np.array(state.bsize),
                        bskip=[np.array(b) for b in state.bskip],
                        levels=np.array(state.dering_level),
                        quantizer=int(state.quantizer))
                return orig(state, info, d_planes, device, **kw)
            return f

        self._patch(SY, "synthesize_frame", synth)


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


def _count_off(got, want):
    got = got.cpu() if torch.is_tensor(got) else torch.from_numpy(
        np.asarray(got))
    want = want.cpu() if torch.is_tensor(want) else torch.from_numpy(
        np.asarray(want))
    if got.shape != want.shape:
        return int(max(got.numel(), want.numel()))
    return int((got.to(torch.int64) != want.to(torch.int64)).sum())


def _all_off(gots, wants):
    """Mismatches over lists of planes; a missing plane counts whole."""
    if len(gots) != len(wants):
        return sum(w.numel() for w in wants) or 1
    return sum(_count_off(g, w) for g, w in zip(gots, wants))


def _encode_numbers(run, config, dev, control):
    w, h = config["width"], config["height"]
    fw, fh = (w + 63) & ~63, (h + 63) & ~63
    idt = torch.int16 if control else torch.int32
    sweep = config["encoder"].get("mv_refine_mode") == "sweep"
    qm, pvq_qm = stated_qm(config)
    masking = config["encoder"].get("use_activity_masking", True)
    out = {"sad_fields_off": 0, "coeffs_off": 0, "pvq_rows_off": 0,
           "stages_missing": 0}
    if sweep:
        out["sweep_cells_off"] = 0
    for f in run.sample:
        rec = run.capture.rec.get(f, {})
        src = run.source(f)
        need = ("front", "search") + (("sad",) if f > 0 else ()) + (
            ("sweep",) if f > 0 and sweep else ())
        if any(k not in rec for k in need) or "table" not in rec["search"]:
            out["stages_missing"] += 1
            continue
        if f > 0:
            s = rec["sad"]
            out["sad_fields_off"] += _all_off(s["out"], [
                RS.sad_fields(src[0], ref, s["pad"], s["vis"], s["nvmvbs"],
                              s["nhmvbs"], s["r"], dev, idt)
                for ref in s["refs"]])
        if f > 0 and sweep:
            out["sweep_cells_off"] += _sweep_off(rec["sweep"], src[0], w, h,
                                                 dev, control)
        fr = rec["front"]
        planes = _front(src, fr, w, h, dev, idt)
        out["coeffs_off"] += _all_off(fr["d"] + (fr["md"] or []),
                                      planes[0] + (planes[1] or []))
        sr = rec["search"]
        d_in, md_in = _front(src, fr, w, h, dev, torch.int32) \
            if control else planes
        if control:
            d_in = [bf16_round(p) for p in d_in]
            md_in = None if md_in is None else [bf16_round(p) for p in md_in]
        want = RP.search(d_in, md_in, fr["bsize"], qm, pvq_qm, sr["k1"],
                         sr["split"], sr["quantizer"], sr["lam"], fw, fh,
                         PLANE_DEC, sr["is_keyframe"], masking)
        out["pvq_rows_off"] += rows_off(sr["table"], want)
    return out


def stated_qm(config):
    """The quantisation matrices that the configuration states, worked
    out by the reference from its quant, its `qm` (1, Daala's default,
    the HVS matrix; 0 flat) and its activity masking (on by default):
    nothing of them is taken from the port."""
    enc = config["encoder"]
    return RV.stated_qm(config["quant"], enc.get("qm", 1) == 1,
                        enc.get("use_activity_masking", True),
                        len(PLANE_DEC))


def _sweep_off(sw, cur, w, h, dev, control):
    """Cell SADs of the sweep's leaf batches that differ from the
    reference's OBMC prediction of the same leaves (the same MVs, corner
    sources and splits) against the source luma."""
    planes4 = sw["planes4"].to(dev)
    cur_t = torch.from_numpy(np.ascontiguousarray(cur[:h, :w])).to(dev)
    off = 0
    for lms, pos, srcs, mvs, ocs, ss, got in sw["calls"]:
        log_n = lms + 3
        scal = torch.from_numpy(RO.leaf_args(
            pos, srcs, mvs, ocs, ss, sw["pad"], log_n, log_n,
            tuple(planes4.shape[1:]))).to(dev)
        off += _count_off(got, RO.leaf_cells(planes4, cur_t, scal, log_n,
                                             control))
    return off


def _front(src, fr, w, h, dev, dtype):
    """The reference's (d, md) planes of a captured frame (md None on a
    keyframe)."""
    ref = RF.analyze(src, fr["bsize"], w, h, PLANE_DEC, fr["mc"], dev, dtype)
    return (ref, None) if fr["mc"] is None else ref


def bf16_round(p):
    """An int32 plane with each value rounded to the nearest bfloat16,
    back in int32: the data path of a search one precision below
    float32."""
    return p.to(torch.float32).to(torch.bfloat16).to(torch.float32) \
        .round().to(torch.int32)


def _decode_numbers(run, config, dev, control):
    w, h = config["width"], config["height"]
    idt = torch.int16 if control else torch.int32
    out = {"planes_off": 0, "stages_missing": 0}
    for f in run.sample:
        rec = run.capture.rec.get(f, {})
        if "synth" not in rec or f not in run.decoded:
            out["stages_missing"] += 1
            continue
        s = rec["synth"]
        want = RB.reconstruct(s["d"], s["bsize"], s["bskip"], s["levels"],
                              s["quantizer"], w, h, PLANE_DEC, dev, idt)
        out["planes_off"] += _all_off(run.decoded[f], [
            torch.from_numpy(p) for p in want])
    return out


def readings(run, config, dev, control=False):
    """Each compared number of the run, from the sound reference, or with
    `control` from the reference one precision down."""
    if run.mode == "encode":
        out = _encode_numbers(run, config, dev, control)
        if not control:
            out["recon_off"] = run.recon_off
        return out
    return _decode_numbers(run, config, dev, control)


def check(run, config, dev):
    """{name: (value, limit)} of every compared number."""
    return {k: (v, LIMITS[k]) for k, v in readings(run, config, dev).items()}
