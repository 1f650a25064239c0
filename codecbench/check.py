"""Whether a run's window produced what the plain reference produces.

The window records, for a sample of its frames drawn from the seed,
what each device layer of the port took and gave (`Capture`): holding
references to the outputs, copying the host arrays that the encoder
reuses, and touching neither the device nor the port's counters.  Once
the window has closed, `check` works every sampled output out again
with codecbench/reference/ (plain PyTorch that imports nothing of the
port) and counts what differs.

encode cells: the encode stages that the configuration names under
`checked_stages` (without the key, codecbench/stages' default list),
one file each, codecbench/stages/<name>.py (that package's docstring
gives a stage's parts).  Besides the stages' own numbers:
  recon_off        pixels of the window's first frames where the port's
                   decoder, on the stream, differs from the encoder's
                   reconstruction
decode cells:
  planes_off       decoded pixels against the reference synthesis and
                   dering of the frame's parsed coefficients
both:
  stages_missing   sampled frames that lack a stage their cell checks
                   (encode: one that the configuration names; decode:
                   the synthesis)

The stages that run on the host (the block-size and motion decisions,
the sweep's candidates and their acceptance, the OBMC prediction of the
frame, the entropy coding and the parse) are taken as the
port made them: the reference follows them step by step, and recon_off
holds the stream to the reconstruction end to end.  Every comparison
is exact, so every limit is 0 (PERF.md gives the readings).

`control` makes the same comparisons with the reference computed one
precision below the one the codec states, put in the port's place: each
stage says how, and the decode check runs the synthesis' lifting in
int16 in place of int32.
"""

from __future__ import annotations

import importlib
import importlib.util
import os

import numpy as np
import torch

from codecbench.reference import backend as RB
from codecbench.stages import default_names

LIMITS = {"recon_off": 0, "planes_off": 0, "stages_missing": 0}
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


def stage_names(config):
    """The encode stages that the configuration checks, in order."""
    if "checked_stages" in config:
        return list(config["checked_stages"])
    return default_names(config)


def load_stages(root, config):
    """{name: module} of the configuration's stages, each loaded from
    codecbench/stages/<name>.py under the checkout `root`."""
    out = {}
    for name in stage_names(config):
        spec = importlib.util.spec_from_file_location(
            "codecbench_stage_" + name.replace(".", "_").replace("-", "_"),
            os.path.join(root, "codecbench", "stages", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    for name, mod in out.items():
        lacking = [n for n in getattr(mod, "REQUIRES", ()) if n not in out]
        if lacking:
            raise ValueError("stage %s needs the stages %s beside it"
                             % (name, ", ".join(lacking)))
    return out


def limits(stages):
    """{number: limit} of the stages' numbers and the check's own."""
    out = {k: lim for mod in stages.values()
           for k, lim in mod.NUMBERS.items()}
    out.update(LIMITS)
    return out


class Capture:
    """Wraps the port's stage entry points for the sampled frames; the
    window sets `frame` before each frame.  `rec[frame][stage]` holds
    what a stage recorded."""

    def __init__(self, sample, stages=None):
        self.sample = set(sample)
        self.stages = stages or {}
        self.frame = None
        self.rec = {}
        self._undo = []

    def slot(self, name):
        """A function that gives the stage `name`'s record of the frame
        in flight (made on first use), or None outside the sample."""
        def get():
            if self.frame not in self.sample:
                return None
            return self.rec.setdefault(self.frame, {}).setdefault(name, {})
        return get

    def _patch(self, mod, name, make):
        orig = getattr(mod, name)
        setattr(mod, name, make(orig))
        self._undo.append((mod, name, orig))

    def uninstall(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo = []

    def install_encode(self):
        for stage, mod in self.stages.items():
            slot = self.slot(stage)
            for module, name, wrap in mod.ENTRIES:
                self._patch(importlib.import_module(module), name,
                            lambda orig: wrap(orig, slot))

    def install_decode(self):
        from daala_tpu_torch.models import synthesis as SY

        def synth(orig):
            def f(state, info, d_planes, device, **kw):
                if self.frame in self.sample:
                    self.rec.setdefault(self.frame, {})["synth"] = dict(
                        d=[np.array(p) for p in d_planes],
                        bsize=np.array(state.bsize),
                        bskip=[np.array(b) for b in state.bskip],
                        levels=np.array(state.dering_level),
                        quantizer=int(state.quantizer))
                return orig(state, info, d_planes, device, **kw)
            return f

        self._patch(SY, "synthesize_frame", synth)


class Frame:
    """One sampled encode frame as the stages compare it: its index,
    every stage's record (`rec`), the source planes, the picture and
    frame sizes, the device the reference runs on, whether this is the
    control, and a memo of reference results that several stages
    share."""

    def __init__(self, index, rec, source, config, dev, control):
        self.index = index
        self.rec = rec
        self.source = source
        self.config = config
        self.w, self.h = config["width"], config["height"]
        self.fw, self.fh = (self.w + 63) & ~63, (self.h + 63) & ~63
        self.plane_dec = PLANE_DEC
        self.dev = dev
        self.control = control
        self.idt = torch.int16 if control else torch.int32
        self._memo = {}

    def memo(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]


def count_off(got, want):
    """Entries of `got` that differ from `want`; all of the larger where
    the shapes differ."""
    got = got.cpu() if torch.is_tensor(got) else torch.from_numpy(
        np.asarray(got))
    want = want.cpu() if torch.is_tensor(want) else torch.from_numpy(
        np.asarray(want))
    if got.shape != want.shape:
        return int(max(got.numel(), want.numel()))
    return int((got.to(torch.int64) != want.to(torch.int64)).sum())


def all_off(gots, wants):
    """Mismatches over lists of planes; a missing plane counts whole."""
    if len(gots) != len(wants):
        return sum(w.numel() for w in wants) or 1
    return sum(count_off(g, w) for g, w in zip(gots, wants))


def _needed(mod, f):
    return f > 0 or not getattr(mod, "INTER_ONLY", False)


def _complete(mod, rec):
    return getattr(mod, "complete", lambda r: True)(rec)


def _encode_numbers(run, config, dev, control):
    stages = run.capture.stages
    out = {k: 0 for mod in stages.values() for k in mod.NUMBERS}
    out["stages_missing"] = 0
    for f in run.sample:
        rec = run.capture.rec.get(f, {})
        need = {name: mod for name, mod in stages.items()
                if _needed(mod, f)}
        if any(name not in rec or not _complete(mod, rec[name])
               for name, mod in need.items()):
            out["stages_missing"] += 1
            continue
        frame = Frame(f, rec, run.source(f), config, dev, control)
        for name, mod in need.items():
            for k, v in mod.compare(rec[name], frame).items():
                out[k] += v
    return out


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
        out["planes_off"] += all_off(run.decoded[f], [
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
    lim = limits(run.capture.stages)
    return {k: (v, lim[k]) for k, v in readings(run, config, dev).items()}
