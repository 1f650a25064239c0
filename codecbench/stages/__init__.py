"""The encode check's stages: one file a stage, codecbench/stages/<name>.py,
found by the name in the configuration's `checked_stages`
(codecbench/check.py).

A stage file holds:

- ENTRIES: the port's entry points it wraps, each (module, function
  name, wrap), where wrap(orig, slot) returns the function put in the
  original's place.  It calls the original and, where slot() gives a
  dict (the frame in flight is sampled), records in it what the stage
  took and gave, touching neither the device nor the port's counters;
- INTER_ONLY (optional, False): the keyframe does not run the stage;
- complete(rec) (optional): whether a record holds all the comparison
  needs (a record that never finished counts in stages_missing);
- REQUIRES (optional): the stages whose records compare() also reads;
- NUMBERS: {number: limit} of what it reports;
- compare(rec, frame): {number: value}, the plain reference of
  codecbench/reference/ working the stage's outputs out again from its
  record and the frame's (codecbench/check.py Frame); with
  frame.control, the reference one precision down.

A configuration without `checked_stages` checks `default_names`'s. The
helpers below are the reference's work that several stages share.
"""

from __future__ import annotations

from codecbench.reference import frontend as RF


def default_names(config):
    """The stages of a configuration that names none: those that every
    encode configuration was checked by before stages were files (the
    lean tier's, and the colour sweep's under mv_refine_mode "sweep")."""
    sweep = config["encoder"].get("mv_refine_mode") == "sweep"
    return ["sad", "front", "search"] + (["sweep"] if sweep else [])


def front_planes(frame, dtype):
    """The reference's (d, md) planes of a frame whose `front` stage was
    recorded (md None on a keyframe), under that record's block sizes
    and OBMC prediction; one computation a frame and type."""
    fr = frame.rec["front"]

    def make():
        ref = RF.analyze(frame.source, fr["bsize"], frame.w, frame.h,
                         frame.plane_dec, fr["mc"], frame.dev, dtype)
        return (ref, None) if fr["mc"] is None else ref
    return frame.memo(("front", dtype), make)
