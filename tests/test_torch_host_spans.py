"""The port's two tables of spans (utils/devstats.py): the device spans
(SPANS, `spans_s`) and the host spans of the native passes between them
(HOST_SPANS, `host_spans_s`), placed in codec/encoder.py and
codec/decoder.py.

On the CPU at 128x96, the lean preset with the native engine: a
keyframe and an inter frame, greedy and with the sweep (and the
analysis tier, whose deferred dering has a span of its own), then their
decode.  Each path fills the host spans it runs and no more; the device
table keeps the names it had; no span of one table nests in a span
where the placement rules forbid it; no table sums past the frame
walls; and under torch.profiler every span is a "span:<name>" range,
where with no profiler no range is built.
"""

import time

import pytest
import torch

import content
from daala_tpu_torch import native
from daala_tpu_torch.codec import headers as H
from daala_tpu_torch.codec.decoder import Decoder
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.utils import devstats
from daala_tpu_torch.utils.profile import ENCODER_KW
import torch_threads

torch_threads.share_cores()

W, HT, NFRAMES = 128, 96, 2

ENC_HOST = {"motion_search", "mv_resolution", "mc_predict", "code_mvs",
            "trial_pass", "code_frame", "store_recon"}
ENC_DEVICE = {"analyze_keyframe", "analyze_inter", "search_frame",
              "fullpel_sad_fields"}
DEC_HOST = {"decode_mvs", "mc_predict", "parse_buffers", "parse_frame",
            "dering_host", "store_recon"}
DEC_DEVICE = {"synthesize_frame", "dering_frame"}
# Each encoder path: its keywords, its host spans, its device spans.
PATHS = {
    "greedy": (dict(use_device_analysis=False, use_device_pvq=True),
               ENC_HOST | {"pvq_table"}, ENC_DEVICE),
    "sweep": (dict(use_device_analysis=False, use_device_pvq=True,
                   mv_refine_mode="sweep"),
              ENC_HOST | {"pvq_table"}, ENC_DEVICE | {"refine_sweep"}),
    "analysis": (dict(use_device_analysis=True, use_device_pvq=False),
                 ENC_HOST | {"code_dering"},
                 {"analyze_keyframe", "analyze_inter", "analyze_rdo_pyramid",
                  "fullpel_sad_fields", "dering_candidates"}),
}


@pytest.fixture(scope="module")
def frames():
    if native.get_lib() is None:
        pytest.skip("native engine unavailable")
    return content.make_clip(W, HT, NFRAMES, seed=11)


def _info():
    return H.Info(pic_width=W, pic_height=HT)


def _encode(frames, path):
    """The clip's packets, the frame walls and the devstats snapshot of
    the frames (the flush is left out)."""
    kw = PATHS[path][0]
    enc = Encoder(_info(), device="cpu", **kw, **ENCODER_KW)
    enc.keyframe_rate = 256
    devstats.reset()
    packets, walls = [], []
    for fr in frames:
        t0 = time.perf_counter()
        packets += enc.encode_frame(fr)
        walls.append(time.perf_counter() - t0)
    snap = devstats.snapshot()
    enc.flush()
    return packets, walls, snap


def _decode(packets):
    dec = Decoder(_info(), device="cpu")
    devstats.reset()
    walls = []
    for p in packets:
        t0 = time.perf_counter()
        dec.decode_packet(p)
        walls.append(time.perf_counter() - t0)
    return walls, devstats.snapshot()


def _within_walls(walls, snap):
    total = sum(walls)
    for table in ("spans_s", "host_spans_s"):
        for name, s in snap[table].items():
            assert 0 < s <= total, (table, name, s, total)
    both = sum(snap["spans_s"].values()) + sum(snap["host_spans_s"].values())
    assert both <= total, (both, total)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_encode_fills_its_host_spans(frames, path):
    """The path's host spans, and its device spans as they were."""
    packets, walls, snap = _encode(frames, path)
    assert len(packets) == NFRAMES
    _, host, device = PATHS[path]
    assert set(snap["host_spans_s"]) == host
    assert set(snap["spans_s"]) == device
    _within_walls(walls, snap)


def test_decode_fills_its_host_spans(frames):
    packets, _, _ = _encode(frames, "greedy")
    walls, snap = _decode(packets)
    assert set(snap["host_spans_s"]) == DEC_HOST
    assert "synthesize_frame" in snap["spans_s"]
    assert set(snap["spans_s"]) <= DEC_DEVICE
    _within_walls(walls, snap)


def test_spans_never_nest_across_tables(frames, monkeypatch):
    """Every span's enter and exit, in order, through devstats' range
    hook: a host span holds no span of either table, and a device span
    holds no host span."""
    events = []

    class Logged:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            events.append(("enter", self.name))

        def __exit__(self, *exc):
            events.append(("exit", self.name))

    monkeypatch.setattr(devstats, "_range", Logged)
    host, device = set(), set()
    for path in ("greedy", "sweep"):
        packets, _, snap = _encode(frames, path)
        host |= set(snap["host_spans_s"])
        device |= set(snap["spans_s"])
    _, snap = _decode(packets)
    host |= set(snap["host_spans_s"])
    device |= set(snap["spans_s"])
    assert not host & device
    stack, seen = [], set()
    for kind, name in events:
        if kind == "enter":
            if stack:
                outer = stack[-1]
                assert outer not in host, (outer, name)
                assert not (outer in device and name in host), (outer, name)
            stack.append(name)
            seen.add(name)
        else:
            assert stack.pop() == name
    assert not stack
    assert seen == host | device
    assert "refine_sweep" in seen


def test_spans_are_profiler_ranges(frames, monkeypatch):
    """Under torch.profiler (CPU activity) every span of both tables,
    the sweep's decorator span included, is a "span:<name>" range; with
    no profiler recording, devstats builds no range."""
    from torch.profiler import ProfilerActivity, profile
    built = []
    real = torch.profiler.record_function

    def counted(name, *args, **kw):
        built.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    packets, _, off = _encode(frames, "sweep")
    assert off["host_spans_s"] and "refine_sweep" in off["spans_s"]
    assert not [n for n in built if n.startswith("span:")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, enc_snap = _encode(frames, "sweep")
        _, dec_snap = _decode(packets)
    ranges = {e.name() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("span:")}
    want = set()
    for snap in (enc_snap, dec_snap):
        want |= set(snap["spans_s"]) | set(snap["host_spans_s"])
    assert ranges == {"span:" + n for n in want}
    assert "span:refine_sweep" in ranges


def test_reset_clears_both_tables():
    with devstats.span("d"):
        pass
    with devstats.host_span("h"):
        pass
    snap = devstats.snapshot()
    assert "d" in snap["spans_s"] and "h" in snap["host_spans_s"]
    devstats.reset()
    snap = devstats.snapshot()
    assert snap["spans_s"] == {} and snap["host_spans_s"] == {}
