"""The port's colour-sweep MV refinement (daala_tpu_torch/models/mesweep.py,
codec/mvest.py refine_sweep and the encoder's sweep seam) against the
JAX package.

On one grid captured from the host encoder right after its native
motion search, the port's committed-field statistics and its
refine_sweep must equal JAX's (XLA path on the CPU) exactly; the port's
Encoder(device="cpu", mv_refine_mode="sweep") must give packets
byte-identical to the host encoder with mv_refine_mode = "sweep".  The
seam is held to its traps: a caller's mv_override_cb still runs after
the sweep, and mv_refine_mode set after construction runs the port's
sweep (an unknown mode raises), with no jax and no daala_tpu imported.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

from daala_tpu import native
from daala_tpu.codec import headers
from daala_tpu.codec import mvest as host_mvest
from daala_tpu.codec.encoder import Encoder as HostEncoder
from daala_tpu.models import mesweep as JMS
from daala_tpu_torch.codec import mvest as t_mvest
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.models import mesweep as MS
from daala_tpu_torch.utils import devstats
from test_mesweep import _clip

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native engine unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 192, 128


class _Img:
    def __init__(self, planes):
        self.planes = planes


@pytest.fixture(scope="module")
def captured():
    """The first inter frame's state right after the native motion
    search (no greedy refinement: mv_refine_iters = 0), as the sweep
    receives it."""
    frames = _clip(W, H, 2)
    info = headers.Info(pic_width=W, pic_height=H)
    enc = HostEncoder(info, quant=18, complexity=7)
    enc.mv_refine_iters = 0
    out = {}

    def hook(frame_count, grid, ctx):
        out.update(copy.deepcopy(dict(ctx, refs=None, padded_in=None)))
        out["grid"] = copy.deepcopy(grid)
        out["refs"] = [(ri, _Img([p.copy() for p in img.planes]))
                       for ri, img in ctx["refs"]]
        out["cur"] = ctx["padded_in"][0].copy()

    enc.mv_override_cb = hook
    for fr in frames:
        enc.encode_frame(fr)
    out["decimate"] = enc.mv_decimate
    return out


def _state_args(c):
    return (c["grid"], c["info"], c["cur"],
            host_mvest._ref_slot_planes(c["refs"], c["info"]), c["vis"])


def test_committed_stats_match_jax(captured):
    """Per-leaf and per-cell SADs of the committed field."""
    state = MS.SweepState(*_state_args(captured), device="cpu")
    jstate = JMS.SweepState(*_state_args(captured))
    cells, leafsad = MS.committed_stats(state)
    jcells, jleafsad = JMS.committed_stats(jstate)
    assert np.array_equal(cells, jcells) and cells.sum() > 0
    assert sorted(leafsad) == sorted(jleafsad)
    for lms in leafsad:
        assert np.array_equal(leafsad[lms], jleafsad[lms])


def test_eval_leaf_batch_matches_jax(captured):
    """Corner-substituted leaves, as the sweep builds them."""
    state = MS.SweepState(*_state_args(captured), device="cpu")
    jstate = JMS.SweepState(*_state_args(captured))
    rng = np.random.default_rng(3)
    for lms, cls in state.classes.items():
        mvs = cls["mvs"] + rng.integers(-24, 25, cls["mvs"].shape,
                                        dtype=np.int32)
        args = (cls["pos"], cls["srcs"], mvs, cls["ocs"], cls["ss"])
        assert np.array_equal(MS.eval_leaf_batch(state, lms, *args),
                              JMS.eval_leaf_batch(jstate, lms, *args))


def test_refine_sweep_matches_jax(captured):
    """Same grid in, same MV field and changed-count out."""
    c = captured
    fields = {}
    for name, fn, kw in (("jax", host_mvest.refine_sweep, {}),
                         ("port", t_mvest.refine_sweep, {"device": "cpu"})):
        grid = copy.deepcopy(c["grid"])
        changed = fn(grid, c["cur"], c["refs"], c["info"], c["lam_mv"],
                     copy.deepcopy(c["adapt"]), c["vis"], c["frame_type"],
                     iters=2, decimate=c["decimate"], **kw)
        fields[name] = (changed, grid.mv.copy(), grid.mv1.copy())
    assert fields["port"][0] == fields["jax"][0] > 0
    assert np.array_equal(fields["port"][1], fields["jax"][1])
    assert np.array_equal(fields["port"][2], fields["jax"][2])


def _packets(enc, frames, b_frames=0):
    enc.keyframe_rate = 8
    enc.b_frames = b_frames
    enc.enable_encoder_check = True
    out = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
    return out + [bytes(p) for p in enc.flush()]


@pytest.mark.parametrize("b_frames,depth", [(0, 8), (2, 8), (0, 10)])
def test_sweep_encode_matches_jax_sweep(b_frames, depth):
    """The whole slice: packets byte-identical to the host encoder with
    the JAX sweep, on tests/test_mesweep.py's clip; with B-frames (the
    second MV field), and with 10-bit input and full-precision references
    (the sweep searches an 8-bit shadow of the luma)."""
    frames = _clip(W, H, 4)
    info_kw = {}
    if depth == 10:
        frames = [[p.astype(np.uint16) << 2 for p in fr] for fr in frames]
        info_kw = dict(bitdepth_mode=2, full_precision_references=True)
    host = HostEncoder(headers.Info(pic_width=W, pic_height=H, **info_kw),
                       quant=18, complexity=7)
    host.mv_refine_mode = "sweep"
    port = Encoder(headers.Info(pic_width=W, pic_height=H, **info_kw),
                   device="cpu", quant=18, complexity=7,
                   mv_refine_mode="sweep")
    devstats.reset()
    assert _packets(port, frames, b_frames) == _packets(host, frames,
                                                        b_frames)
    snap = devstats.snapshot()
    assert snap["spans_s"]["refine_sweep"] > 0 and snap["dispatches"] > 0


def test_caller_hook_runs_after_sweep(monkeypatch):
    """An assigned mv_override_cb does not replace the sweep: both run,
    the sweep first, on every inter frame; without the sweep the host
    sees the caller's callback itself."""
    order = []
    sweep = t_mvest.refine_sweep

    def counted(*args, **kwargs):
        order.append("sweep")
        return sweep(*args, **kwargs)

    def hook(frame_count, grid, ctx):
        order.append("hook")

    monkeypatch.setattr(t_mvest, "refine_sweep", counted)
    info = headers.Info(pic_width=W, pic_height=H)
    enc = Encoder(info, device="cpu", quant=18, complexity=7,
                  mv_refine_mode="sweep")
    enc.mv_override_cb = hook
    _packets(enc, _clip(W, H, 3))
    assert order == ["sweep", "hook"] * 2
    greedy = Encoder(info, device="cpu", quant=18, complexity=7)
    greedy.mv_override_cb = hook
    assert greedy.mv_override_cb is hook
    low = Encoder(info, device="cpu", quant=18, complexity=2,
                  mv_refine_mode="sweep")
    assert low.mv_override_cb is None  # the host sweeps only at >= 3


def _run(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


_PRELUDE = """
import sys
from chip_smoke import textured_clip
from daala_tpu_torch.codec import headers
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.utils import devstats
def jax_loaded():
    return sorted(m for m in sys.modules if m in ('jax', 'daala_tpu')
                  or m.startswith(('jax.', 'daala_tpu.')))
info = headers.Info(pic_width=96, pic_height=64)
frames = textured_clip(96, 64, 2)
"""


def test_sweep_mode_imports_no_jax():
    """The port in sweep mode, through two frames, imports no jax."""
    out = _run(_PRELUDE + """
enc = Encoder(info, device='cpu', quant=18, complexity=7,
              mv_refine_mode='sweep')
for fr in frames:
    enc.encode_frame(fr)
print('loaded', jax_loaded())
""")
    assert "loaded []" in out


def test_host_attribute_raises_without_jax():
    """mv_refine_mode is the port encoder's own attribute: set after
    construction to 'sweep' it runs the port's sweep, with no jax and no
    daala_tpu imported; an unknown mode raises when it is set."""
    out = _run(_PRELUDE + """
enc = Encoder(info, device='cpu', quant=18, complexity=7)
enc.mv_refine_mode = 'sweep'
devstats.reset()
for fr in frames:
    enc.encode_frame(fr)
print('sweep_s', devstats.snapshot()['spans_s'].get('refine_sweep', 0) > 0)
try:
    enc.mv_refine_mode = 'jacobi'
    print('no error')
except ValueError as e:
    print('raised', e)
print('loaded', jax_loaded())
""")
    assert "sweep_s True" in out
    assert "raised" in out and "loaded []" in out


def test_sweep_refuses_python_motion_search():
    info = headers.Info(pic_width=96, pic_height=64)
    enc = Encoder(info, device="cpu", quant=18, complexity=7,
                  mv_refine_mode="sweep")
    enc.use_native_me = False
    frames = _clip(96, 64, 2)
    enc.encode_frame(frames[0])
    with pytest.raises(RuntimeError, match="use_native_me"):
        enc.encode_frame(frames[1])
    with pytest.raises(ValueError):
        Encoder(info, device="cpu", mv_refine_mode="jacobi")
