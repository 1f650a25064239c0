"""The native motion search's greedy refinement as a wavefront over host
threads (daala_tpu_torch/native/me_enc.inc refine_wave_pass): at 1, 2, 3
and 8 threads the MV field (`valid`, `ref`, `mv`, `mv1`, the global
MVs) equals the serial run's and that of the JAX package's native engine
(daala_tpu/native: the original serial loop), and a 4-frame lean encode
gives the same packets at 1 and 8 threads.

The calls are those of lean 640x368 encodes, copied as the encoder made
them, and replayed: the first inter frame searches one reference, the
next two (the golden frame joins); each natural call runs both paths
of the selective pipeline (`sel_disp_q8`: -1 always subdivides, the
thorough path; 2^20 always takes the bypass), and the refinement stops
at its iteration limit (1, and the encoder's 2) or converges (64).
"""

import copy

import numpy as np
import pytest
import torch

from daala_tpu.codec import mvest as jmvest
from daala_tpu_torch.codec import headers, mvest
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.utils import devstats
from daala_tpu_torch.utils.profile import make_natural_clip, translation_clip
import torch_threads

torch_threads.share_cores()

W, H = 640, 368
THREADS = (1, 2, 3, 8)
THOROUGH, BYPASS = -1, 1 << 20


def _encode(clip, threads, calls=None):
    """The packets of a lean encode of `clip` with the refinement on
    `threads` threads; appends a copy of each motion-search call's
    arguments to `calls`."""
    real = mvest.estimate_all_native

    def forced(grid, cur, refs, info, *args, **kw):
        if calls is not None:
            calls.append(copy.deepcopy((grid, cur, refs, info, args, kw)))
        return real(grid, cur, refs, info, *args, threads=threads, **kw)

    enc = Encoder(headers.Info(pic_width=W, pic_height=H), quant=25,
                  complexity=7, device="cpu", use_device_analysis=False,
                  use_device_pvq=True, trial_rate_approx=True,
                  trial_prune_boost=3.0, trial_prune_rate_gate=0.5)
    enc.keyframe_rate = 256
    mvest.estimate_all_native = forced
    try:
        packets = []
        for frame in clip:
            packets += enc.encode_frame(frame)
        packets += enc.flush()
    finally:
        mvest.estimate_all_native = real
    return packets


@pytest.fixture(scope="module")
def natural():
    """(calls, packets at 8 threads, packets at 1 thread) of a 4-frame
    natural encode."""
    clip = make_natural_clip(W, H, 4, seed=3)
    calls = []
    return calls, _encode(clip, 8, calls), _encode(clip, 1)


@pytest.fixture(scope="module")
def translation():
    calls = []
    _encode(translation_clip(W, H, 3), 8, calls)
    return calls


def _field(grid):
    return (grid.valid.copy(), grid.ref.copy(), grid.mv.copy(),
            grid.mv1.copy(), list(grid.global_mvs))


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4])) \
        and a[4] == b[4]


def _levels(grid):
    """The subdivision levels of the grid's valid vertices."""
    vy, vx = np.nonzero(grid.valid)
    return {mvest.vertex_level(x, y) for y, x in zip(vy, vx)}


def _replay(call, threads_list, **over):
    """The original engine's field, and per thread count the port's field
    and its refinement counters, on a copy of `call` with `over`."""
    grid, cur, refs, info, args, kw = call
    kw = dict(kw, **over)
    g = copy.deepcopy(grid)
    assert jmvest.estimate_all_native(g, cur, refs, info, *args, **kw)
    want = _field(g)
    got = {}
    for n in threads_list:
        g = copy.deepcopy(grid)
        devstats.reset()
        assert mvest.estimate_all_native(g, cur, refs, info, *args,
                                         threads=n, **kw)
        got[n] = (_field(g), devstats.snapshot()["counts"], g)
    return want, got


def _check(want, got):
    visits = {c["me_refine_visits"] for _, c, _ in got.values()}
    assert len(visits) == 1 and visits.pop() > 0
    for n, (field, counts, _) in got.items():
        assert _same(field, want), n
        assert counts["me_refine_threads"] == n
        assert counts["me_refine_us"] > 0


def test_packets_equal_at_1_and_8_threads(natural):
    calls, at8, at1 = natural
    assert len(calls) == 3 and len(at8) == len(at1) >= 4
    assert [len(c[2]) for c in calls] == [1, 2, 2]
    assert at8 == at1


@pytest.mark.parametrize("path", ["thorough", "bypass"])
@pytest.mark.parametrize("frame", [1, 2])
def test_natural_field_equals_serial_and_original(natural, frame, path):
    call = natural[0][frame - 1]
    assert len(call[2]) == frame  # references searched
    disp = THOROUGH if path == "thorough" else BYPASS
    want, got = _replay(call, THREADS, sel_disp_q8=disp)
    _check(want, got)
    # the bypass caps the mesh at level 3; the thorough path goes finer
    assert (max(_levels(got[1][2])) > 3) == (path == "thorough")


@pytest.mark.parametrize("frame", [1, 2])
def test_translation_field_equals_serial_and_original(translation, frame):
    call = translation[frame - 1]
    assert len(call[2]) == frame
    want, got = _replay(call, THREADS)
    _check(want, got)


@pytest.mark.parametrize("iters", [1, 64])
def test_iteration_limit_and_convergence(natural, iters):
    """One pass stops at the limit; 64 passes converge (as many vertex
    evaluations as 96)."""
    call = natural[0][1]
    assert call[5]["iters"] == 2
    want, got = _replay(call, (1, 3, 8), iters=iters,
                        sel_disp_q8=THOROUGH)
    _check(want, got)
    visits = got[1][1]["me_refine_visits"]
    _, more = _replay(call, (1,), iters=iters + 32, sel_disp_q8=THOROUGH)
    assert (more[1][1]["me_refine_visits"] == visits) == (iters == 64)
