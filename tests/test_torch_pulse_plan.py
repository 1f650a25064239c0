"""The step of the PVQ pulse-search kernel (csrc/pulse_step.cuh), compiled
for the host with g++ -ffp-contract=off and run row by row, against the
plain loop (ops/cuda/pulse_kernels.py pulse_loop_plain) bit for bit:

- on the rows of every band_search call of a small lean encode (a
  keyframe and an inter frame, band lengths 8, 15, 32 and 128);
- on random rows at n = 8, 15, 32, 128 and 512 with ties (integer
  magnitudes from a small set, all-zero rows), masked lanes (a row with
  every lane masked among them), k = 0, 1, 2, 3 and large, and an
  `iters` cap that stops rows short of their pulses.

The per-row trip count, min(iters, ceil(kf - i)), which the kernel runs
in place of the batch's largest, gives the batched loop's result: each
row alone through pulse_loop_plain equals the batch.  And the wrapper
runs the plain loop on the CPU and raises on another device.

Every value compared is a float32 bit pattern, so the tolerance is zero.
The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import textured_clip
from daala_tpu_torch import native
from daala_tpu_torch.codec import headers
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.models import pvqsearch as PS
from daala_tpu_torch.ops.cuda import pulse_kernels as PK
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "daala_tpu_torch", "csrc")

_HOST = r"""
#include "pulse_step.cuh"
extern "C" void pulse_rows(int m, int n, const float *x, float *yp,
                           const float *rate_pen, const uint8_t *ok,
                           float *xy, float *yy, float *i, const float *kf,
                           const float *rdo, const float *norm_1, int iters,
                           const float *rsq16, const int32_t *seed) {
  for (int r = 0; r < m; r++)
    ps_row_host(n, x + (size_t)r * n, yp + (size_t)r * n,
                rate_pen + (size_t)r * n, ok + (size_t)r * n, xy + r, yy + r,
                i + r, kf[r], rdo[r], norm_1[r], iters, rsq16, seed);
}
extern "C" int pulse_trips(float kf, float i, int iters) {
  return ps_trips(kf, i, iters);
}
"""


@pytest.fixture(scope="module")
def host_step(tmp_path_factory):
    d = tmp_path_factory.mktemp("pulse_step")
    src, so = d / "pulse_host.cc", d / "pulse_host.so"
    src.write_text(_HOST)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", CSRC, str(src), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.pulse_rows.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                               + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.pulse_rows.restype = None
    lib.pulse_trips.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.c_int]
    lib.pulse_trips.restype = ctypes.c_int
    return lib


def _host_loop(lib, x, yp, xy, yy, i, kf, rdo_pulses, norm_1, rate_pen,
               lane_ok, iters):
    """The header's row loop over every row: (yp, xy, yy, i) as numpy."""
    f = lambda t: np.ascontiguousarray(t.numpy(), np.float32)
    m, n = x.shape
    ins = [f(x), f(rate_pen),
           np.ascontiguousarray(lane_ok.numpy(), np.uint8), f(kf),
           f(rdo_pulses.float()), f(norm_1),
           f(PK._rsqrt16(torch.device("cpu"))),
           np.ascontiguousarray(PK._rsqrt_seed(torch.device("cpu")).numpy())]
    outs = [f(yp).copy(), f(xy).copy(), f(yy).copy(), f(i).copy()]
    p = lambda a: a.ctypes.data
    if m:
        lib.pulse_rows(m, n, p(ins[0]), p(outs[0]), p(ins[1]), p(ins[2]),
                       p(outs[1]), p(outs[2]), p(outs[3]), p(ins[3]),
                       p(ins[4]), p(ins[5]), iters, p(ins[6]), p(ins[7]))
    return outs


def _assert_bits(got, want):
    for g, w in zip(got, want):
        w = np.ascontiguousarray(w.numpy(), np.float32)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


class _Capture:
    """Replaces pvqsearch.pulse_loop, keeping copies of its inputs and
    its outputs (the plain loop's, on the CPU)."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(PS, "pulse_loop", self)

    def __call__(self, *args):
        ins = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        out = PK.pulse_loop(*args)
        self.calls.append((ins, out))
        return out


@pytest.fixture(scope="module")
def encode_rows():
    """The pulse_loop inputs and outputs of every band_search call of a
    lean encode of a 160x96 textured clip (a keyframe and an inter frame)
    on the CPU."""
    if native.get_lib() is None:
        pytest.fail("the native engine did not build")
    mp = pytest.MonkeyPatch()
    try:
        cap = _Capture(mp)
        w, h = 160, 96
        enc = Encoder(headers.Info(pic_width=w, pic_height=h), quant=18,
                      complexity=7, device="cpu", use_device_analysis=False,
                      use_device_pvq=True)
        for fr in textured_clip(w, h, 2):
            enc.encode_frame(fr)
        enc.flush()
    finally:
        mp.undo()
    return cap.calls


def test_step_matches_plain_on_encode_rows(host_step, encode_rows):
    ns = sorted({args[0].shape[1] for args, _ in encode_rows})
    assert ns == [8, 15, 32, 128], ns
    steps = 0
    for args, want in encode_rows:
        _assert_bits(_host_loop(host_step, *args), want)
        steps += int((want[3] - args[4]).sum())
    assert steps > 0  # the loop placed pulses


def _random_inputs(n, m, seed, iters=None):
    """pulse_loop's inputs from _pulse_search's own init on random rows:
    magnitudes from a small integer set (ties), a tenth of the rows
    zero, random masked lanes (one row all masked), k from 0..3 and
    large, distortion scales over decades."""
    rng = np.random.default_rng(seed)
    xc = rng.choice([-3.0, -1.0, 0.0, 1.0, 2.0, 3.0, 7.0], (m, n))
    xc[: m // 10] = 0
    xc[m // 10: m // 5] = rng.normal(0, 40, (m // 5 - m // 10, n)).round()
    k = rng.choice([0, 1, 2, 3, 5, 9, 40, n + 20], m)
    g2 = 10.0 ** rng.uniform(-3, 4, m)
    lane_ok = rng.random((m, n)) > 0.15
    lane_ok[:, 0] |= rng.random(m) > 0.5
    lane_ok[1] = False
    cap = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(PS, "pulse_loop",
                   lambda *a: cap.append(a) or PK.pulse_loop(*a))
        PS._pulse_search(torch.from_numpy(xc.astype(np.float32)),
                         torch.from_numpy(k), torch.from_numpy(
                             g2.astype(np.float32)), 0.147, n,
                         n + 64 if iters is None else iters,
                         lane_ok=torch.from_numpy(lane_ok))
    finally:
        mp.undo()
    return cap[0]


@pytest.mark.parametrize("n,m", [(8, 600), (15, 600), (32, 300),
                                 (128, 120), (512, 24)])
@pytest.mark.parametrize("capped", [False, True])
def test_step_matches_plain_on_random_rows(host_step, n, m, capped):
    args = _random_inputs(n, m, n + m + capped, iters=3 if capped else None)
    want = PK.pulse_loop_plain(*args)
    got = _host_loop(host_step, *args)
    _assert_bits(got, want)
    ok = (want[3] >= args[5]).numpy()
    if capped:
        assert not ok.all()  # the cap stopped some rows short
    else:
        assert ok.all()


def test_trip_count(host_step):
    """ps_trips is min(iters, ceil(kf - i)), 0 where nothing is needed."""
    for kf, i, iters in [(0, 0, 10), (3, 3, 10), (3, 5, 10), (7, 2, 10),
                         (7, 2, 4), (200, 0, 264), (1, 0, 0)]:
        assert host_step.pulse_trips(kf, i, iters) == \
            min(iters, max(0, int(np.ceil(kf - i))))


@pytest.mark.parametrize("n", [8, 15, 128])
def test_row_trip_counts_give_the_batched_result(n):
    """Each row alone through the plain loop (which then runs exactly its
    own trip count) equals the batched loop, which runs the batch's
    largest trip count with finished rows frozen."""
    args = _random_inputs(n, 80, 7 * n)
    need = torch.ceil(args[5] - args[4]).clamp_min(0)
    assert int(need.min()) == 0 and int(need.max()) > 3  # trips differ
    batch = PK.pulse_loop_plain(*args)
    for r in range(args[0].shape[0]):
        row = PK.pulse_loop_plain(*[a[r:r + 1] if torch.is_tensor(a) else a
                                    for a in args])
        for b, o in zip(batch, row):
            assert torch.equal(b[r:r + 1], o)


def test_wrapper_runs_plain_on_cpu_and_raises_elsewhere():
    args = _random_inputs(15, 50, 3)
    for g, w in zip(PK.pulse_loop(*args), PK.pulse_loop_plain(*args)):
        assert torch.equal(g, w)
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        PK.pulse_loop(*meta)
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(ValueError, match="yp"):
        PK.pulse_loop(*bad)
