"""The PVQ pulse-search kernel's arithmetic (csrc/pulse_step.cuh),
compiled for the host with g++ -ffp-contract=off and run row by row as
the whole search (the masked magnitudes, the row sums in XLA:CPU's
order, the floor-projection init, the rate penalties, the loop, the
signed pulses, ok and cos_dist), against the plain version
(ops/cuda/pulse_kernels.py pulse_search_plain) bit for bit:

- on the rows of every band_search call of a small lean encode (a
  keyframe and an inter frame, band lengths 8, 15, 32 and 128);
- on random rows at n = 8, 15, 32, 128 and 512 with ties (integer
  magnitudes from a small set, all-zero rows), magnitudes up to 32,767
  (sums past 2^24), masked lanes (a row with every lane masked among
  them), k = 0, 1, 2, 3 and large, and an `iters` cap that stops rows
  short of their pulses.

The per-row trip count, min(iters, ceil(kf - i)), which the kernel runs
in place of the batch's largest, gives the batched loop's result: each
row alone through pulse_loop_plain equals the batch.  The argmax key
orders scores as torch's argmax does.  And the wrapper runs the plain
version on the CPU and raises on another device.

Every value compared is a float32 bit pattern or an integer, so the
tolerance is zero.  The kernel itself runs only on a card
(tests/test_torch_cuda.py).
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
extern "C" int pulse_rows(int m, int n, const float *xc, const int32_t *k,
                          const float *g2, float lam, const uint8_t *ok_lanes,
                          int iters, float d0, float a0, float d1, float a1,
                          const float *rsq16, const int32_t *seed, int32_t *y,
                          float *cos_dist, uint8_t *ok, int32_t *trips) {
  for (int r = 0; r < m; r++)
    trips[r] = ps_search_row_host(
        n, xc + (size_t)r * n, k[r], g2[r], lam, ok_lanes + (size_t)r * n,
        iters, d0, a0, d1, a1, rsq16, seed, y + (size_t)r * n, cos_dist + r,
        ok + r);
  return 0;
}
extern "C" int pulse_trips(float kf, float i, int iters) {
  return ps_trips(kf, i, iters);
}
extern "C" int pulse_key(float score) { return ps_key(score); }
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
    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pulse_rows.argtypes = ([_I, _I, _P, _P, _P, _F, _P, _I]
                               + [_F] * 4 + [_P] * 6)
    lib.pulse_trips.argtypes = [_F, _F, _I]
    lib.pulse_key.argtypes = [_F]
    return lib


def _host_search(lib, xc, k, g2, lam, lane_ok, iters, src=None):
    """The header's whole search over every row (row r of xc and lane_ok,
    or row src[r]): (y, cos_dist, ok, trips) as numpy."""
    if src is not None:
        xc, lane_ok = xc[src.long()], lane_ok[src.long()]
    m, n = xc.shape
    f32 = lambda t: np.ascontiguousarray(t.numpy(), np.float32)
    ins = [f32(xc), np.ascontiguousarray(k.numpy(), np.int32), f32(g2),
           np.ascontiguousarray(lane_ok.numpy(), np.uint8),
           f32(PK._rsqrt16(torch.device("cpu"))),
           np.ascontiguousarray(PK._rsqrt_seed(torch.device("cpu")).numpy())]
    y = np.zeros((m, n), np.int32)
    cos_dist = np.zeros(m, np.float32)
    ok = np.zeros(m, np.uint8)
    trips = np.zeros(m, np.int32)
    p = lambda a: a.ctypes.data
    if m:
        lib.pulse_rows(m, n, p(ins[0]), p(ins[1]), p(ins[2]),
                       float(np.float32(lam)), p(ins[3]), iters,
                       *map(float, PK.rate_constants(n)), p(ins[4]),
                       p(ins[5]), p(y), p(cos_dist), p(ok), p(trips))
    return y, cos_dist, ok.astype(bool), trips


def _assert_same(got, want):
    """The host search's (y, cos_dist, ok) against the plain version's,
    bit for bit."""
    y, cos_dist, ok = (w.numpy() for w in want)
    np.testing.assert_array_equal(got[0], y)
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  cos_dist.view(np.int32))
    np.testing.assert_array_equal(got[2], ok)


class _Capture:
    """Replaces pvqsearch.pulse_search, keeping copies of its inputs and
    its outputs (the plain version's, on the CPU)."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(PS, "pulse_search", self)

    def __call__(self, *args):
        ins = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        out = PK.pulse_search(*args)
        self.calls.append((ins, out))
        return out


@pytest.fixture(scope="module")
def encode_rows():
    """The pulse_search inputs and outputs of every band_search call of a
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
        got = _host_search(host_step, *args)
        _assert_same(got, want)
        steps += int(got[3].sum())
    assert steps > 0  # the loop placed pulses


def _random_inputs(n, m, seed, iters=None):
    """pulse_search's inputs on random rows: magnitudes from a small
    integer set (ties), a tenth of the rows zero, a tenth normal with a
    spread of 40, a fifth up to 32,767 (sums past 2^24), random masked
    lanes (one row all masked), k from 0..3 and large, distortion scales
    over decades."""
    rng = np.random.default_rng(seed)
    xc = rng.choice([-3.0, -1.0, 0.0, 1.0, 2.0, 3.0, 7.0], (m, n))
    xc[: m // 10] = 0
    xc[m // 10: m // 5] = rng.normal(0, 40, (m // 5 - m // 10, n)).round()
    xc[m // 5: 2 * m // 5] = rng.integers(-32767, 32768,
                                          (2 * m // 5 - m // 5, n))
    k = rng.choice([0, 1, 2, 3, 5, 9, 40, n + 20], m)
    g2 = 10.0 ** rng.uniform(-3, 4, m)
    lane_ok = rng.random((m, n)) > 0.15
    lane_ok[:, 0] |= rng.random(m) > 0.5
    lane_ok[1] = False
    return (torch.from_numpy(xc.astype(np.float32)), torch.from_numpy(k),
            torch.from_numpy(g2.astype(np.float32)), 0.147, torch.from_numpy(
                lane_ok), n + 64 if iters is None else iters)


def _loop_inputs(args):
    """The arguments that pulse_search_plain hands its loop on `args`."""
    cap = []
    mp = pytest.MonkeyPatch()
    real = PK.pulse_loop_plain
    try:
        mp.setattr(PK, "pulse_loop_plain",
                   lambda *a: cap.append(a) or real(*a))
        PK.pulse_search_plain(*args)
    finally:
        mp.undo()
    return cap[0]


@pytest.mark.parametrize("n,m", [(8, 600), (15, 600), (32, 300),
                                 (128, 120), (512, 24)])
@pytest.mark.parametrize("capped", [False, True])
def test_step_matches_plain_on_random_rows(host_step, n, m, capped):
    args = _random_inputs(n, m, n + m + capped, iters=3 if capped else None)
    want = PK.pulse_search_plain(*args)
    got = _host_search(host_step, *args)
    _assert_same(got, want)
    if capped:
        assert not want[2].all()  # the cap stopped some rows short
    else:
        assert want[2].all()
    # Sums past 2^24, where their order shows.
    xx = (args[0].double() ** 2).sum(-1)
    assert float(xx.max()) > 2 ** 24


def test_trip_count(host_step):
    """ps_trips is min(iters, ceil(kf - i)), 0 where nothing is needed."""
    for kf, i, iters in [(0, 0, 10), (3, 3, 10), (3, 5, 10), (7, 2, 10),
                         (7, 2, 4), (200, 0, 264), (1, 0, 0)]:
        assert host_step.pulse_trips(kf, i, iters) == \
            min(iters, max(0, int(np.ceil(kf - i))))


def test_key_orders_scores(host_step):
    """ps_key orders every score as torch.argmax compares them: -inf
    lowest, -0 equal to +0, subnormals and both signs in place."""
    vals = np.array([-np.inf, -3.4e38, -1.5, -1e-40, -0.0, 0.0, 1e-45,
                     1e-40, 1.17549435e-38, 0.5, 1.0, 1.0000001, 3.4e38,
                     np.inf], np.float32)
    keys = [host_step.pulse_key(float(v)) for v in vals]
    for a in range(len(vals)):
        for b in range(len(vals)):
            assert (keys[a] < keys[b]) == (vals[a] < vals[b])
            assert (keys[a] == keys[b]) == (vals[a] == vals[b])
    assert min(keys) > -2 ** 31  # above a lane that holds no element


@pytest.mark.parametrize("n", [8, 15, 128])
def test_row_trip_counts_give_the_batched_result(n):
    """Each row alone through the plain loop (which then runs exactly its
    own trip count) equals the batched loop, which runs the batch's
    largest trip count with finished rows frozen."""
    args = _loop_inputs(_random_inputs(n, 80, 7 * n))
    need = torch.ceil(args[5] - args[4]).clamp_min(0)
    assert int(need.min()) == 0 and int(need.max()) > 3  # trips differ
    batch = PK.pulse_loop_plain(*args)
    for r in range(args[0].shape[0]):
        row = PK.pulse_loop_plain(*[a[r:r + 1] if torch.is_tensor(a) else a
                                    for a in args])
        for b, o in zip(batch, row):
            assert torch.equal(b[r:r + 1], o)


@pytest.mark.parametrize("n", [8, 15, 128])
def test_row_index_searches_the_chosen_rows(host_step, n):
    """With `src`, row r searches row src[r] of xc and lane_ok: the same
    result as the rows gathered first, in the plain version and in the
    header's search; src must be int32 with one entry a row."""
    xc, k, g2, lam, lane_ok, iters = _random_inputs(n, 90, 5 * n)
    rng = np.random.default_rng(n)
    src = torch.from_numpy(rng.integers(0, 80, 300).astype(np.int32))
    k2 = torch.from_numpy(rng.choice([0, 1, 2, 3, 9, n + 20], 300))
    g22 = torch.from_numpy(rng.uniform(0.1, 4, 300).astype(np.float32))
    got = PK.pulse_search(xc, k2, g22, lam, lane_ok, iters, src)
    want = PK.pulse_search_plain(xc[src.long()], k2, g22, lam,
                                 lane_ok[src.long()], iters)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                           else g, w.view(torch.int32)
                           if w.is_floating_point() else w)
    _assert_same(_host_search(host_step, xc, k2, g22, lam, lane_ok, iters,
                              src), want)
    with pytest.raises(ValueError, match="src"):
        PK.pulse_search(xc, k2, g22, lam, lane_ok, iters, src.long())
    with pytest.raises(ValueError, match="k"):
        PK.pulse_search(xc, k2[:-1], g22, lam, lane_ok, iters, src)


def test_wrapper_runs_plain_on_cpu_and_raises_elsewhere():
    args = _random_inputs(15, 50, 3)
    got, want = PK.pulse_search(*args), PK.pulse_search_plain(*args)
    assert torch.isnan(want[1]).any()  # an all-zero row with k > 0
    for g, w in zip(got, want):
        if g.is_floating_point():  # NaN too, by its bits
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        PK.pulse_search(*meta)
    bad = list(args)
    bad[2] = args[2].double()
    with pytest.raises(ValueError, match="g2"):
        PK.pulse_search(*bad)
