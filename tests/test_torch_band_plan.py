"""The band search kernels' arithmetic (csrc/band_row.cuh), compiled for
the host with g++ -ffp-contract=off and run in one thread, against the
plain versions (ops/cuda/band_kernels.py band_prologue_plain and
band_epilogue_plain) bit for bit:

- the prologue of every row (its three fused integer sums serially): the
  pulse search's rows and lane flags, each candidate's row index, every
  candidate's [g2, sinp, dth, qcgf, trate] and [i, j, ok, k, ts, kk], and
  the row's [cgf, skip_dist, dist0];
- then the pulse search's plain version on those rows, and the epilogue
  of every row as the kernel's warps run it (br_epilogue_host): task by
  task (one inter row, or 1 or 7 keyframe rows, the last task ragged),
  each pass's prefix sums and coding nodes into the warp's list of
  terms, the flushes where the kernel flushes (the terms' costs, then
  each candidate's ordered sums chain by chain: one chain, XLA's 8 lanes
  at 16 to 32 nodes, or chunks of 32), each candidate's cost and each
  row's decision: ints, y and skip_diff;

at n = 8, 15, 32 and 128 (every form of the sums), inter and keyframe
rows, 2,048 rows each: magnitudes from tens to 32,767 (sums past 2^24),
rows of zeros (zero gains, k = 0), zero references, quantizers over two
decades, both betas, and the codeword-rate trees of the frame-start CDF
tables; at n = 15 also the fast rate model (no CDF tables).  Dense pulses
(every node coding) fill the list past its capacity at n = 32 and 128,
so the kernel's mid-task flush runs.  The header writes out its one libm
function, glibc's atan2f (br::atan2f_glibc), and its fused multiply-adds
are fmaf, rounded once, as the plain versions' are, so every value
compared is a float32 bit pattern or an integer and the tolerance is
zero.  The kernels, which run the same functions over warps, run only on
a card (tests/test_torch_cuda.py).  Also: chip_smoke.py's count of the
epilogue's bound, over its ok candidates only.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from daala_tpu_torch.entropy.adapt import AdaptCtx
from daala_tpu_torch.ops import pvq as P
from daala_tpu_torch.ops.cuda import band_kernels as BK
from daala_tpu_torch.ops.cuda import pulse_kernels as PK
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "daala_tpu_torch", "csrc")
LAM = 0.147

_HOST = r"""
#include "band_row.cuh"
extern "C" int prologue_rows(int m, int n, int keyframe, float lam,
                             const int32_t *X, const int32_t *R,
                             const int32_t *QM, const int32_t *q0,
                             const uint8_t *b15, long long rt0, long long rt1,
                             float *xs, uint8_t *lane_ok, int32_t *src,
                             float *cf, int32_t *ci, float *rf) {
  br_prologue_host(m, n, keyframe != 0, lam, X, R, QM, q0, b15, rt0, rt1,
                   xs, lane_ok, src, cf, ci, rf);
  return 0;
}
extern "C" int epilogue_rows(int m, int n, int C, int keyframe, float lam,
                             const int32_t *y_c, const float *cos_dist,
                             const uint8_t *ok_p, const float *cf,
                             const int32_t *ci, const float *rf,
                             const int32_t *nodes_th, int ni_th,
                             const int32_t *nodes_nr, int ni_nr,
                             const int32_t *k1, long long last1,
                             const int32_t *sp, int w2, int rows2,
                             int use_cdf, int rpw, int32_t *ints, int16_t *y,
                             float *skip_diff, long long *flushes) {
  br::EpiIn a;
  a.y_c = y_c; a.cos_dist = cos_dist; a.ok_p = ok_p; a.cf = cf; a.ci = ci;
  a.rf = rf; a.k1 = k1; a.sp = sp; a.last1 = last1;
  a.w2 = w2; a.rows2 = rows2; a.use_cdf = use_cdf != 0;
  a.keyframe = keyframe != 0; a.m = m; a.n = n; a.C = C; a.lam = lam;
  int64_t f = 0;
  br_epilogue_host(a, (const br::Node *)nodes_th, ni_th,
                   (const br::Node *)nodes_nr, ni_nr, rpw, ints, y,
                   skip_diff, &f);
  *flushes = f;
  return 0;
}
extern "C" long long host_floordiv(long long a, long long b) {
  return br::floordiv_q(a, b);
}
extern "C" float host_log(float x) { return br::log(x); }
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    d = tmp_path_factory.mktemp("band_row")
    src, so = d / "band_host.cc", d / "band_host.so"
    src.write_text(_HOST)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", CSRC, str(src), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    _P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
    lib.prologue_rows.argtypes = ([_I, _I, _I, _F] + [_P] * 5 + [_L, _L]
                                  + [_P] * 6)
    lib.epilogue_rows.argtypes = ([_I, _I, _I, _I, _F] + [_P] * 6
                                  + [_P, _I, _P, _I, _P, _L, _P, _I, _I, _I,
                                     _I] + [_P] * 4)
    lib.host_floordiv.argtypes = [_L, _L]
    lib.host_floordiv.restype = _L
    lib.host_log.argtypes = [_F]
    lib.host_log.restype = _F
    return lib


def _ptr(a):
    return a.data_ptr() if torch.is_tensor(a) else a.ctypes.data


def _rows(n, m, is_keyframe, seed):
    """(X, R, qm rows, q0, beta15): the rows of a call, gathered."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(1, 4.3, (m, 1))
    X = np.clip(rng.normal(0, 1, (m, n)) * mag, -32767, 32767)
    R = np.clip(X * rng.uniform(-0.3, 1.2, (m, 1))
                + rng.normal(0, 1, (m, n)) * mag / 3, -32767, 32767)
    X[: m // 16] = 0          # zero gains
    R[m // 16: m // 8] = 0    # no reference
    if is_keyframe:
        R[:] = 0
    qm = rng.choice([16, 24, 40, 64], (m, n)).astype(np.int32)
    q0 = rng.integers(20, 2000, m).astype(np.int32)
    b15 = rng.random(m) < 0.5
    return X.astype(np.int32), R.astype(np.int32), qm, q0, b15


def _plain_prologue(X, R, qm, q0, b15, n, is_keyframe):
    m = X.shape[0]
    base = torch.arange(m, dtype=torch.int32) * n
    return BK.band_prologue_plain(
        torch.from_numpy(X.ravel()), torch.from_numpy(R.ravel()), base,
        torch.arange(m, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32)[None, :].expand(m, n)
        .contiguous(), torch.from_numpy(qm), torch.from_numpy(q0),
        torch.from_numpy(b15), LAM, n, is_keyframe)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32).numpy() if t.dtype == torch.float32 \
        else t.numpy()


def _tables(n, w1):
    return [BK.node_table(nt, w1) for nt in (n - 1, n)]


@pytest.mark.parametrize("is_keyframe", [False, True])
@pytest.mark.parametrize("n", [8, 15, 32, 128])
def test_band_row_matches_plain(host, n, is_keyframe):
    m = 2048
    X, R, qm, q0, b15 = _rows(n, m, is_keyframe, n + 100 * is_keyframe)
    pro = _plain_prologue(X, R, qm, q0, b15, n, is_keyframe)
    got = [torch.empty_like(t) for t in pro]
    rt0 = P._SQRT_TABLE[0][P._ilog(n + 1)]
    rt1 = P._SQRT_TABLE[1][P._ilog(n + 1)]
    b15_u8 = b15.astype(np.uint8)
    host.prologue_rows(m, n, int(is_keyframe), LAM, _ptr(X), _ptr(R),
                       _ptr(qm), _ptr(q0), _ptr(b15_u8), rt0, rt1,
                       *map(_ptr, got))
    for name, g, w in zip(("xs", "lane_ok", "src", "cf", "ci", "rf"), got,
                          pro):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
    xs, lane_ok, src, cf, ci, rf = pro
    assert (ci[5] == 0).any() and (ci[5] > 0).any()
    y_c, cos_dist, ok_p = PK.pulse_search_plain(
        xs, ci[5].reshape(-1), cf[0].reshape(-1), LAM, lane_ok, n + 64, src)
    adapt = AdaptCtx()
    adapt.reset(is_keyframe)
    cw = adapt.pvq.pvq_codeword_ctx
    k1 = torch.from_numpy(np.asarray(cw.pvq_k1_cdf, np.int32))
    sp = torch.from_numpy(np.asarray(cw.pvq_split_cdf, np.int32))
    cases = [(k1, sp)] + ([(None, None)] if n == 15 else [])
    for k1_cdf, split_cdf in cases:
        for rpw in ((1, 7) if is_keyframe else (1,)):
            _check_epilogue(host, (y_c, cos_dist, ok_p, cf, ci, rf), n,
                            k1_cdf, split_cdf, is_keyframe, rpw, k1, sp)


def _check_epilogue(host, res, n, k1_cdf, split_cdf, is_keyframe, rpw,
                    k1, sp):
    """The host build's epilogue (rpw rows a task) against
    band_epilogue_plain on the pulse search's result `res` and the
    prologue's fields; returns the host's mid-task flushes."""
    y_c, cos_dist, ok_p, cf, ci, rf = res
    C, m = ci.shape[1:]
    want = BK.band_epilogue_plain(y_c, cos_dist, ok_p, cf, ci, rf, LAM, n,
                                  k1_cdf, split_cdf, is_keyframe)
    ints = torch.empty((m, 6), dtype=torch.int32)
    y = torch.empty((m, n), dtype=torch.int16)
    sd = torch.empty(m, dtype=torch.float32)
    flushes = ctypes.c_longlong()
    th, nr = _tables(n, k1.shape[1])
    host.epilogue_rows(
        m, n, C, int(is_keyframe), LAM, _ptr(y_c), _ptr(cos_dist),
        _ptr(ok_p), _ptr(cf), _ptr(ci), _ptr(rf), _ptr(th), len(th),
        _ptr(nr), len(nr), _ptr(k1), k1.numel() - 1, _ptr(sp), sp.shape[1],
        sp.shape[0], int(k1_cdf is not None), rpw, _ptr(ints), _ptr(y),
        _ptr(sd), ctypes.addressof(flushes))
    for name, g, w in zip(("ints", "y", "skip_diff"), (ints, y, sd), want):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
    noref = want[0][:, 0].numpy()
    assert (noref == 1).any() and (is_keyframe or (noref == 0).any())
    return flushes.value


def _searched(n, m, is_keyframe, seed):
    """The prologue's and the pulse search's plain results on _rows, and
    the frame-start CDF tables."""
    X, R, qm, q0, b15 = _rows(n, m, is_keyframe, seed)
    xs, lane_ok, src, cf, ci, rf = _plain_prologue(X, R, qm, q0, b15, n,
                                                   is_keyframe)
    y_c, cos_dist, ok_p = PK.pulse_search_plain(
        xs, ci[5].reshape(-1), cf[0].reshape(-1), LAM, lane_ok, n + 64, src)
    adapt = AdaptCtx()
    adapt.reset(is_keyframe)
    cw = adapt.pvq.pvq_codeword_ctx
    k1 = torch.from_numpy(np.asarray(cw.pvq_k1_cdf, np.int32))
    sp = torch.from_numpy(np.asarray(cw.pvq_split_cdf, np.int32))
    return (y_c, cos_dist, ok_p, cf, ci, rf), k1, sp


@pytest.mark.parametrize("is_keyframe", [False, True])
@pytest.mark.parametrize("n", [8, 15, 32, 128])
def test_epilogue_dense_pulses(host, n, is_keyframe):
    """Pulses in every lane (magnitudes 1 to 3, and rows of +-32,767, the
    widest pulses the int16 output carries), so that every node of
    every tree codes: the list of terms, which holds 256, fills past a
    pass's worth at n = 32 and 128 and the kernel's flush before a task's
    end runs; at n = 8 and 15 a task's terms never fill it.  Keyframe
    calls also at 7 rows a task, the last task ragged (1,000 rows)."""
    m = 1000
    res, k1, sp = _searched(n, m, is_keyframe, 7 * n + is_keyframe)
    y_c = res[0]
    rng = np.random.default_rng(n)
    dense = rng.integers(1, 4, tuple(y_c.shape)) * rng.choice([-1, 1],
                                                               tuple(y_c.shape))
    dense[5] = 32767
    dense[6] = -32767
    res = (torch.from_numpy(dense.astype(np.int32)),) + res[1:]
    flushes = [_check_epilogue(host, res, n, k1, sp, is_keyframe, rpw, k1,
                               sp)
               for rpw in ((1, 7) if is_keyframe else (1,))]
    if n >= 32 and not is_keyframe:
        assert min(flushes) > 0
    if n <= 16:
        assert max(flushes) == 0


def test_floordiv_q_exact(host):
    """br::floordiv_q, the double quotient corrected to the floor, equals
    Python's floor division at the edges of its range (|a| up to 2^53, b
    up to 2^31 - 1, quotients next to integers) and, where it hands over
    to int64 division, beyond them."""
    rng = np.random.default_rng(5)
    bs = np.concatenate([[1, 2, 3, 7, (1 << 31) - 1, (1 << 31) - 2, 1 << 30,
                          1 << 31, (1 << 40) + 1, -1, -7],
                         rng.integers(1, 1 << 31, 300)])
    cases = []
    for b in bs:
        b = int(b)
        for q in (0, 1, -1, (1 << 53) // max(abs(b), 1) - 1, 12345,
                  -(1 << 21) - 3):
            for r in (0, 1, -1, abs(b) - 1):
                cases.append((q * b + r, b))
        cases += [((1 << 53) - 1, b), (-(1 << 53) + 1, b), (1 << 53, b),
                  ((1 << 62) + 5, b), (-(1 << 62) - 5, b)]
    for a, b in cases:
        if not -(1 << 63) <= a < 1 << 63:
            continue
        assert host.host_floordiv(a, b) == a // b, (a, b)


def test_log_matches_plain(host):
    """br::log, XLA's log in the header, equals xla_log on every integer
    to 2^16 (the CDF values the rates take) and on floats over nine
    decades."""
    xs = np.concatenate([
        np.arange(1, 1 << 16, dtype=np.float32),
        (10.0 ** np.random.default_rng(1).uniform(-3, 6, 20000))
        .astype(np.float32)])
    want = BK.xla_log(torch.from_numpy(xs)).numpy()
    got = np.array([host.host_log(float(v)) for v in xs], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_wrappers_refuse_other_devices():
    """The wrappers take CPU tensors to the plain versions and raise on a
    device that is neither the CPU nor CUDA."""
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        BK.band_prologue(t, t, t, t, t, t, t, t, LAM, 8, False)
    with pytest.raises(ValueError):
        BK.band_epilogue(t, t, t, t, t, t, LAM, 8, None, None, False)


@pytest.mark.parametrize("n", [8, 15, 32, 128])
@pytest.mark.parametrize("is_keyframe", [False, True])
def test_epilogue_bound_counts_ok_candidates(n, is_keyframe):
    """chip_smoke.py's bound of band_epilogue: the bytes and operations of
    the ok candidates only (ci[2]; the others cannot win and cost their
    flag), the nodes that code from those candidates' own pulses; the
    first design's count stays every candidate's."""
    import chip_smoke as CS
    rng = np.random.default_rng(n)
    C, m = (2, 9) if is_keyframe else (BK.NCAND, 6)
    y = torch.from_numpy(rng.integers(-3, 4, (C * m, n)).astype(np.int32))
    k1 = torch.zeros(12 * 16, dtype=torch.int32)
    sp = torch.zeros(98 * 8, dtype=torch.int32)

    def args(ok):
        ci = torch.zeros((6, C, m), dtype=torch.int32)
        ci[2] = torch.from_numpy(ok.astype(np.int32))
        return (y, None, None, None, ci, None, LAM, n, k1, sp, is_keyframe)

    every, none = np.ones((C, m), bool), np.zeros((C, m), bool)
    some = rng.random((C, m)) < 0.3
    some[0, 0] = True
    (b_all, w_all), (b_some, w_some), (b_none, w_none) = (
        CS.band_work("band_epilogue", args(ok)) for ok in (every, some, none))
    per = 4 * n + 37  # pulses, cos_dist, ok, 8 fields
    assert b_all - b_some == int((~some).sum()) * per
    assert b_some - b_none == int(some.sum()) * per
    assert w_none == {"ops_per_s": C * m, "flops_per_s": 0}
    assert w_none["ops_per_s"] < w_some["ops_per_s"] < w_all["ops_per_s"]
    assert CS.coding_nodes(y, torch.from_numpy(some), n, C) \
        <= CS.coding_nodes(y, torch.from_numpy(every), n, C)
    floors = {CS.band_work_floor("band_epilogue", args(ok))[0]
              for ok in (every, some, none)}
    assert floors == {b_all + 8 * C * m}
