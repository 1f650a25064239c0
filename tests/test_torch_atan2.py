"""glibc's float32 atan2f, as the port writes it out, against glibc's own.

XLA:CPU calls glibc's scalar atan2f in JAX's arccos (band_search's
theta), so the port carries it written out: csrc/band_row.cuh
br::atan2f_glibc (fdlibm's __ieee754_atan2f and __atanf as glibc 2.36
has them, every operation through ps_add / ps_mul / ps_div), which the
prologue kernel runs on the card, and its plain PyTorch version
ops/cuda/band_kernels.py atan2f_glibc, which acos_xla runs on every
device.  Held bit for bit to the host's glibc atan2f (2.36 here, the
library that JAX's XLA:CPU calls on this host):

- the header built with g++ -ffp-contract=off, in the form band_search
  takes it, acos(c) = atan2f(sqrtf((1 - c)(c + 1)), c), on every 64th
  float32 c in [-1, 1], every c within 2^16 ulps of -1, 0 and 1, both
  zeros and every subnormal; and atan2f itself on (y, x) pairs of every
  kind (zeros, infinities, NaNs, x = 1, ratios past 2^+-60);
- the plain version, acos_xla on the CPU, on a 2^22-point sample of
  those c, and atan2f_glibc on the same pairs.  (torch's float32 sqrt
  on the CPU misses the correctly rounded root on some c near +-1;
  acos_xla takes the root in float64.)

Run as a script (`python tests/test_torch_atan2.py [THREADS]`) it makes
the exhaustive pass of the header over all 2,130,706,434 c in [-1, 1]
(both zeros counted), by default on every core of the host.
"""

import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from daala_tpu_torch.ops.cuda import band_kernels as BK  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.share_cores()

CSRC = os.path.join(os.path.dirname(HERE), "daala_tpu_torch", "csrc")
ONE = 0x3F800000  # the bit pattern of 1.0
SIGN = 0x80000000

_HOST = r"""
#include "band_row.cuh"
static float acos_glibc(float c) {
  return atan2f(sqrtf((1.0f - c) * (c + 1.0f)), c);
}
static bool same(float a, float b) { return memcmp(&a, &b, 4) == 0; }
// The c of bit patterns lo, lo + step, ... <= hi, with `sign` or-ed in,
// where br::acos_xla differs from glibc's atan2f.
extern "C" long long acos_diffs(uint32_t lo, uint32_t hi, uint32_t step,
                                uint32_t sign) {
  long long d = 0;
  for (uint64_t u = lo; u <= hi; u += step) {
    const uint32_t b = (uint32_t)u | sign;
    float c;
    memcpy(&c, &b, 4);
    if (!same(br::acos_xla(c), acos_glibc(c))) d++;
  }
  return d;
}
extern "C" void acos_libm(const float *c, float *out, long long n) {
  for (long long i = 0; i < n; i++) out[i] = acos_glibc(c[i]);
}
extern "C" void atan2_both(const float *y, const float *x, float *mine,
                           float *libm, long long n) {
  for (long long i = 0; i < n; i++) {
    mine[i] = br::atan2f_glibc(y[i], x[i]);
    libm[i] = atan2f(y[i], x[i]);
  }
}
"""


def build(out_dir):
    src, so = (os.path.join(out_dir, "atan2_host" + e) for e in (".cc",
                                                                ".so"))
    with open(src, "w") as f:
        f.write(_HOST)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", CSRC, src, "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.acos_diffs.argtypes = [ctypes.c_uint32] * 4
    lib.acos_diffs.restype = ctypes.c_longlong
    lib.acos_libm.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
    lib.acos_libm.restype = None
    lib.atan2_both.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
    lib.atan2_both.restype = None
    return lib


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build(str(tmp_path_factory.mktemp("atan2")))


def _windows():
    """(lo, hi) bit-pattern ranges, each taken with both signs: within
    2^16 ulps of 0 (every subnormal, and both zeros) and of 1."""
    return [(0, 0x7FFFFF), (0x800000, 0x800000 + (1 << 16)),
            (ONE - (1 << 16), ONE)]


def _sample(points=1 << 22):
    """float32 c: about `points` spread evenly over [-1, 1], and the
    windows near -1, 0 and 1 cut to 2^16 patterns each."""
    u = np.linspace(0, ONE, points // 2, dtype=np.float64).astype(np.uint32)
    near = [np.arange(lo, min(hi, lo + (1 << 16)) + 1, dtype=np.uint32)
            for lo, hi in _windows()]
    u = np.unique(np.concatenate([u] + near))
    return np.concatenate([u, u | SIGN]).view(np.float32)


def _pairs():
    """(y, x) float32 pairs of every kind atan2f distinguishes."""
    rng = np.random.default_rng(16)
    special = np.float32([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan,
                          1e-40, -1e-40, 3.0, -2.0, 1e30, -1e-30, 0.4375,
                          2.4375, 1.1875, 0.6875])
    y, x = (a.ravel() for a in np.meshgrid(special, special))
    bits = rng.integers(0, 1 << 32, (2, 1 << 18), dtype=np.uint64)
    ry, rx = (b.astype(np.uint32).view(np.float32) for b in bits)
    # Ratios |y / x| over the whole range, and x = 1 (atanf of y).
    e = rng.integers(-70, 70, 1 << 16).astype(np.float32)
    near_y = (rng.uniform(-2, 2, 1 << 16) * np.exp2(e)).astype(np.float32)
    near_x = rng.uniform(-2, 2, 1 << 16).astype(np.float32)
    return (np.concatenate([y, ry, near_y, near_y]),
            np.concatenate([x, rx, near_x, np.ones(1 << 16, np.float32)]))


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def _same(a, b):
    return (_bits(a) == _bits(b)) | (np.isnan(a) & np.isnan(b))


def test_header_equals_glibc_on_every_64th_c(host):
    for sign in (0, SIGN):
        assert host.acos_diffs(0, ONE, 64, sign) == 0
        for lo, hi in _windows():
            assert host.acos_diffs(lo, hi, 1, sign) == 0


def test_header_atan2_equals_glibc_on_pairs(host):
    y, x = _pairs()
    mine, libm = np.zeros_like(y), np.zeros_like(y)
    host.atan2_both(y.ctypes.data, x.ctypes.data, mine.ctypes.data,
                    libm.ctypes.data, y.size)
    assert _same(mine, libm).all()


def test_plain_acos_equals_glibc(host):
    c = _sample()
    want = np.zeros_like(c)
    host.acos_libm(c.ctypes.data, want.ctypes.data, c.size)
    got = BK.acos_xla(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_plain_atan2_equals_glibc(host):
    y, x = _pairs()
    mine, libm = np.zeros_like(y), np.zeros_like(y)
    host.atan2_both(y.ctypes.data, x.ctypes.data, mine.ctypes.data,
                    libm.ctypes.data, y.size)
    got = BK.atan2f_glibc(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert _same(got, libm).all()


def exhaustive(threads=None):
    """(c compared, c where the header differs from glibc's atan2f) over
    every float32 c in [-1, 1]."""
    threads = threads or os.cpu_count() or 1
    with tempfile.TemporaryDirectory() as d:
        lib = build(d)
        step = -(-(ONE + 1) // threads)
        jobs = [(lo, min(lo + step - 1, ONE), sign)
                for sign in (0, SIGN) for lo in range(0, ONE + 1, step)]
        with ThreadPoolExecutor(threads) as ex:
            diffs = sum(ex.map(lambda j: lib.acos_diffs(j[0], j[1], 1, j[2]),
                               jobs))
    return 2 * (ONE + 1), diffs


if __name__ == "__main__":
    import platform
    n, d = exhaustive(int(sys.argv[1]) if len(sys.argv) > 1 else None)
    print("%s: br::acos_xla against atan2f on every float32 c in [-1, 1]: "
          "%d of %d differ" % (platform.libc_ver(), d, n))
