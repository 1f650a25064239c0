"""The float32 fused multiply-add of the port's PVQ search, rounded once.

XLA:CPU contracts JAX's a * b + c into hardware FMAs, which round the
exact a b + c once to float32.  The port's plain versions take it as
ops/cuda/pulse_kernels.py `_fma32` (the sum rounded to odd in float64,
then to float32) and its kernels as csrc/pulse_step.cuh `ps_fma32`
(`__fmaf_rn` on the card, fmaf in the g++ host build compiled here).
Both are held to the exact rounding, computed with fractions.Fraction,
and `_fma32` to jitted JAX:

- triples built so that the float64 sum of the exact product and c
  lands on a float32 midpoint: a = b = 2^e (1 + 2^-12), whose product
  2^2e (1 + 2^-11 + 2^-24) is such a midpoint, and c = +-2^(2e - 70),
  far below the product's last float64 bit, at several exponents and
  signs (a float64 product and sum rounded to float32 gets wrong those
  where c pushes away from the even neighbour: 1 + 2^-11 + 2^-24 +
  2^-70 comes out 4096 ulps above 1.0 where JAX gives 4097);
- triples whose exact a b + c is a float32 subnormal a hair off a
  midpoint: a b = +-2^-150 (1 - 2^-46) and c an odd multiple of 2^-149,
  so that the float64 sum drops the 2^-196 and lands on the midpoint
  c -+ 2^-150 (XLA:CPU flushes subnormals in jitted code, so these are
  held to the exact rounding alone);
- 100,000 random triples, half of them with c chosen to bring a b + c
  within a few float64 ulps of a float32 midpoint.
"""

import ctypes
import math
import subprocess
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax

from daala_tpu_torch.ops.cuda.pulse_kernels import _fma32
from test_torch_band_plan import CSRC

import torch_threads

torch_threads.share_cores()

_HOST = r"""
#include "pulse_step.cuh"
extern "C" void fma_rows(const float *a, const float *b, const float *c,
                         float *out, long long n) {
  for (long long i = 0; i < n; i++) out[i] = ps_fma32(a[i], b[i], c[i]);
}
"""

F32_MAX = Fraction(float(np.finfo(np.float32).max))


def round_f32(q):
    """The float32 nearest the exact value q (ties to even; past the
    largest finite value, inf)."""
    if q == 0:
        return np.float32(0.0)
    sign, q = (-1, -q) if q < 0 else (1, q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > q:
        e -= 1
    e = max(e, -126)  # subnormals share the smallest normal's spacing
    step = Fraction(2) ** (e - 23)
    m = q / step
    k = math.floor(m)
    if m - k > Fraction(1, 2) or (m - k == Fraction(1, 2) and k % 2):
        k += 1
    v = k * step
    if v > F32_MAX:
        return np.float32(sign * np.inf)
    return np.float32(sign * float(v))


def exact(a, b, c):
    return np.array([round_f32(Fraction(float(x)) * Fraction(float(y))
                               + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def constructed():
    a, b, c = [], [], []
    u = 1.0 + 2.0 ** -12
    for e in (-20, -12, 0, 9, 30):
        for sa in (1, -1):
            for sb in (1, -1):
                for sc in (1, -1, 0):
                    a.append(sa * u * 2.0 ** e)
                    b.append(sb * u * 2.0 ** e)
                    c.append(sc * 2.0 ** (2 * e - 70))
    return tuple(np.array(v, np.float32) for v in (a, b, c))


def subnormal():
    """Triples whose float64 sum lands on a float32 subnormal midpoint
    while the exact a b + c lies 2^-196 off it; the last three are exact
    ties (a b = +-2^-150)."""
    a, b, c = [], [], []
    u, v = 2.0 ** -75 * (1 + 2.0 ** -23), 2.0 ** -75 * (1 - 2.0 ** -23)
    for k in (2 ** 17 + 1, 2 ** 19 + 1, 2 ** 21 + 3, 2 ** 23 - 1):
        for sa in (1, -1):
            for sb in (1, -1):
                for sc in (1, -1):
                    a.append(sa * u)
                    b.append(sb * v)
                    c.append(sc * k * 2.0 ** -149)
    for sb, k in ((1, 1), (-1, 3), (1, 2 ** 19 + 1)):
        a.append(2.0 ** -75)
        b.append(sb * 2.0 ** -75)
        c.append(k * 2.0 ** -149)
    return tuple(np.array(w, np.float32) for w in (a, b, c))


def random_triples(n=100000, seed=16):
    rng = np.random.default_rng(seed)
    f32 = lambda e: (rng.uniform(1, 2, n) * np.exp2(e)
                     * rng.choice([-1, 1], n)).astype(np.float32)
    a, b = f32(rng.integers(-30, 30, n)), f32(rng.integers(-30, 30, n))
    c = f32(rng.integers(-70, 70, n))
    # Half of them near a midpoint: c cancels the product down to the
    # float32 midpoint nearest it, give or take a few float64 ulps.
    p = a.astype(np.float64) * b.astype(np.float64)
    ulp = np.spacing(np.abs(p).astype(np.float32)).astype(np.float64)
    mid = (np.trunc(p / ulp) + 0.5) * ulp
    near = (mid - p) + np.spacing(p) * rng.integers(-3, 4, n)
    half = np.arange(n) % 2 == 0
    c[half] = near[half].astype(np.float32)
    return a, b, c


@pytest.fixture(scope="module")
def host_fma(tmp_path_factory):
    d = tmp_path_factory.mktemp("fma")
    src, so = d / "fma_host.cc", d / "fma_host.so"
    src.write_text(_HOST)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", CSRC, str(src), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.fma_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
    lib.fma_rows.restype = None

    def run(a, b, c):
        out = np.zeros(a.shape, np.float32)
        lib.fma_rows(*(np.ascontiguousarray(v).ctypes.data
                       for v in (a, b, c, out)), a.size)
        return out
    return run


def port(a, b, c):
    return _fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()


def bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def test_constructed_cases_round_once():
    a, b, c = constructed()
    want = exact(a, b, c)
    jitted = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    np.testing.assert_array_equal(bits(jitted), bits(want))
    np.testing.assert_array_equal(bits(port(a, b, c)), bits(want))
    # A float64 product and sum rounded to float32 lands on the midpoint
    # and rounds it to the even neighbour: wrong wherever c pushes the
    # exact value's magnitude up, toward the odd one.
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    up = (c != 0) & (np.sign(c) == np.sign(a) * np.sign(b))
    np.testing.assert_array_equal(bits(twice) != bits(want), up)
    u = np.float32([1 + 2.0 ** -12])
    one = bits(np.float32(1.0))
    assert bits(port(u, u, np.float32([2.0 ** -70])))[0] - one == 4097
    assert bits(port(u, u, np.float32([-2.0 ** -70])))[0] - one == 4096


def test_subnormal_cases_round_once():
    a, b, c = subnormal()
    assert (np.abs(c) < np.finfo(np.float32).tiny).all()
    want = exact(a, b, c)
    assert (np.abs(want) < np.finfo(np.float32).tiny).all()
    np.testing.assert_array_equal(bits(port(a, b, c)), bits(want))
    # Rounded twice, every case but the exact ties goes to the even
    # neighbour of the midpoint, the wrong one: c is an odd multiple.
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    np.testing.assert_array_equal(bits(twice) != bits(want),
                                  np.arange(len(a)) < len(a) - 3)


def test_random_triples_round_once():
    a, b, c = random_triples()
    want = exact(a, b, c)
    np.testing.assert_array_equal(bits(port(a, b, c)), bits(want))


def test_python_float_operands():
    """b and c may be Python floats (float32 values), as the plain
    versions pass constants."""
    a, _, _ = random_triples(1000, seed=3)
    b, c = float(np.float32(1.4)), -0.5
    got = _fma32(torch.from_numpy(a), b, c).numpy()
    want = exact(a, np.full_like(a, b), np.full_like(a, c))
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("cases", ["constructed", "subnormal", "random"])
def test_host_build_rounds_once(host_fma, cases):
    a, b, c = dict(constructed=constructed, subnormal=subnormal,
                   random=random_triples)[cases]()
    np.testing.assert_array_equal(bits(host_fma(a, b, c)),
                                  bits(exact(a, b, c)))
