"""band_search's float32 expressions in XLA:CPU's order.

The port's band_search (daala_tpu_torch/models/pvqsearch.py, through
ops/cuda/band_kernels.py's plain versions on the CPU) against JAX's
jitted band_search (daala_tpu/models/pvqsearch.py, with x64) on the
same rows, bit for bit in every output: noref, qg, itheta, max_theta,
k, valid, the pulses y and skip_diff, NaN where JAX has NaN.  At n = 8,
15, 32 and 128, inter and keyframe calls of 256 rows each: magnitudes
up to 32,767 (sums past 2^24), rows of zeros (zero gains: k = 0 and a
0 / 0 correlation), rows without a reference, quantizers over two
decades and both betas.

What makes it hold, read in JAX's optimized HLO and LLVM IR (the module
docstring of ops/cuda/band_kernels.py lists them): the fused
multiply-adds LLVM contracts the distortions, the theta rate and the
cost into, XLA's rewrite of the correlation's quotient, its folded
theta scale, its own float32 log (`xla_log`), glibc's scalar atan2f in
its arccos (a jitted jnp.arccos alone, over an array, vectorizes into
another atan2 and differs in about 0.2% of values, so acos_xla is held
only through band_search), and its order of the rate trees' node sums.
Computed with torch's log, acos and sums and without the contractions,
every case fails: skip_diff differs from JAX's in 26, 26, 27 and 35 of
these 256 inter rows and 3, 5, 9 and 4 keyframe rows at n = 8, 15, 32
and 128 (ints and y equal).  xla_log is also held to JAX's jnp.log alone.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daala_tpu.models import pvqsearch as JPS
from daala_tpu_torch.codec.encoder import OD_PVQ_LAMBDA
from daala_tpu_torch.models import pvqsearch as PS
from daala_tpu_torch.ops.cuda import band_kernels as BK
from test_torch_pvqsearch import _cdfs

import torch_threads

torch_threads.share_cores()

M = 256


def _rows(n, is_keyframe, seed):
    """(X, R, q0, beta15): half the rows uniform up to 32,767, half of
    magnitude about 3,000; 16 rows without a reference and 16 of zeros."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-32767, 32768, (M, n)).astype(np.float64)
    X[M // 2:] = rng.normal(0, 3000, (M - M // 2, n))
    R = X * rng.uniform(-0.2, 1.2, (M, 1)) + rng.normal(0, 1000, (M, n))
    R[:16] = 0
    X[16:32] = 0
    if is_keyframe:
        R[:] = 0
    q0 = rng.choice([20, 40, 200, 1000], M).astype(np.int32)
    beta15 = np.arange(M) % 2 == 0
    clip = lambda a: np.clip(a, -32767, 32767).astype(np.int32)
    return clip(X), clip(R), q0, beta15


@functools.lru_cache(maxsize=None)
def _jax(n, is_keyframe):
    """JAX's band_search on _rows(n, is_keyframe), through its gather
    interface with the identity layout (row i at dflat[i n : i n + n])."""
    X, R, q0, beta15 = _rows(n, is_keyframe, n + 7 * is_keyframe)
    _, cw = _cdfs(is_keyframe)
    with jax.enable_x64(True):
        out = JPS.band_search(
            jnp.asarray(X.ravel()), jnp.asarray(R.ravel()),
            jnp.arange(M, dtype=jnp.int32) * n, jnp.zeros(M, jnp.int32),
            jnp.arange(n, dtype=jnp.int32)[None],
            jnp.full((1, n), 16, jnp.int32), jnp.asarray(q0),
            jnp.asarray(beta15), jnp.float32(OD_PVQ_LAMBDA), n, n + 64,
            k1_cdf=jnp.asarray(cw.pvq_k1_cdf, jnp.int32),
            split_cdf=jnp.asarray(cw.pvq_split_cdf, jnp.int32),
            is_keyframe=is_keyframe)
    return [np.asarray(o) for o in out]


def _port(n, is_keyframe):
    X, R, q0, beta15 = _rows(n, is_keyframe, n + 7 * is_keyframe)
    _, cw = _cdfs(is_keyframe)
    out = PS.band_search(
        torch.from_numpy(X.ravel()), torch.from_numpy(R.ravel()),
        torch.arange(M, dtype=torch.int32) * n,
        torch.zeros(M, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32)[None],
        torch.full((1, n), 16, dtype=torch.int32), torch.from_numpy(q0),
        torch.from_numpy(beta15), OD_PVQ_LAMBDA, n, n + 64,
        k1_cdf=torch.from_numpy(np.asarray(cw.pvq_k1_cdf, np.int32)),
        split_cdf=torch.from_numpy(np.asarray(cw.pvq_split_cdf, np.int32)),
        is_keyframe=is_keyframe)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("is_keyframe", [False, True])
@pytest.mark.parametrize("n", [8, 15, 32, 128])
def test_band_search_equals_jax_bit_for_bit(n, is_keyframe):
    want = _jax(n, is_keyframe)
    got = _port(n, is_keyframe)
    for name, g, w in zip(("ints", "y", "skip_diff"), got, want):
        assert g.dtype == w.dtype, name
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    ints, _, sd = want
    # The rows reach what the test is for: sums past 2^24, k = 0 rows,
    # the noref and (inter) theta paths, NaN skip distortions.
    assert (ints[:, 4] == 0).any() and (ints[:, 4] > 0).any()
    assert (ints[:, 0] == 1).any() and (is_keyframe or (ints[:, 0] == 0)
                                        .any())
    assert is_keyframe or np.isnan(sd).any()


def test_xla_log_equals_jax():
    """xla_log equals JAX's jitted jnp.log on every integer to 2^17 (the
    CDF values and max-theta counts the rates take) and on 100,000
    floats over nine decades; torch.log does not."""
    xs = np.concatenate([
        np.arange(1, 1 << 17, dtype=np.float32),
        (10.0 ** np.random.default_rng(0).uniform(-3, 6, 100000))
        .astype(np.float32)])
    want = np.asarray(jax.jit(jnp.log)(xs)).view(np.int32)
    got = BK.xla_log(torch.from_numpy(xs)).numpy().view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert (torch.log(torch.from_numpy(xs)).numpy().view(np.int32)
            != want).any()
