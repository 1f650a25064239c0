"""The PVQ pulse search's row sums in XLA:CPU's order.

The port's _pulse_search (daala_tpu_torch/models/pvqsearch.py, through
ops/cuda/pulse_kernels.py pulse_search) against JAX's jitted
_pulse_search (daala_tpu/models/pvqsearch.py) on the CPU, bit for bit in
y, cos_dist and ok, at the codec's band lengths n = 8, 15, 32 and 128:
rows from a numpy seed, half of them with magnitudes up to 32,767 so
that x.x passes 2^24, where the order of a float32 sum shows in its
last bit; masked lanes as band_search masks them (the theta path's last
lane); k = 0 among the targets.  Then band_search itself against JAX's
on such rows, an inter call and a keyframe call: every decision and
the pulses bit for bit.

XLA:CPU's order, read inside JAX's _pulse_search: for n <= 32 each dot
product is one chain of fused multiply-adds from lane 0 up and each
plain sum one chain; longer rows are summed in chunks of 32 lanes (each
product rounded to float32 first), each chunk a chain, then the chunk
sums in order.  (band_search's skip_diff, whose distortions are
float32 expressions that XLA:CPU contracts into fused multiply-adds
outside the pulse search, takes those forms too:
ops/cuda/band_kernels.py, tests/test_torch_band_order.py.)  With
torch.sum, which the port took before, cos_dist
differs from JAX's in hundreds of these rows at every n (y and ok
agree), so these tests fail there.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from daala_tpu.models import pvqsearch as JPS
from daala_tpu_torch.codec.encoder import OD_PVQ_LAMBDA
from daala_tpu_torch.models import pvqsearch as PS
from daala_tpu_torch.ops import pvq as P
from test_pvqsearch import _search as jax_search
from test_torch_pvqsearch import _cdfs, _port_search

import torch_threads

torch_threads.share_cores()

LAM = 0.147


@functools.lru_cache(maxsize=None)
def _jax_pulse_search():
    return jax.jit(JPS._pulse_search, static_argnums=(4, 5))


def _rows(n, m, seed):
    """(xc, k, g2, lane_ok): rows of magnitudes about 50, half of them
    uniform up to 32,767; k from 0 to 200; distortion scales over six
    decades; the last lane masked in half the rows."""
    rng = np.random.default_rng(seed)
    xc = rng.normal(0, 50, (m, n)).round()
    big = rng.random(m) < 0.5
    xc[big] = rng.integers(-32767, 32768, (int(big.sum()), n))
    k = rng.choice([0, 1, 2, 3, 5, 9, 17, 40, 200], m).astype(np.int32)
    g2 = (10.0 ** rng.uniform(-3, 3, m)).astype(np.float32)
    lane_ok = np.ones((m, n), bool)
    lane_ok[rng.random(m) < 0.5, n - 1] = False
    return xc.astype(np.float32), k, g2, lane_ok


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n", [8, 15, 32, 128])
def test_pulse_search_matches_jax_bit_for_bit(n):
    xc, k, g2, lane_ok = _rows(n, 2000, n)
    want = _jax_pulse_search()(xc, k, g2, LAM, n, n + 64, lane_ok)
    got = PS._pulse_search(torch.from_numpy(xc), torch.from_numpy(k),
                           torch.from_numpy(g2), LAM, n, n + 64,
                           lane_ok=torch.from_numpy(lane_ok))
    xx = (np.where(lane_ok, xc, 0).astype(np.float64) ** 2).sum(1)
    assert (xx > 2 ** 24).sum() > 500 and (k == 0).any()
    for name, g, w in zip(("y", "cos_dist", "ok"), got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=name)


@pytest.mark.parametrize("is_keyframe", [False, True])
def test_band_search_matches_jax_bit_for_bit(is_keyframe):
    """band_search on rows whose sums pass 2^24: every decision, the
    pulses and skip_diff equal JAX's bit for bit (NaN where JAX has
    NaN)."""
    n = 32
    _, cw = _cdfs(is_keyframe)
    qm = np.full(n, 16, np.int32)
    rng = np.random.default_rng(11 + is_keyframe)
    X = rng.integers(-32767, 32768, (64, n)).astype(np.int32)
    X[32:] = rng.normal(0, 3000, (32, n)).astype(np.int32)
    R = (X * rng.uniform(-0.2, 1.2, (64, 1))
         + rng.normal(0, 1000, (64, n))).astype(np.int32)
    R = np.clip(R, -32767, 32767)
    if is_keyframe:
        R[:] = 0
    want = jax_search(X, R, qm, 40, P.BETA_1, OD_PVQ_LAMBDA, cw,
                      is_keyframe=is_keyframe)
    got = _port_search(X, R, qm, 40, P.BETA_1, OD_PVQ_LAMBDA, cw,
                       is_keyframe)
    for i in (0, 1, 2, 3, 4, 5, 7):
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
    np.testing.assert_array_equal(_bits(got[6]), _bits(want[6]),
                                  err_msg="skip_diff")
