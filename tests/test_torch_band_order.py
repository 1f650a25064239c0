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
here only through band_search, and to glibc's atan2f in
tests/test_torch_atan2.py), and its order of the rate trees' node sums.
Computed with torch's log, acos and sums and without the contractions,
every case fails: skip_diff differs from JAX's in 26, 26, 27 and 35 of
these 256 inter rows and 3, 5, 9 and 4 keyframe rows at n = 8, 15, 32
and 128 (ints and y equal).  xla_log is also held to JAX's jnp.log alone.

The candidates' costs themselves reach no output but through the
choice, so ties are built: rows and rate multipliers at which two
candidates' costs lie within an ulp (`test_cost_ties_equal_jax`), where
XLA's two roundings of the cost and the order of its rate sums decide.

XLA:CPU's jitted code flushes float32 subnormals to zero and the port
does not; `test_lean_rows_have_no_subnormal_values` looks for them in
every float32 value of the band search on a lean encode's rows.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daala_tpu.models import pvqsearch as JPS
from daala_tpu_torch import native
from daala_tpu_torch.codec import headers
from daala_tpu_torch.codec.encoder import OD_PVQ_LAMBDA, Encoder
from daala_tpu_torch.models import pvqsearch as PS
from daala_tpu_torch.ops.cuda import band_kernels as BK
from daala_tpu_torch.ops.cuda import pulse_kernels as PK
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


def _jax_search(rows, n, is_keyframe, lam=OD_PVQ_LAMBDA):
    """JAX's band_search on rows (X, R, q0, beta15), through its gather
    interface with the identity layout (row i at dflat[i n : i n + n])."""
    X, R, q0, beta15 = rows
    m = X.shape[0]
    _, cw = _cdfs(is_keyframe)
    with jax.enable_x64(True):
        out = JPS.band_search(
            jnp.asarray(X.ravel()), jnp.asarray(R.ravel()),
            jnp.arange(m, dtype=jnp.int32) * n, jnp.zeros(m, jnp.int32),
            jnp.arange(n, dtype=jnp.int32)[None],
            jnp.full((1, n), 16, jnp.int32), jnp.asarray(q0),
            jnp.asarray(beta15), jnp.float32(lam), n, n + 64,
            k1_cdf=jnp.asarray(cw.pvq_k1_cdf, jnp.int32),
            split_cdf=jnp.asarray(cw.pvq_split_cdf, jnp.int32),
            is_keyframe=is_keyframe)
    return [np.asarray(o) for o in out]


def _port_search(rows, n, is_keyframe, lam=OD_PVQ_LAMBDA):
    X, R, q0, beta15 = rows
    m = X.shape[0]
    _, cw = _cdfs(is_keyframe)
    out = PS.band_search(
        torch.from_numpy(X.ravel()), torch.from_numpy(R.ravel()),
        torch.arange(m, dtype=torch.int32) * n,
        torch.zeros(m, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32)[None],
        torch.full((1, n), 16, dtype=torch.int32), torch.from_numpy(q0),
        torch.from_numpy(beta15), lam, n, n + 64,
        k1_cdf=torch.from_numpy(np.asarray(cw.pvq_k1_cdf, np.int32)),
        split_cdf=torch.from_numpy(np.asarray(cw.pvq_split_cdf, np.int32)),
        is_keyframe=is_keyframe)
    return [o.numpy() for o in out]


@functools.lru_cache(maxsize=None)
def _jax(n, is_keyframe):
    return _jax_search(_rows(n, is_keyframe, n + 7 * is_keyframe), n,
                       is_keyframe)


def _port(n, is_keyframe):
    return _port_search(_rows(n, is_keyframe, n + 7 * is_keyframe), n,
                        is_keyframe)


def _assert_equal(got, want):
    for name, g, w in zip(("ints", "y", "skip_diff"), got, want):
        assert g.dtype == w.dtype, name
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("is_keyframe", [False, True])
@pytest.mark.parametrize("n", [8, 15, 32, 128])
def test_band_search_equals_jax_bit_for_bit(n, is_keyframe):
    want = _jax(n, is_keyframe)
    _assert_equal(_port(n, is_keyframe), want)
    ints, _, sd = want
    # The rows reach what the test is for: sums past 2^24, k = 0 rows,
    # the noref and (inter) theta paths, NaN skip distortions.
    assert (ints[:, 4] == 0).any() and (ints[:, 4] > 0).any()
    assert (ints[:, 0] == 1).any() and (is_keyframe or (ints[:, 0] == 0)
                                        .any())
    assert is_keyframe or np.isnan(sd).any()


# Inter rows of _rows(n, False, 3) and rate multipliers (float32 bits)
# at which two candidates' costs lie within an ulp of each other, found
# by scanning lam across the crossings of each row's candidate costs:
# (n, row, lam, the row's pulses decided by the cost's second form).
_TIES = [(8, 37, 0x3E2C5CF0, True), (8, 43, 0x3DC593C4, True),
         (15, 33, 0x3E69FDF7, True), (15, 70, 0x3EB9520F, True),
         (15, 33, 0x3D800218, False), (32, 32, 0x3EBF41F1, True),
         (32, 32, 0x3EE0B7C8, True), (128, 33, 0x3DAC54FD, True),
         (128, 36, 0x3E19372C, True)]


@pytest.mark.parametrize("n,row,lam_bits,y_tie", _TIES)
def test_cost_ties_equal_jax(n, row, lam_bits, y_tie, monkeypatch):
    """At one-ulp ties in cost, every output of all 256 rows equals
    JAX's.  XLA decides `better` once a carried output, each fusion with
    its own rounding of dist + lam rate: fma(lam, rate, dist) for the
    ints, the cost and the distortion, dist + round(lam rate) in the
    inter fusion that carries the pulses.  Where y_tie the two forms
    pick different candidates, and the port with one form gets the
    row's pulses wrong.  (15, 33) at 0x3D800218 is a tie that the order
    of the 27-node rate sums decides (XLA sums 16 to 32 nodes in 8
    lanes: `node_sum`)."""
    lam = float(np.uint32(lam_bits).view(np.float32))
    rows = _rows(n, False, 3)
    want = _jax_search(rows, n, False, lam)
    _assert_equal(_port_search(rows, n, False, lam), want)
    if y_tie:
        select = BK._select
        monkeypatch.setattr(BK, "_select", lambda best, cost, cost_y, ok,
                            isnr: select(best, cost, cost, ok, isnr))
        one = _port_search([a[row:row + 1] for a in rows], n, False, lam)
        assert not np.array_equal(one[1][0], want[1][row])


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


@pytest.fixture(scope="module")
def lean_calls():
    """Every band_search call of the port's lean tier on the CPU (its
    plain versions) encoding test_torch_pvqsearch's 96x64 clip, a
    keyframe and an inter frame, at quant 8 and 40: (args, kwargs), the
    tensors cloned as the call took them (the codec goes on updating
    the arrays that a CPU upload shares)."""
    if native.get_lib() is None:
        pytest.skip("native engine unavailable")
    import content
    calls = []
    real = PS.band_search
    keep = lambda v: v.clone() if torch.is_tensor(v) else v

    def capture(*args, **kw):
        calls.append((tuple(map(keep, args)),
                      {k: keep(v) for k, v in kw.items()}))
        return real(*args, **kw)
    w, h = 96, 64
    frames = content.make_clip(w, h, 2, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PS, "band_search", capture)
        for q in (8, 40):
            enc = Encoder(headers.Info(pic_width=w, pic_height=h), quant=q,
                          complexity=7, device="cpu",
                          use_device_analysis=False, use_device_pvq=True)
            for fr in frames:
                enc.encode_frame(fr)
    return calls


def _subnormal(t):
    a = t.abs()
    return (a > 0) & (a < 2.0 ** -126)


def test_lean_rows_have_no_subnormal_values(lean_calls):
    """No float32 value of the port's plain band search on a lean
    encode's rows is subnormal: the prologue's xs, cf and rf, the pulse
    search's cos_dist and the epilogue's skip_diff, at every band length
    and frame type of the encode (16 calls, 1,452 rows).  Where one
    were, XLA:CPU, which flushes subnormals to zero in jitted code, could
    part from the port: a subnormal skip_diff must then equal JAX's
    jitted band_search on the same call."""
    lengths, rows = set(), 0
    for args, kw in lean_calls:
        (dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15, lam, n,
         iters) = args
        kf = kw["is_keyframe"]
        xs, lane_ok, src, cf, ci, rf = BK.band_prologue_plain(
            dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15, lam, n, kf)
        y_c, cos_dist, ok_p = PK.pulse_search_plain(
            xs, ci[5].reshape(-1), cf[0].reshape(-1), lam, lane_ok, iters,
            src)
        _, _, skip_diff = BK.band_epilogue_plain(
            y_c, cos_dist, ok_p, cf, ci, rf, lam, n, kw["k1_cdf"],
            kw["split_cdf"], kf)
        for name, t in (("xs", xs), ("cf", cf), ("rf", rf),
                        ("cos_dist", cos_dist)):
            assert not bool(_subnormal(t).any()), (name, n, kf)
        sub = _subnormal(skip_diff)
        if bool(sub.any()):
            jargs = [jnp.asarray(a.numpy()) if torch.is_tensor(a) else a
                     for a in args[:8]]
            with jax.enable_x64(True):
                want = JPS.band_search(
                    *jargs, jnp.float32(lam), n, iters,
                    k1_cdf=jnp.asarray(kw["k1_cdf"].numpy()),
                    split_cdf=jnp.asarray(kw["split_cdf"].numpy()),
                    is_keyframe=kf)
            np.testing.assert_array_equal(
                skip_diff[sub].numpy().view(np.int32),
                np.asarray(want[2])[sub.numpy()].view(np.int32))
        lengths.add((n, kf))
        rows += base.shape[0]
    assert len(lengths) == 8 and rows > 1000, (lengths, rows)
