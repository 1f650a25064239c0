"""The port's PVQ band search (daala_tpu_torch/models/pvqsearch.py) and
its lean encoder tier (Encoder(use_device_analysis=False,
use_device_pvq=True)) against the JAX package and the host search.

- The fixed-point helpers equal JAX's bit for bit (int64, JAX with
  x64) on random and edge integers: zero, negatives, 2^31 - 1, values
  above 2^32, shifts out of range both ways.
- _codeword_rate equals a jitted JAX _codeword_rate alone within 1e-4
  bits (XLA fuses it otherwise than inside band_search, whose forms the
  port takes: tests/test_torch_band_order.py); the fast rate model bit
  for bit.
- band_search equals JAX's band_search (through test_pvqsearch.py's
  identity layout) for n = 8 and 15, inter and keyframe: the integer
  outputs and y on at least 99% of rows, and skip_diff bit for bit on
  those rows (NaN where JAX has NaN).  The float RDO is float32 on both
  sides; near-ties may flip, hence the 99% bar.
- Replayed through the port's pvq_theta(forced=...), its decisions
  agree with the host search on more than 85% of rows (the bar of
  test_pvqsearch.py).
- The lean tier end to end on the CPU (the five cases of
  test_pvqsearch.py): bytes within 5% and luma PSNR within 0.3 dB of
  the host encoder's search, the encoder check on, the port's Decoder
  equal to the encoder's reconstruction; the reference decoder's leg
  runs where its oracle is available.
- Inside a lean encode of one 96x64 clip, JAX's search_frame on the
  same inputs gives the same decision table on at least 99% of rows,
  and DevicePVQTable.get (the Python coefficient path's view) answers
  exactly as JAX's on the same table.
- band_search's operations (each one launch on a card) do not grow with
  the row count.
- Marked slow (several minutes): bench.py's 1080p clip through the
  host search, JAX's lean tier and the port's, tables compared at every
  frame.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import content
from daala_tpu import native
from daala_tpu.codec import headers as H
from daala_tpu.codec.encoder import Encoder as HostEncoder
from daala_tpu.models import pvqsearch as JPS
from daala_tpu.utils.metrics import psnr
from daala_tpu_torch.codec import pvq_codec as PC
from daala_tpu_torch.codec.decoder import Decoder
from daala_tpu_torch.codec.encoder import Encoder, OD_PVQ_LAMBDA
from daala_tpu_torch.entropy.adapt import AdaptCtx
from daala_tpu_torch.models import pvqsearch as PS
from daala_tpu_torch.ops import pvq as P
from daala_tpu_torch.utils import devstats
from test_pvqsearch import _search as jax_search

try:
    import codec_oracle as co
    co.get_lib()
    HAVE_ORACLE = True
except Exception:  # pragma: no cover
    HAVE_ORACLE = False

import torch_threads

torch_threads.share_cores()

needs_native = pytest.mark.skipif(native.get_lib() is None,
                                  reason="native engine unavailable")

# ---------------------------------------------------------------------------
# The fixed-point helpers, bit for bit.
# ---------------------------------------------------------------------------

EDGES = [0, 1, -1, 2, 3, 7, 15, 16, 17, 255, 256, 4095, 4096, 32767, 32768,
         -32768, -32769, 65535, 65536, 131071, 131072, (1 << 31) - 1,
         -(1 << 31), 1 << 31, (1 << 32) - 1, 1 << 32, (1 << 32) + 5,
         (1 << 40) + 3, -(1 << 40)]


def _ints(seed, lo=None, hi=None, count=400):
    """EDGES, then random int64s in several magnitude ranges (or in
    [lo, hi) when given)."""
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.integers(lo, hi, count).astype(np.int64)
    parts = [np.array(EDGES, np.int64)]
    for bits in (8, 16, 31, 33, 41):
        parts.append(rng.integers(-(1 << bits), 1 << bits, count // 5))
    return np.concatenate(parts).astype(np.int64)


def _shifts(seed, count):
    return np.random.default_rng(seed).integers(-70, 71, count) \
        .astype(np.int64)


def _both(name, *args, **kw):
    """(JAX result, port result) of helper `name` on numpy arguments
    (int64 arrays, bool arrays or Python values), as lists of numpy
    arrays."""
    def jx(a):
        return jnp.asarray(a) if isinstance(a, np.ndarray) else a

    def tx(a):
        return torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    with jax.enable_x64(True):
        want = getattr(JPS, name)(*map(jx, args), **kw)
        want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                        else (want,))]
    got = getattr(PS, name)(*map(tx, args), **kw)
    got = [g.numpy() if torch.is_tensor(g) else np.asarray(g)
           for g in (got if isinstance(got, tuple) else (got,))]
    return want, got


def _cases():
    x = _ints(1)
    n = len(x)
    pos = np.abs(x)
    small = _ints(2, -(1 << 17), 1 << 17)
    m = len(small)
    return {
        "_ilog": (pos,),
        "_ilog_c": (x,),
        "_shl32": (x, _shifts(3, n)),
        "_shl32#scalar": (x, 17),
        "_wrap16": (x,),
        "_shr_round": (x, 7),
        "_vshr": (x, _shifts(4, n)),
        "_vshr_round": (x, _shifts(5, n)),
        "_mult16_16_q15": (x, _ints(6)),
        "_mult16_16_q16": (x, _ints(7)),
        "_mult16_32_qbeta": (x, _ints(8)),
        "_od_rcp": (x,),
        "_rsqrt_norm": (x,),
        "_sqrt_norm": (x,),
        "_od_sqrt": (pos,),
        "_od_exp2": (x,),
        "_od_log2": (x,),
        "_od_pow": (pos, P.beta_rcp(P.BETA_1_5)),
        "_gain_compand": (pos, _ints(9, 1, 5000, n),
                          np.arange(n) % 2 == 0),
        "_gain_expand#1": (small, _ints(10, 1, 5000, m), P.BETA_1),
        "_gain_expand#1.5": (np.abs(small), _ints(11, 1, 5000, m),
                             P.BETA_1_5),
        "_gain_expand#other": (np.abs(small), _ints(12, 1, 5000, m),
                               P.beta_q12(1.25)),
        "_cos_pi_2": (_ints(13, -(1 << 16), 1 << 16),),
        "_pvq_cos": (x,),
        "_pvq_sin": (x,),
        "_compute_max_theta": (x, np.arange(n) % 3 == 0),
        "_compute_theta": (_ints(14, -5, 200, 400), _ints(15, -3, 60, 400)),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_helper_matches_jax(case):
    want, got = _both(case.split("#")[0], *_cases()[case])
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.mark.parametrize("n", [8, 15, 32])
@pytest.mark.parametrize("noref", [True, False])
def test_compute_k_matches_jax(n, noref):
    qcg = _ints(20 + n, -50, 1 << 15, 600)
    qcg[:4] = [0, P.OD_CGAIN_SCALE, 1, (1 << 31) - 1]
    itheta = _ints(21 + n, -3, 1 << 15, 600)
    itheta[:3] = [0, 1, (1 << 31) - 1]
    beta15 = np.arange(600) % 2 == 1
    want, got = _both("_compute_k", qcg, -1 if noref else itheta, noref,
                      n, beta15)
    np.testing.assert_array_equal(got[0].astype(np.int64),
                                  want[0].astype(np.int64))


@pytest.mark.parametrize("n", [8, 15, 128])
def test_compute_gain_and_householder_match_jax(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-40000, 40000, (64, n)).astype(np.int64)
    r = rng.integers(-40000, 40000, (64, n)).astype(np.int64)
    x[:2] = 0
    r[2:4] = 0
    r[4] = 32767
    x[5] = -(1 << 20)
    q0 = rng.integers(1, 3000, 64).astype(np.int64)
    beta15 = np.arange(64) % 2 == 0
    bshift = rng.integers(0, 12, 64).astype(np.int64)
    want, got = _both("_compute_gain", x, q0, beta15, bshift)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w.astype(np.int64))
    want, got = _both("_apply_householder", x, r)
    np.testing.assert_array_equal(got[0], want[0].astype(np.int64))


# ---------------------------------------------------------------------------
# The codeword rate and the band search against JAX.
# ---------------------------------------------------------------------------


def _cdfs(is_keyframe):
    adapt = AdaptCtx()
    adapt.reset(is_keyframe)
    return adapt, adapt.pvq.pvq_codeword_ctx


_jax_codeword_rate = jax.jit(JPS._codeword_rate, static_argnums=(2, 3))


@pytest.mark.parametrize("n", [8, 15, 128])
def test_fast_rate_matches_jax(n):
    """The fast rate model (band_search without CDF tables), float32 on
    both sides: bit for bit (its lane sum in XLA:CPU's order and XLA's
    log, ops/cuda/band_kernels.py)."""
    rng = np.random.default_rng(200 + n)
    y = rng.integers(-6, 7, (64, n)).astype(np.int32)
    y[:3] = 0
    k = np.abs(y).sum(1).astype(np.int32)
    n_eff = np.where(np.arange(64) % 2 == 0, n, n - 1)[:, None]
    with jax.enable_x64(True):
        want = np.asarray(JPS._fast_rate(jnp.asarray(y), jnp.asarray(k),
                                         jnp.asarray(n_eff), n, None))
    got = PS._fast_rate(torch.from_numpy(y), torch.from_numpy(k),
                        torch.from_numpy(n_eff), n)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("n", [8, 15, 32, 128])
def test_codeword_rate_matches_jax(n):
    rng = np.random.default_rng(100 + n)
    _, cw = _cdfs(False)
    y = np.zeros((96, n), np.int32)
    for i in range(96):
        k = int(rng.integers(0, 3 * n))
        lanes = rng.integers(0, n - (i % 2), k)
        np.add.at(y[i], lanes, rng.choice([-1, 1], k))
    k = np.abs(y).sum(1).astype(np.int32)
    for n_tree in (n, n - 1):
        yt = y.copy()
        yt[:, n_tree:] = 0
        with jax.enable_x64(True):
            want = np.asarray(_jax_codeword_rate(
                jnp.asarray(yt), jnp.asarray(k), n_tree, n,
                jnp.asarray(cw.pvq_k1_cdf, jnp.int32),
                jnp.asarray(cw.pvq_split_cdf, jnp.int32)))
        got = PS._codeword_rate(
            torch.from_numpy(yt), torch.from_numpy(k), n_tree, n,
            torch.from_numpy(np.asarray(cw.pvq_k1_cdf, np.int32)),
            torch.from_numpy(np.asarray(cw.pvq_split_cdf, np.int32)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def _f32_bits(a):
    """The bit patterns of float32 values, every NaN made one NaN."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def _port_search(X, R, qm, q0, beta, lam, cw, is_keyframe=False, tile=1):
    """band_search through the identity layout of test_pvqsearch._search
    (row i's band at dflat[i*n : i*n+n]), the rows repeated `tile`
    times."""
    X = np.tile(np.asarray(X, np.int32), (tile, 1))
    R = np.tile(np.asarray(R, np.int32), (tile, 1))
    m, n = X.shape
    ints, y, sd = PS.band_search(
        torch.from_numpy(X.ravel()), torch.from_numpy(R.ravel()),
        torch.arange(m, dtype=torch.int32) * n,
        torch.zeros(m, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32)[None, :],
        torch.from_numpy(np.asarray(qm, np.int32))[None, :],
        torch.full((m,), q0, dtype=torch.int32),
        torch.full((m,), beta == P.BETA_1_5), lam, n, n + 64,
        k1_cdf=torch.from_numpy(np.asarray(cw.pvq_k1_cdf, np.int32)),
        split_cdf=torch.from_numpy(np.asarray(cw.pvq_split_cdf, np.int32)),
        is_keyframe=is_keyframe)
    ints = ints.numpy()
    return [ints[:, 0], ints[:, 1], ints[:, 2], ints[:, 3], ints[:, 4],
            y.numpy().astype(np.int32), sd.numpy(), ints[:, 5]]


def _rows(n, is_keyframe, seed):
    """test_pvqsearch.py's random rows: (X, R, q0) per magnitude."""
    rng = np.random.default_rng(seed)
    out = []
    for mag, q0 in ((120, 110), (700, 60), (40, 200)):
        X = rng.normal(0, mag, (48, n)).astype(np.int32)
        R = (X * rng.uniform(-0.2, 1.2, (48, 1))
             + rng.normal(0, mag / 3, (48, n))).astype(np.int32)
        R[:4] = 0
        X[4:6] = 0
        if is_keyframe:
            R[:] = 0
        out.append((X, R, q0))
    return out


@pytest.mark.parametrize("is_keyframe", [False, True])
@pytest.mark.parametrize("n,beta", [(15, P.BETA_1), (8, P.BETA_1_5)])
def test_band_search_matches_jax(n, beta, is_keyframe):
    _, cw = _cdfs(is_keyframe)
    qm = np.full(n, 16, np.int32)
    equal = total = 0
    for X, R, q0 in _rows(n, is_keyframe, 7 + n):
        want = jax_search(X, R, qm, q0, beta, OD_PVQ_LAMBDA, cw,
                          is_keyframe=is_keyframe)
        got = _port_search(X, R, qm, q0, beta, OD_PVQ_LAMBDA, cw,
                           is_keyframe)
        same = np.ones(len(X), bool)
        for i in (0, 1, 2, 3, 4, 7):
            same &= got[i] == want[i]
        same &= (got[5] == want[5]).all(1)
        np.testing.assert_array_equal(_f32_bits(got[6][same]),
                                      _f32_bits(want[6][same]))
        equal += int(same.sum())
        total += len(X)
    assert equal >= 0.99 * total, (equal, total)


@pytest.mark.parametrize("n,beta,is_keyframe",
                         [(15, P.BETA_1, False), (8, P.BETA_1_5, False),
                          (15, P.BETA_1_5, True)])
def test_band_search_matches_host(n, beta, is_keyframe):
    """The port's decisions, replayed through its pvq_theta(forced=...),
    are dominated by exact matches with the host search, and every
    decision replays consistently (test_pvqsearch.py's bar)."""
    adapt, cw = _cdfs(is_keyframe)
    lam = OD_PVQ_LAMBDA
    qm = np.full(n, 16, np.int32)
    qm_inv = [4096] * n
    agree = total = 0
    for X, R, q0 in _rows(n, is_keyframe, 7 + n)[:2 if not is_keyframe
                                                 else 3]:
        noref, qg, itheta, ts, k, y, sdf, valid = _port_search(
            X, R, qm, q0, beta, lam, cw, is_keyframe)
        for i in range(len(X)):
            if not valid[i]:
                continue
            out_h, y_h = [0] * n, [0] * n
            h = PC.pvq_theta(out_h, X[i].tolist(), R[i].tolist(), n, q0,
                             y_h, beta, 1, is_keyframe, 0, adapt,
                             qm.tolist(), qm_inv, lam, 0)
            if is_keyframe:
                assert noref[i] == 1
            e = (int(noref[i]), int(qg[i]), int(itheta[i]), int(ts[i]),
                 int(k[i]), y[i], float(sdf[i]))
            out_d, y_d = [0] * n, [0] * n
            d = PC.pvq_theta(out_d, X[i].tolist(), R[i].tolist(), n, q0,
                             y_d, beta, 1, is_keyframe, 0, adapt,
                             qm.tolist(), qm_inv, lam, 0, forced=e)
            assert d[3] == int(k[i])
            if not is_keyframe:
                assert d[1] == int(itheta[i])
            total += 1
            agree += (h[0] == d[0] and h[3] == d[3]
                      and (is_keyframe or h[1] == d[1])
                      and list(out_h) == list(out_d))
    assert total > 80
    assert agree / total > 0.85, (agree, total)


class _Ops(TorchDispatchMode):
    """Counts the aten operations run under it (each is at most one
    launch on a card)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("is_keyframe", [False, True])
def test_band_search_ops_do_not_grow_with_rows(is_keyframe):
    """The same rows 1x and 8x: the same number of operations (the pulse
    loop's trip count depends on the rows' pulses, not their number)."""
    _, cw = _cdfs(is_keyframe)
    X, R, q0 = _rows(15, is_keyframe, 3)[0]
    _port_search(X, R, np.full(15, 16), q0, P.BETA_1_5, OD_PVQ_LAMBDA, cw,
                 is_keyframe)  # fills the module's device-table caches
    counts = []
    for tile in (1, 8):
        with _Ops() as ops:
            _port_search(X, R, np.full(15, 16), q0, P.BETA_1_5,
                         OD_PVQ_LAMBDA, cw, is_keyframe, tile=tile)
        counts.append(ops.count)
    assert counts[0] == counts[1], counts


# ---------------------------------------------------------------------------
# The lean tier end to end.
# ---------------------------------------------------------------------------


def _run(frames, w, h, q, lean):
    """Packets, bytes and mean luma PSNR of the host search (lean False:
    daala_tpu's host encoder) or of the port's lean tier on the CPU,
    decoded by the port's Decoder.  In the lean run the encoder check
    is on, and every decoded frame must equal the encoder's
    reconstruction."""
    info = H.Info(pic_width=w, pic_height=h)
    if lean:
        e = Encoder(info, quant=q, complexity=7, device="cpu",
                    use_device_analysis=False, use_device_pvq=True)
        e.enable_encoder_check = True
    else:
        e = HostEncoder(info, quant=q, complexity=7)
    e.keyframe_rate = 256
    d = Decoder(info, use_device_synthesis=False)
    pkts, outs = list(e.flush_headers()), []
    for fr in frames:
        for p in e.encode_frame(fr):
            pkts.append(p)
            outs.extend(d.decode_packet(p))
            if lean:
                for a, b in zip(d.last_recon, e.recon):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))
    assert not e.flush()
    ps = float(np.mean([psnr(a[0].astype(np.float64),
                             b[0].astype(np.float64))
                        for a, b in zip(frames, outs)]))
    return pkts, sum(len(p) for p in pkts[3:]), ps


@needs_native
@pytest.mark.parametrize("w,h,q", [
    (96, 64, 8), (96, 64, 18), (96, 64, 40),
    (160, 112, 18), (160, 112, 40),
])
def test_lean_tier_end_to_end(w, h, q):
    """Bytes within 5% and PSNR within 0.3 dB of the host search; the
    search ran (rows counted); the port's Decoder reproduces the
    encoder's reconstruction of every frame."""
    frames = content.make_clip(w, h, 4, seed=5)
    _, nb_h, ps_h = _run(frames, w, h, q, False)
    devstats.reset()
    _, nb_d, ps_d = _run(frames, w, h, q, True)
    snap = devstats.snapshot()
    assert snap["counts"]["pvq_rows"] > 0
    assert snap["spans_s"]["search_frame"] > 0
    assert abs(nb_d - nb_h) / nb_h < 0.05, (nb_h, nb_d)
    assert abs(ps_d - ps_h) < 0.3, (ps_h, ps_d)


@needs_native
@pytest.mark.skipif(not HAVE_ORACLE, reason="reference oracle unavailable")
def test_lean_tier_reference_decoder():
    w, h, q = 96, 64, 18
    frames = content.make_clip(w, h, 4, seed=5)
    pkts, _, _ = _run(frames, w, h, q, True)
    d = Decoder(H.Info(pic_width=w, pic_height=h),
                use_device_synthesis=False)
    outs = [o for p in pkts[3:] for o in d.decode_packet(p)]
    rd = co.RefDecoder(pkts[:3])
    routs = [fr for p in pkts[3:] for fr in rd.decode_packet(p)]
    assert len(routs) == len(frames)
    for a, b in zip(outs, routs):
        for pl in range(3):
            np.testing.assert_array_equal(np.asarray(a[pl]),
                                          np.asarray(b[pl]))


@pytest.fixture(scope="module")
def lean_table_pairs():
    """A lean encode of a 96x64 clip (a keyframe and an inter frame, all
    blocks 4x4 so that one band length runs), with JAX's search_frame
    run on the same inputs at every search_frame call: the list of
    (is_keyframe, JAX's table, the port's table)."""
    if native.get_lib() is None:
        pytest.skip("native engine unavailable")
    w, h = 96, 64
    frames = content.make_clip(w, h, 2, seed=5)
    pairs = []
    port_search = PS.search_frame

    def both(st, info, quantizer, d_planes, md_planes, lam,
             is_keyframe=False, use_masking=True, device_put_fn=None):
        with jax.enable_x64(True):
            want = JPS.search_frame(
                st, info, quantizer,
                [p.gather() for p in d_planes],
                None if md_planes is None else [p.gather()
                                                for p in md_planes],
                lam, is_keyframe=is_keyframe, use_masking=use_masking)
        finish = port_search(st, info, quantizer, d_planes, md_planes, lam,
                             is_keyframe=is_keyframe,
                             use_masking=use_masking,
                             device_put_fn=device_put_fn)

        def done():
            got = finish()
            pairs.append((is_keyframe, want, got))
            return got
        return done

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PS, "search_frame", both)
        info = H.Info(pic_width=w, pic_height=h)
        enc = Encoder(info, quant=18, complexity=7, device="cpu",
                      use_device_analysis=False, use_device_pvq=True)
        enc.fixed_bsize = 0
        enc.enable_encoder_check = True
        for fr in frames:
            enc.encode_frame(fr)
    return pairs


@needs_native
def test_lean_tables_match_jax(lean_table_pairs):
    """At every search_frame call of the lean encode, JAX's search_frame
    on the same inputs gives the same decision table (skip_diff
    included, NaN equal to NaN) on at least 99% of rows, in every
    frame."""
    pairs = lean_table_pairs
    assert [p[0] for p in pairs] == [True, False]
    for is_keyframe, want, got in pairs:
        equal = total = 0
        assert len(want.groups) == len(got.groups)
        for gw, gg in zip(want.groups, got.groups):
            assert (gw["pli"], gw["bs"]) == (gg["pli"], gg["bs"])
            np.testing.assert_array_equal(gw["by4"], gg["by4"])
            for band, rw in gw["bands"].items():
                rg = gg["bands"][band]
                same = (rw["y"] == rg["y"]).all(1)
                for key in ("noref", "qg", "itheta", "ts", "k", "valid"):
                    same &= rw[key] == rg[key]
                sd_w, sd_g = rw["skip_diff"], rg["skip_diff"]
                same &= (sd_w == sd_g) | (np.isnan(sd_w) & np.isnan(sd_g))
                equal += int(same.sum())
                total += len(same)
        assert total > 100 and equal >= 0.99 * total, (is_keyframe, equal,
                                                       total)


def _same_entry(a, b):
    """Two get() answers are equal: the same Python types, the same
    ints and flag, the same y row and the same skip_diff (NaN equal to
    NaN)."""
    if a is None or b is None:
        return a is b
    return (a[:5] == b[:5] and a[7] == b[7]
            and a[5].dtype == b[5].dtype and np.array_equal(a[5], b[5])
            and (a[6] == b[6] or (np.isnan(a[6]) and np.isnan(b[6])))
            and all(type(x) is type(y) for x, y in zip(a, b)))


@needs_native
def test_table_get_matches_jax(lean_table_pairs):
    """DevicePVQTable.get, the Python coefficient path's view of the
    table, answers exactly as JAX's get on the same groups (the port's
    tables of the lean encode), at every key the Python path can ask:
    every searched band, a band past the last, a block and a plane that
    were not searched; and it counts the valid entries it handed out."""
    for _, _, got in lean_table_pairs:
        keys = [(g["pli"], int(by), int(bx), band)
                for g in got.groups for by, bx in zip(g["by4"], g["bx4"])
                for band in range(len(g["bands"]) + 1)]
        keys += [(0, -1, -1, 0), (9, 0, 0, 0)]
        jax_view = JPS.DevicePVQTable()
        jax_view.groups = got.groups
        devstats.reset()
        mine = [got.get(k) for k in keys]
        valid = sum(1 for e in mine if e is not None and e[7])
        assert devstats.snapshot()["counts"].get("forced_bands", 0) == valid
        assert valid > 100 and mine.count(None) >= 2
        theirs = [jax_view.get(k) for k in keys]
        assert all(_same_entry(a, b) for a, b in zip(mine, theirs))


@needs_native
def test_lean_sweep_tables_match_jax():
    """bench.py's `device+sweep` configuration on the CPU: the port's lean
    tier with the colour sweep (use_device_analysis=False,
    use_device_pvq=True, mv_refine_mode="sweep") encodes a 96x64 clip
    with the encoder check on, and in every frame its decision table
    agrees with that of JAX's lean tier with its sweep (use_device_pvq,
    mv_refine_mode = "sweep") on at least 99% of rows."""
    import chip_smoke
    w, h = 96, 64
    frames = content.make_clip(w, h, 3, seed=5)
    tables = {}
    for name in ("jax", "port"):
        info = H.Info(pic_width=w, pic_height=h)
        if name == "jax":
            enc = HostEncoder(info, quant=18, complexity=7)
            enc.use_device_pvq = True
            enc.mv_refine_mode = "sweep"
        else:
            enc = Encoder(info, quant=18, complexity=7, device="cpu",
                          use_device_analysis=False, use_device_pvq=True,
                          mv_refine_mode="sweep")
            enc.enable_encoder_check = True
        enc.fixed_bsize = 0
        tabs = tables[name] = []

        def capture(*args, real=enc._encode_coefficients, enc=enc,
                    tabs=tabs, **kw):
            tabs.append(chip_smoke.table_rows(enc._device_pvq_tab))
            return real(*args, **kw)
        enc._encode_coefficients = capture
        devstats.reset()
        for fr in frames:
            enc.encode_frame(fr)
        if name == "port":
            assert devstats.snapshot()["spans_s"]["refine_sweep"] > 0
    assert len(tables["jax"]) == len(tables["port"]) == len(frames)
    for a, b in zip(tables["port"], tables["jax"]):
        assert a.keys() == b.keys() and len(a) > 100
        same = sum(a[k] == b[k] for k in a)
        assert same >= 0.99 * len(a), (same, len(a))


@needs_native
@pytest.mark.slow
def test_lean_tier_1080p_matches_jax():
    """bench.py's 1080p translation clip and preset (4 frames; the
    preset of daala_tpu_torch.utils.profile) through three encoders on
    the CPU: daala_tpu's host search, its JAX lean tier
    (use_device_pvq) and the port's lean tier.  At every search_frame
    call of the port's run, JAX's search_frame on the same planes gives
    the same table on every row (the pulse search sums its rows in
    XLA:CPU's order; with torch.sum's order one keyframe row of 53,912
    differed); the port's bytes are within 0.1% of JAX's lean tier's and its PSNR within 0.01 dB.  Prints each
    run's bytes and luma PSNR per frame (several minutes: JAX's search
    of a 1080p frame on the CPU takes about a minute)."""
    from daala_tpu.codec.decoder import Decoder as HostDecoder
    from daala_tpu_torch.utils.profile import ENCODER_KW, translation_clip
    import chip_smoke
    frames = translation_clip()
    info = H.Info(pic_width=1920, pic_height=1080)

    def report(name, pk):
        dec = HostDecoder(info)
        outs = [o for p in pk for o in dec.decode_packet(p)]
        ps = [psnr(f[0].astype(np.float64), np.asarray(o[0], np.float64))
              for f, o in zip(frames, outs)]
        print("%s: bytes %s = %d, luma PSNR %s, mean %.4f dB"
              % (name, [len(p) for p in pk], sum(map(len, pk)),
                 ["%.4f" % v for v in ps], np.mean(ps)))
        return sum(map(len, pk)), float(np.mean(ps))

    runs = {}
    for name in ("host search", "JAX lean tier"):
        enc = HostEncoder(info, **ENCODER_KW)
        enc.keyframe_rate = 256
        enc.use_device_pvq = name == "JAX lean tier"
        runs[name] = report(name, [bytes(p) for fr in frames
                                   for p in enc.encode_frame(fr)])
    real = PS.search_frame
    agree = []

    def both(st, info, quantizer, d_planes, md_planes, lam,
             is_keyframe=False, use_masking=True, device_put_fn=None):
        got = real(st, info, quantizer, d_planes, md_planes, lam,
                   is_keyframe=is_keyframe, use_masking=use_masking,
                   device_put_fn=device_put_fn)()
        with jax.enable_x64(True):
            want = JPS.search_frame(
                st, info, quantizer, [p.gather() for p in d_planes],
                None if md_planes is None else [p.gather()
                                                for p in md_planes],
                lam, is_keyframe=is_keyframe, use_masking=use_masking)
        a, b = chip_smoke.table_rows(got), chip_smoke.table_rows(want)
        assert a.keys() == b.keys()
        diff = [k for k in a if a[k] != b[k]]
        print("frame %d: %d of %d rows differ from JAX's%s"
              % (len(agree), len(diff), len(a),
                 "".join("\n  %s: port %s, JAX %s" % (k, a[k][:6], b[k][:6])
                         for k in diff[:5])))
        agree.append((len(a) - len(diff), len(a)))
        return lambda: got

    PS.search_frame = both
    try:
        enc = Encoder(info, device="cpu", use_device_analysis=False,
                      use_device_pvq=True, **ENCODER_KW)
        enc.keyframe_rate = 256
        runs["port"] = report("port's lean tier (cpu)", [
            bytes(p) for fr in frames for p in enc.encode_frame(fr)])
    finally:
        PS.search_frame = real
    assert len(agree) == len(frames)
    assert all(same == total for same, total in agree), agree
    nb, ps = runs["port"]
    nb_j, ps_j = runs["JAX lean tier"]
    assert abs(nb - nb_j) <= 0.001 * nb_j and abs(ps - ps_j) < 0.01
