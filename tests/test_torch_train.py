"""The port's training subsystem (daala_tpu_torch.train) against the JAX
package's (daala_tpu.train) on the CPU, on the same seeded numpy inputs.

Tolerances: `measure_mags` and `gen_zigzag` are exact (integer
coefficients; the means are exact float64 sums divided by a count).
The k-means step runs in float32 in both (JAX with x64 off): one step's
indices equal, its codebook and rms within 1e-6 (the scatter-add and
the mean sum in another order); 12 iterations of `train` within 1e-5;
the numpy backend is the same code, so exact.  `coding_gain_1d` on
torch float64 within 1e-12 dB of numpy float64 (the same operations,
LAPACK's inverse either way).  `search` ascends in float32 in both with
the same Adam update: the polished integer parameters equal, `float_cg`
within 1e-4 dB.  The copied table generators equal the shipped tables
as the originals do.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from daala_tpu.ops import _tables as T
from daala_tpu.train import gain as jgain
from daala_tpu.train import vq as jvq
from daala_tpu.train import zigzag as jzz
from daala_tpu_torch.train import gain as tgain
from daala_tpu_torch.train import vq as tvq
from daala_tpu_torch.train import zigzag as tzz
import torch_threads

torch_threads.share_cores()


def _frame():
    """tests/test_train.py's 192x192 frame."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:192, 0:192]
    return (128 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 11.0)
            + rng.normal(0, 8, xx.shape)).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_measure_mags_matches_jax(n):
    frames = [_frame(), _frame()[::-1].copy()]
    want = jzz.measure_mags(frames, n)
    got = tzz.measure_mags(frames, n, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tzz.gen_zigzag(got), jzz.gen_zigzag(want))


def test_measure_mags_crops_and_refuses_small_frames():
    f = _frame()
    np.testing.assert_array_equal(
        tzz.measure_mags([f[:150, :170]], 8, device="cpu"),
        tzz.measure_mags([f[:128, :128]], 8, device="cpu"))
    with pytest.raises(ValueError, match="64x64"):
        tzz.measure_mags([f[:63]], 8, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA"):
        tzz.measure_mags([_frame()], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvq.train(np.eye(4), 2, nb_iter=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgain.search(steps=1)


def _clustered():
    """tests/test_train.py's clustered data."""
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(8, 16))
    return np.repeat(centers, 40, axis=0) + 0.1 * rng.normal(size=(320, 16))


@pytest.mark.parametrize("exclude_pvq", [False, True])
def test_vq_step_matches_jax(exclude_pvq):
    rng = np.random.default_rng(4)
    data = tvq._normalize(_clustered()).astype(np.float32)
    cb = tvq._normalize(rng.normal(size=(16, 16))).astype(np.float32)
    want_cb, want_rms = jvq._make_step_jax(exclude_pvq)(data, cb)
    want_best = np.argmax(np.abs(data @ cb.T), axis=1)
    got_cb, got_rms, best = tvq._make_step_torch(exclude_pvq, "cpu")(
        torch.from_numpy(data), torch.from_numpy(cb))
    assert got_cb.dtype == torch.float32
    np.testing.assert_array_equal(best.numpy(), want_best)
    np.testing.assert_allclose(got_cb.numpy(), np.asarray(want_cb),
                               rtol=0, atol=1e-6)
    assert abs(float(got_rms) - float(want_rms)) <= 1e-6


@pytest.mark.parametrize("exclude_pvq", [False, True])
def test_vq_train_matches_jax(exclude_pvq):
    data = _clustered()
    kw = dict(nb_iter=12, exclude_pvq=exclude_pvq, seed=3)
    cb, hist = tvq.train(data, 16, backend="auto", device="cpu", **kw)
    jcb, jhist = jvq.train(data, 16, backend="jax", **kw)
    np.testing.assert_allclose(hist, jhist, rtol=0, atol=1e-5)
    np.testing.assert_allclose(cb, jcb, rtol=0, atol=1e-5)
    assert hist[-1] < hist[0]
    ncb, nhist = tvq.train(data, 16, backend="numpy", **kw)
    jncb, jnhist = jvq.train(data, 16, backend="numpy", **kw)
    assert nhist == jnhist
    np.testing.assert_array_equal(ncb, jncb)
    with pytest.raises(ValueError, match="backend"):
        tvq.train(data, 16, backend="jax", device="cpu", **kw)


@pytest.mark.parametrize("params,filt,n", [
    (jgain.PARAMS4, 4, 4), ((64, 64, 0, 0), 4, 4), (jgain.PARAMS8, 8, 8),
    (jgain.PARAMS4, 4, 16)])
def test_coding_gain_torch_float64_matches_numpy(params, filt, n):
    want = jgain.coding_gain_1d(params, n, filt)
    assert tgain.coding_gain_1d(params, n, filt) == want
    got = tgain.coding_gain_1d(params, n, filt, xp=torch)
    assert got.dtype == torch.float64
    assert abs(float(got) - want) <= 1e-12
    np.testing.assert_allclose(
        tgain._filter_matrix(params, filt, torch).numpy(),
        jgain._filter_matrix(params, filt), rtol=0, atol=1e-15)


def test_coding_gain_values():
    # tests/test_train.py's figures on AR(0.95), through torch float64.
    cg_unlapped = float(tgain.coding_gain_1d((64, 64, 0, 0), xp=torch))
    cg_shipped = float(tgain.coding_gain_1d(tgain.PARAMS4, xp=torch))
    assert cg_unlapped == pytest.approx(7.57, abs=0.02)
    assert cg_shipped == pytest.approx(8.55, abs=0.02)


def test_coding_gain_gradient_flows_through_the_q6_scaling():
    theta = torch.tensor(tgain.PARAMS4, dtype=torch.float64,
                         requires_grad=True)
    tgain.coding_gain_1d(theta, xp=torch).backward()
    eps = 1e-6
    num = []
    for i in range(4):
        up = np.array(tgain.PARAMS4, np.float64)
        dn = up.copy()
        up[i] += eps
        dn[i] -= eps
        num.append((tgain.coding_gain_1d(up) - tgain.coding_gain_1d(dn))
                   / (2 * eps))
    np.testing.assert_allclose(theta.grad.numpy(), num, rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("n,filt", [(4, 4), (8, 8)])
def test_search_matches_jax(n, filt):
    best, cg, fcg = tgain.search(n, filt, steps=50, device="cpu")
    jbest, jcg, jfcg = jgain.search(n, filt, steps=50)
    assert best == jbest
    assert cg == jcg
    assert abs(fcg - jfcg) <= 1e-4


def _tables(which):
    """Each table generator of the port with its shipped table: the
    assertion of tests/test_train.py for the original."""
    from daala_tpu_torch.train import basis, cos_search, laplace
    if which == "laplace":
        cdfs, offs = laplace.gen_laplace_tables(128, 7)
        return (np.array_equal(cdfs, T.EXP_CDF_TABLE)
                and np.array_equal(offs, T.LAPLACE_OFFSET))
    if which == "cdf":
        cdfs, decay = laplace.gen_cdf(32, 7)
        return ((cdfs[:, -1] == 32768).all()
                and (np.diff(cdfs, axis=1) >= 1).all()
                and (decay[1:] >= decay[:-1] - 1).all())
    if which == "basis":
        return (all(np.allclose(basis.basis_magnitudes(n), tab, atol=1e-6)
                    for n, tab in [(4, T.BASIS_MAG4), (8, T.BASIS_MAG8),
                                   (16, T.BASIS_MAG16),
                                   (32, T.BASIS_MAG32)])
                and np.allclose(basis.basis_magnitudes(64), T.BASIS_MAG64,
                                atol=4e-3)
                and np.allclose(basis.basis_magnitudes(8, dec=1),
                                T.BASIS_MAG8_CHROMA_420, atol=1e-6))
    if which == "cos_search":
        best, sse = cos_search.search(center=cos_search.SHIPPED, radius=1)
        err = (cos_search.cos2_batch(np.array(cos_search.SHIPPED),
                                     np.arange(32768)) - cos_search.truth())
        return (best == cos_search.SHIPPED
                and sse == cos_search.sq_error(cos_search.SHIPPED)
                and np.abs(err).max() < 1.5)
    if which == "zigzag_bands":
        for n, tab in [(4, T.ZIGZAG4), (8, T.ZIGZAG8), (16, T.ZIGZAG16),
                       (32, T.ZIGZAG32), (64, T.ZIGZAG64)]:
            pos = 0
            for mask in tzz.band_masks(n):
                k = int(mask.sum())
                seg = np.asarray(tab)[pos:pos + k]
                if not all(mask[y, x] for x, y in seg):
                    return False
                pos += k
            if pos != len(tab):
                return False
        return True
    raise ValueError(which)


@pytest.mark.parametrize("which", ["laplace", "cdf", "basis", "cos_search",
                                   "zigzag_bands"])
def test_copied_generators_give_the_shipped_tables(which):
    assert _tables(which)


def test_cli_runs_on_the_cpu():
    def run(*args, stdin=None):
        r = subprocess.run([sys.executable, "-m", "daala_tpu_torch.train"]
                           + list(args), capture_output=True, text=True,
                           input=stdin, timeout=120)
        assert r.returncode == 0, r.stderr
        return r.stdout
    assert "8.5523" in run("gain")
    rows = np.random.default_rng(5).normal(size=(40, 4))
    out = run("vq", "4", "100", "2", "--iters", "3", "--device", "cpu",
              stdin="".join(" ".join(map(str, r)) + "\n" for r in rows))
    lines = out.splitlines()
    assert lines[0].startswith("/* Trained by daala_tpu_torch.train.vq")
    assert len(lines) == 5
