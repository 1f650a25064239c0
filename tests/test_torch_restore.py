"""The port's device dering (daala_tpu_torch/models/restore.py) against
the JAX functions of daala_tpu/models/restore.py and the host filter
(ops/dering.py od_dering), on the same planes, skip maps and thresholds.

Every output is an integer plane; the tolerance is zero.  JAX runs on
the CPU, as tests/test_restore.py runs it.
"""

import numpy as np
import pytest
import torch

from daala_tpu.models import restore as JR
from daala_tpu.ops import dering as D
from daala_tpu_torch.models import restore as R
from daala_tpu_torch.utils import devstats
import torch_threads

torch_threads.share_cores()


def _bskip(rng, h4, w4, p=0.3):
    return (rng.random((h4, w4)) < p).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("xdec", [0, 1])
def test_od_dering_matches_jax(seed, xdec):
    """tests/test_restore.py's cases: each superblock of a 2x2-superblock
    plane, luma with its own directions, chroma with random ones."""
    rng = np.random.default_rng(seed)
    n = 64 >> xdec
    h = w = 128 >> xdec
    plane = rng.integers(-2048, 2048, (h, w)).astype(np.int16)
    bskip = _bskip(rng, h >> 2, w >> 2)
    for sby in range(2):
        for sbx in range(2):
            dirs = (None if xdec == 0
                    else rng.integers(0, 8, (8, 8)).astype(np.int32))
            args = (plane, sby, sbx, xdec, xdec, bskip, 40, n)
            got, got_dirs = R.od_dering_device(*args, dirs=dirs,
                                               device="cpu")
            want, want_dirs = JR.od_dering_jax(*args, dirs=dirs)
            host, host_dirs = D.od_dering(*args, dirs=dirs)
            assert got.dtype == np.int16 and got.shape == (n, n)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, host)
            np.testing.assert_array_equal(got_dirs, want_dirs)
            np.testing.assert_array_equal(got_dirs, host_dirs)


def _extreme_plane(rng, h, w):
    """int16 values over the whole range, with runs of the extremes and
    of the VERY_LARGE border value: differences against neighbours and
    borders wrap at int16, and the direction costs wrap at int32."""
    plane = rng.integers(-32768, 32768, (h, w)).astype(np.int16)
    plane[::7] = 32767
    plane[3::11] = -32768
    plane[:, 5::13] = D.OD_DERING_VERY_LARGE
    plane[20:28, 20:28] = np.where(np.add.outer(np.arange(8), np.arange(8))
                                   % 2, 32767, -32768)
    return plane


@pytest.mark.parametrize("xdec", [0, 1])
def test_od_dering_at_int16_extremes(xdec):
    """Values that reach the borders' 30000 and the int16 extremes, with a
    threshold large enough that wrapped differences pass it."""
    rng = np.random.default_rng(7)
    n = 64 >> xdec
    h, w = 2 * n, 3 * n
    plane = _extreme_plane(rng, h, w)
    bskip = _bskip(rng, h >> 2, w >> 2, 0.1)
    for sby in range(2):
        for sbx in range(3):
            dirs = (None if xdec == 0
                    else rng.integers(0, 8, (8, 8)).astype(np.int32))
            args = (plane, sby, sbx, xdec, xdec, bskip, 20000, n)
            got, got_dirs = R.od_dering_device(*args, dirs=dirs,
                                               device="cpu")
            want, want_dirs = JR.od_dering_jax(*args, dirs=dirs)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, D.od_dering(*args,
                                                           dirs=dirs)[0])
            np.testing.assert_array_equal(got_dirs, want_dirs)


def _tied_blocks():
    """8x8 blocks whose direction costs tie (flat, zero, symmetric
    patterns, a lone pixel), each tiled into one 64x64 superblock with
    random blocks and extreme ones."""
    rng = np.random.default_rng(3)
    i, j = np.mgrid[0:8, 0:8]
    blocks = [np.zeros((8, 8)), np.full((8, 8), 1000),
              np.full((8, 8), -32768), np.where((i + j) % 2, 500, -500),
              np.where(i == j, 2000, 0), np.where(i + j == 7, 2000, 0),
              np.where((i == 3) & (j == 4), 30000, 0),
              np.where(i < 4, 800, -800), np.where(j < 4, 800, -800),
              np.where((i < 4) == (j < 4), 800, -800)]
    out = np.empty((64, 64), np.int16)
    for k in range(64):
        if k < len(blocks):
            b = blocks[k]
        elif k < 48:
            b = rng.integers(-4096, 4096, (8, 8))
        else:
            b = rng.choice([-32768, 32767], (8, 8))
        out[8 * (k // 8):8 * (k // 8) + 8, 8 * (k % 8):8 * (k % 8) + 8] = b
    return out


def test_compute_dirs_var_matches_jax_on_ties():
    """Blocks with equal costs take the first maximum (or direction 0
    where no cost is positive), as JAX's argmax and the reference's scan
    do; extreme blocks wrap the int32 costs.  Batched over leading
    dimensions as vmap batches JAX's."""
    x = _tied_blocks()
    dirs, var = R.compute_dirs_var(torch.from_numpy(x))
    jd, jv = JR.compute_dirs_var(x)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(var.numpy(), np.asarray(jv))
    for by in range(8):
        for bx in range(8):
            assert D.dir_find8(x[8 * by:8 * by + 8, 8 * bx:8 * bx + 8], 4) \
                == (dirs[by, bx], var[by, bx])
    batch = torch.from_numpy(np.stack([x, x[::-1].copy(), -x]))
    bd, bv = R.compute_dirs_var(batch[:, None])
    for k in range(3):
        d1, v1 = R.compute_dirs_var(batch[k])
        assert torch.equal(bd[k, 0], d1) and torch.equal(bv[k, 0], v1)


@pytest.mark.parametrize("nvdr,nhdr", [(2, 3), (3, 2)])
@pytest.mark.parametrize("quantizer", [25, 400])
def test_dering_candidates_match_jax(nvdr, nhdr, quantizer):
    """All superblocks x the 5 gains, with all-skip superblocks (one
    inside, one at a corner), partly skipped edge superblocks and a few
    border-reaching values."""
    rng = np.random.default_rng(nvdr * 10 + quantizer)
    h, w = nvdr * 64, nhdr * 64
    luma = rng.integers(-3000, 3000, (h, w)).astype(np.int16)
    luma[5:9, 5:40] = 30000
    luma[h - 30:h - 10, w - 4:] = -32000
    bskip = _bskip(rng, h >> 2, w >> 2, 0.5)
    # Skip windows reach one 4x4 cell into the neighbouring superblocks.
    bskip[:17, :17] = 1
    bskip[15:33, 15:33] = 1
    cands, dirs = R.dering_candidates_device(luma, bskip, quantizer, nvdr,
                                             nhdr, device="cpu")
    jc, jd = JR.dering_candidates_device(luma, bskip, quantizer, nvdr, nhdr)
    assert cands.dtype == np.int16 and cands.shape == (nvdr * nhdr, 5, 64,
                                                       64)
    assert dirs.dtype == np.int32 and dirs.shape == (nvdr * nhdr, 8, 8)
    np.testing.assert_array_equal(cands, np.asarray(jc))
    np.testing.assert_array_equal(dirs, np.asarray(jd))
    # The all-skip superblocks are unfiltered at every gain.
    for g in range(5):
        np.testing.assert_array_equal(cands[0, g], luma[:64, :64])
        np.testing.assert_array_equal(cands[nhdr + 1, g],
                                      luma[64:128, 64:128])


def _frame_case(seed, xdecs):
    rng = np.random.default_rng(seed)
    nvdr, nhdr = 2, 3
    planes, bskips = [], []
    for xdec in xdecs:
        n = 64 >> xdec
        p = rng.integers(-4000, 4000, (nvdr * n, nhdr * n)).astype(np.int16)
        p[::9, ::5] = 32000
        planes.append(p)
        bskips.append(_bskip(rng, (nvdr * n) >> 2, (nhdr * n) >> 2, 0.4))
    bskips[0][:16, 16:32] = 1
    levels = rng.integers(0, 6, (nvdr, nhdr))
    levels[1, 0] = 0
    return planes, bskips, nvdr, nhdr, levels


@pytest.mark.parametrize("xdecs", [(0, 1, 1), (0, 0, 0)],
                         ids=["420", "444"])
def test_batched_frame_dering_matches_per_superblock_loop(xdecs):
    """dering_frame_device (the native decode path's batched call) equals
    od_dering_device and the host filter run superblock by superblock,
    plane by plane, with chroma taking that superblock's luma
    directions."""
    planes, bskips, nvdr, nhdr, levels = _frame_case(len(xdecs) + xdecs[1],
                                                     xdecs)
    sbs = np.flatnonzero(levels)
    thr = [[int(D.OD_DERING_GAIN_TABLE[int(levels.flat[i])] * 37.5
                * (1 if pli == 0 else 0.6)) for i in sbs]
           for pli in range(3)]
    got = R.dering_frame_device(planes, bskips, list(xdecs), nvdr, nhdr, sbs,
                                thr, device="cpu")
    for k, i in enumerate(sbs):
        sby, sbx = divmod(int(i), nhdr)
        dirs = None
        for pli, xdec in enumerate(xdecs):
            n = 64 >> xdec
            args = (planes[pli], sby, sbx, xdec, pli, bskips[pli],
                    thr[pli][k], n)
            want, wdirs = R.od_dering_device(*args, dirs=dirs, device="cpu")
            host, _ = D.od_dering(*args, dirs=dirs)
            assert got[pli].shape == (len(sbs), n, n)
            np.testing.assert_array_equal(got[pli][k], want)
            np.testing.assert_array_equal(got[pli][k], host)
            dirs = wdirs


@pytest.mark.parametrize("xdec", [0, 1])
def test_skip_blocks_match_the_window_loop(xdec):
    """The vectorized skip-window mask equals od_dering's loop (and, for
    luma, JAX's _skip_blocks_luma), edge superblocks included."""
    rng = np.random.default_rng(11 + xdec)
    nvdr, nhdr = 3, 4
    c = 16 >> xdec
    bskip = _bskip(rng, nvdr * c, nhdr * c, 0.7)
    got = R._skip_blocks(bskip, nvdr, nhdr, xdec)
    want = np.zeros_like(got)
    for sby in range(nvdr):
        for sbx in range(nhdr):
            for by in range(8):
                for bx in range(8):
                    skip = 1
                    for i in range(-int(sby != 0),
                                   (2 >> xdec) + int(sby != nvdr - 1)):
                        for j in range(-int(sbx != 0),
                                       (2 >> xdec) + int(sbx != nhdr - 1)):
                            skip = skip and bskip[
                                (sby << (4 - xdec)) + (by << 1 >> xdec) + i,
                                (sbx << (4 - xdec)) + (bx << 1 >> xdec) + j]
                    want[sby * 8 + by, sbx * 8 + bx] = skip
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    if xdec == 0:
        np.testing.assert_array_equal(got, JR._skip_blocks_luma(bskip, nvdr,
                                                                nhdr))


def test_tables_match_jax():
    np.testing.assert_array_equal(R._PROJ, JR._PROJ)
    np.testing.assert_array_equal(R._COST_W, JR._COST_W)
    np.testing.assert_array_equal(R._DIR_DY, JR._DIR_DY)
    np.testing.assert_array_equal(R._DIR_DX, JR._DIR_DX)


def test_dering_counts_its_work():
    """Each batched entry point runs in a devstats span of its name and
    counts its dispatches; a CPU run moves no host<->device bytes."""
    planes, bskips, nvdr, nhdr, levels = _frame_case(5, (0, 1, 1))
    devstats.reset()
    R.dering_candidates_device(planes[0], bskips[0], 30, nvdr, nhdr,
                               device="cpu")
    R.dering_frame_device(planes, bskips, [0, 1, 1], nvdr, nhdr,
                          np.flatnonzero(levels), [[40] * int((levels != 0)
                                                              .sum())] * 3,
                          device="cpu")
    snap = devstats.snapshot()
    assert set(snap["spans_s"]) == {"dering_candidates", "dering_frame"}
    assert snap["dispatches"] == 1 + 3
    assert snap["h2d_bytes"] == snap["d2h_bytes"] == 0
    assert snap["launches"] == {}


def test_cuda_device_without_card_raises():
    plane = np.zeros((64, 64), np.int16)
    bskip = np.zeros((16, 16), np.uint8)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        R.dering_candidates_device(plane, bskip, 30, 1, 1, device="cuda")
    with pytest.raises(RuntimeError):
        R.od_dering_device(plane, 0, 0, 0, 0, bskip, 40, 64, device="cuda")
    with pytest.raises(ValueError):
        R.od_dering_device(plane, 0, 0, 0, 0, bskip, 40, 64, device=None)
