"""Tests of the port that need a CUDA card: the kernels against their
plain versions at the encoder's 1080p shapes, launch-error reporting,
the device OBMC predictor against the host's, the encoder on the card
against the host encoder and (in sweep mode) against itself on the
CPU, the lean tier's PVQ band search and SAD fields on the card
against the CPU (and their kernels, csrc/pulse_search.cu,
csrc/band_search.cu and csrc/sad_fields.cu, against their plain
versions on the card at 1080p), the lean tier's Python coefficient path on the card against
its native pass, the decoder's device back end (dering and
synthesis) on the card against the CPU and the host decoder, the parallel
encodes (parallel/mesh.py) on the card against the CPU and serial
encodes, the mesh's sp axis (parallel/sharding.py: the lap kernel from
a tile's origin, the sharded device tier, batch and clips on a 2 x 2
mesh of the card) against the plain versions and the CPU, and the
training subsystem (train/: the zigzag statistics,
the coding-gain search, the k-means codebook) on the card against the
CPU.

Every test here is marked `cuda` and skips without a card.  This file
imports no jax, so it also runs on a card's host that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from chip_smoke import (SMALL, PaddedImage, edge_leaves, random_grid,
                        random_leaves, random_refs, sweep_leaves,
                        textured_clip)
from daala_tpu import native
from daala_tpu.codec import headers
from daala_tpu.codec import mc as MC
from daala_tpu.codec.encoder import Encoder as HostEncoder
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.entropy.adapt import AdaptCtx
from daala_tpu_torch.models import obmc as OB
from daala_tpu_torch.models import pvqsearch as PS
from daala_tpu_torch.ops.cuda import (_build, dct_kernels, lap_kernels,
                                      obmc_kernels as OK)
from daala_tpu_torch.utils import devstats
import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _plane(card, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-(1 << 14), 1 << 14, (h, w), generator=g,
                         dtype=torch.int32).to(card)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_dct_kernel_matches_plain(card, n):
    shapes = [(1088, 1920)] + ([(544, 960)] if n <= 32 else [])
    for (h, w) in shapes:
        x = _plane(card, h, w, n)
        for fwd in (True, False):
            assert torch.equal(dct_kernels.dct_frame_cuda(x, n, fwd),
                               dct_kernels.dct_frame_plain(x, n, fwd))
        y = dct_kernels.dct_frame_cuda(x, n, True)
        assert torch.equal(dct_kernels.dct_frame_cuda(y, n, False), x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("h,w,sb", [(1088, 1920, 64), (544, 960, 32),
                                    (128, 192, 64), (100, 150, 32)])
def test_lap_kernel_matches_plain(card, h, w, sb):
    x = _plane(card, h, w, sb)
    for fwd in (True, False):
        assert torch.equal(lap_kernels.lap_frame_cuda(x, sb, sb, fwd),
                           lap_kernels.lap_frame_plain(x, sb, sb, fwd))
    y = lap_kernels.lap_frame_cuda(x, sb, sb, True)
    assert torch.equal(lap_kernels.lap_frame_cuda(y, sb, sb, False), x)
    torch.cuda.synchronize()


def _extreme_plane(card, h, w, seed):
    """int32 values over the whole range, with rows of the extremes, so
    that the lifting's wraparound paths run."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, (h, w), dtype=np.int64)
    x[0], x[1] = -2**31, 2**31 - 1
    x[2, ::2], x[2, 1::2] = -2**31, 2**31 - 1
    return torch.from_numpy(x.astype(np.int32)).to(card)


def _offset_view(x, offset):
    """A contiguous copy of x that starts `offset` int32 words into its
    storage."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    v = flat[offset:].view(x.shape)
    v.copy_(x)
    assert v.is_contiguous() and v.storage_offset() == offset
    return v


@pytest.mark.parametrize("h,w,n", [(128, 192, n) for n in (4, 8, 16, 32, 64)]
                         + [(64, 96, n) for n in (4, 8, 16, 32)])
def test_dct_kernel_on_small_planes(card, h, w, n):
    """The planes of a 192x128 encode (luma and chroma), where the grid
    is far from full and the strips are 64 or 32 columns wide."""
    x = _plane(card, h, w, n + h)
    for fwd in (True, False):
        assert torch.equal(dct_kernels.dct_frame_cuda(x, n, fwd),
                           dct_kernels.dct_frame_plain(x, n, fwd))
    y = dct_kernels.dct_frame_cuda(x, n, True)
    assert torch.equal(dct_kernels.dct_frame_cuda(y, n, False), x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_dct_kernel_at_int32_extremes(card, n):
    """Wraparound: equal to the plain version, and still reversible (the
    networks are lifting steps, invertible modulo 2^32)."""
    x = _extreme_plane(card, 128, 192, n)
    for fwd in (True, False):
        assert torch.equal(dct_kernels.dct_frame_cuda(x, n, fwd),
                           dct_kernels.dct_frame_plain(x, n, fwd))
    y = dct_kernels.dct_frame_cuda(x, n, True)
    assert torch.equal(dct_kernels.dct_frame_cuda(y, n, False), x)
    torch.cuda.synchronize()


def test_dct_kernel_takes_aligned_views_and_refuses_misaligned(card):
    x = _plane(card, 128, 192, 5)
    v = _offset_view(x, 4)  # 16 bytes in: aligned
    for n in (8, 64):
        assert torch.equal(dct_kernels.dct_frame_cuda(v, n, True),
                           dct_kernels.dct_frame_plain(x, n, True))
    for offset in (1, 2, 3):
        with pytest.raises(ValueError, match="16-byte"):
            dct_kernels.dct_frame_cuda(_offset_view(x, offset), 8, True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("h,w,sb_x,sb_y", [(1088, 960, 32, 64),
                                           (128, 192, 32, 64),
                                           (100, 150, 64, 32),
                                           (76, 132, 8, 16)])
def test_lap_kernel_per_axis_superblocks(card, h, w, sb_x, sb_y):
    """sb_x != sb_y (4:2:2 chroma, and small superblocks with several
    bands a tile)."""
    x = _plane(card, h, w, sb_x + sb_y)
    for fwd in (True, False):
        assert torch.equal(lap_kernels.lap_frame_cuda(x, sb_x, sb_y, fwd),
                           lap_kernels.lap_frame_plain(x, sb_x, sb_y, fwd))
    y = lap_kernels.lap_frame_cuda(x, sb_x, sb_y, True)
    assert torch.equal(lap_kernels.lap_frame_cuda(y, sb_x, sb_y, False), x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("h,w", [(66, 102), (130, 254)])
def test_lap_kernel_rows_not_16_byte_aligned(card, h, w):
    """Rows of 102 and 254 words: the 4-byte copies."""
    x = _plane(card, h, w, w)
    for fwd in (True, False):
        assert torch.equal(lap_kernels.lap_frame_cuda(x, 32, 32, fwd),
                           lap_kernels.lap_frame_plain(x, 32, 32, fwd))
    y = lap_kernels.lap_frame_cuda(x, 32, 32, True)
    assert torch.equal(lap_kernels.lap_frame_cuda(y, 32, 32, False), x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_lap_kernel_on_views_with_a_storage_offset(card, offset):
    """A view 16 bytes in takes the 16-byte copies, one 4 or 8 bytes in
    the 4-byte copies; both equal the plain version."""
    x = _plane(card, 128, 192, offset)
    v = _offset_view(x, offset)
    for fwd in (True, False):
        assert torch.equal(lap_kernels.lap_frame_cuda(v, 64, 64, fwd),
                           lap_kernels.lap_frame_plain(x, 64, 64, fwd))
    y = lap_kernels.lap_frame_cuda(v, 64, 64, True)
    assert torch.equal(lap_kernels.lap_frame_cuda(_offset_view(y, offset),
                                                  64, 64, False), x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("h,w,sb", [(1088, 1920, 64), (100, 150, 32)])
def test_lap_kernel_at_int32_extremes(card, h, w, sb):
    """Wraparound: equal to the plain version (post(pre(x)) == x holds
    only within the codec's range, which the other cases check)."""
    x = _extreme_plane(card, h, w, sb)
    for fwd in (True, False):
        assert torch.equal(lap_kernels.lap_frame_cuda(x, sb, sb, fwd),
                           lap_kernels.lap_frame_plain(x, sb, sb, fwd))
    torch.cuda.synchronize()


def test_launch_error_is_reported(card):
    """The C entry returns the CUDA error of a refused launch (an empty
    grid) or of an unsupported size, and the wrapper's check raises."""
    lib = dct_kernels.build()
    x = _plane(card, 64, 64, 1)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(card).cuda_stream
    for (h, n) in ((0, 8), (64, 12)):
        err = lib.dct_frame(x.data_ptr(), out.data_ptr(), h, 64, n, 1,
                            stream)
        assert err != 0, (h, n)
        with pytest.raises(RuntimeError):
            _build.check(err, dct_kernels.NAME)
    torch.cuda.synchronize()


def test_encoder_on_card_matches_host(card):
    """Complexity 7 (trial pyramid and final pass) on the card."""
    rng = np.random.default_rng(7)
    w, h = 192, 128
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(3):
        y = (128 + 60 * np.sin((xx + 3 * t) / 9.0)
             + rng.normal(0, 5, (h, w))).clip(0, 255).astype(np.uint8)
        c = (128 + 20 * np.sin((xx[::2, ::2] + t) / 13.0)) \
            .clip(0, 255).astype(np.uint8)
        frames.append([y, c, c.copy()])
    if native.get_lib() is None:
        pytest.fail("the native engine did not build")
    pk = {}
    devstats.reset()
    for name in ("host", "port"):
        info = headers.Info(pic_width=w, pic_height=h)
        if name == "host":
            enc = HostEncoder(info, quant=15, complexity=7)
        else:
            enc = Encoder(info, device=card, quant=15, complexity=7)
        enc.keyframe_rate = 8
        enc.enable_encoder_check = True
        pk[name] = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
    assert pk["port"] == pk["host"]
    launches = devstats.snapshot()["launches"]
    assert launches.get("dct_frame", 0) > 0
    assert launches.get("lap_frame", 0) > 0


LUMA = (1088 + 128, 1920 + 128)  # the padded 1080p luma plane


def _obmc_case(card, log_x, log_y, hi, seed, count=2000):
    rng = np.random.default_rng(seed)
    p4 = rng.integers(0, 4096 if hi else 256, (4,) + LUMA)
    p4 = torch.from_numpy(p4.astype(np.uint16 if hi else np.uint8)).to(card)
    leaves = random_leaves(rng, log_x, log_y, LUMA, 64, count)
    scal = OK.leaf_args(*leaves, 64, log_x, log_y, LUMA)
    return p4, torch.from_numpy(scal).to(card), rng


def _blend_equal(p4, scal, log_x, log_y):
    got = OK.obmc_blend_cuda(p4, scal, log_x, log_y)
    assert got.dtype == p4.dtype
    want = OK.obmc_blend_plain(p4, scal, log_x, log_y)
    torch.cuda.synchronize()
    return torch.equal(OK.bits(got), OK.bits(want))


PAIRS = [(x, y) for x in range(2, 7) for y in range(2, 7)]


@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("log_x,log_y", PAIRS)
def test_obmc_blend_kernel_matches_plain(card, log_x, log_y, hi):
    """Every size the entry point takes, square or not (16x8 once left
    the 8-bit range), on random leaves and on leaves whose windows touch
    the plane's four edges."""
    p4, scal, rng = _obmc_case(card, log_x, log_y, hi,
                               log_x + 8 * log_y + 64 * hi, count=700)
    assert _blend_equal(p4, scal, log_x, log_y)
    edges = OK.leaf_args(*edge_leaves(rng, log_x, log_y, LUMA, 64), 64,
                         log_x, log_y, LUMA)
    assert _blend_equal(p4, torch.from_numpy(edges).to(card), log_x, log_y)


@pytest.mark.parametrize("count", [1, 37, 333])
@pytest.mark.parametrize("log_n", [2, 3, 4, 5, 6])
def test_obmc_kernels_take_any_leaf_count(card, log_n, count):
    """L = 1 and counts that leave the last block of leaves ragged."""
    p4, scal, rng = _obmc_case(card, log_n, log_n, False, 3 * log_n + count,
                               count=count)
    assert scal.shape[0] == count
    assert _blend_equal(p4, scal, log_n, log_n)
    if log_n >= 3:
        cur = torch.from_numpy(rng.integers(0, 256, (1080, 1920))
                               .astype(np.uint8)).to(card)
        assert torch.equal(OK.obmc_leaf_cells_cuda(p4, cur, scal, log_n),
                           OK.obmc_leaf_cells_plain(p4, cur, scal, log_n))


@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("plane", [0, 1])
def test_obmc_kernels_on_a_small_frame(card, plane, hi):
    """A 177x115 frame: padded planes 320 and 160 samples wide, rows
    16-byte but not 64-byte aligned; every square size, tiling leaves
    and edge leaves; the cells against the visible 177x115 luma."""
    shape, pad = SMALL[plane], (64, 32)[plane]
    rng = np.random.default_rng(11 + 2 * plane + hi)
    p4 = torch.from_numpy(rng.integers(0, 4096 if hi else 256, (4,) + shape)
                          .astype(np.uint16 if hi else np.uint8)).to(card)
    cur = torch.from_numpy(rng.integers(0, 256, (115, 177))
                           .astype(np.uint8)).to(card)
    for log_n in range(2, 7 - plane):
        for leaves in (random_leaves(rng, log_n, log_n, shape, pad),
                       edge_leaves(rng, log_n, log_n, shape, pad)):
            scal = torch.from_numpy(OK.leaf_args(*leaves, pad, log_n, log_n,
                                                 shape)).to(card)
            assert _blend_equal(p4, scal, log_n, log_n), log_n
            if plane == 0 and not hi and log_n >= 3:
                assert torch.equal(
                    OK.obmc_leaf_cells_cuda(p4, cur, scal, log_n),
                    OK.obmc_leaf_cells_plain(p4, cur, scal, log_n)), log_n


def test_obmc_kernels_on_a_sweep_shaped_batch(card):
    """4,080 rows: the 510 n = 64 leaves of the 1080p plane, each 8 times
    with one corner's MV moved by up to +-16 1/8-pel."""
    rng = np.random.default_rng(5)
    p4 = torch.from_numpy(rng.integers(0, 256, (4,) + LUMA)
                          .astype(np.uint8)).to(card)
    cur = torch.from_numpy(rng.integers(0, 256, (1080, 1920))
                           .astype(np.uint8)).to(card)
    scal = OK.leaf_args(*sweep_leaves(rng, LUMA, 64), 64, 6, 6, LUMA)
    assert scal.shape[0] == 4080
    scal = torch.from_numpy(scal).to(card)
    assert torch.equal(OK.obmc_leaf_cells_cuda(p4, cur, scal, 6),
                       OK.obmc_leaf_cells_plain(p4, cur, scal, 6))
    assert _blend_equal(p4, scal, 6, 6)


@pytest.mark.parametrize("width,offset", [(100, 0), (120, 0), (128, 1),
                                          (128, 8)])
def test_obmc_wrappers_refuse_misaligned_planes(card, width, offset):
    shape = (4, 64, width)
    flat = torch.zeros(4 * 64 * width + offset, dtype=torch.uint8,
                       device=card)
    p4 = flat[offset:].view(shape)
    rng = np.random.default_rng(width)
    scal = torch.from_numpy(OK.leaf_args(*random_leaves(
        rng, 3, 3, shape[1:], 16, 4), 16, 3, 3, shape[1:])).to(card)
    cur = torch.zeros((32, 96), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        OK.obmc_blend_cuda(p4, scal, 3, 3)
    with pytest.raises(ValueError, match="16-byte"):
        OK.obmc_leaf_cells_cuda(p4, cur, scal, 3)


@pytest.mark.parametrize("log_n", [3, 4, 5, 6])
def test_obmc_leaf_cells_kernel_matches_plain(card, log_n):
    """A ragged visible area: rows past 1080, columns past 1900."""
    p4, scal, rng = _obmc_case(card, log_n, log_n, False, log_n)
    cur = torch.from_numpy(rng.integers(0, 256, (1080, 1900))
                           .astype(np.uint8)).to(card)
    got = OK.obmc_leaf_cells_cuda(p4, cur, scal, log_n)
    assert torch.equal(got, OK.obmc_leaf_cells_plain(p4, cur, scal, log_n))
    torch.cuda.synchronize()


def test_obmc_launch_error_is_reported(card):
    lib = OK.build()
    p4, scal, _ = _obmc_case(card, 3, 3, False, 1, count=4)
    out = torch.empty((4, 8, 8), dtype=torch.uint8, device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    for (n, log_n) in ((0, 3), (4, 7)):
        err = lib.obmc_blend(p4.data_ptr(), 0, LUMA[0], LUMA[1],
                             scal.data_ptr(), n, log_n, log_n,
                             out.data_ptr(), stream)
        assert err != 0, (n, log_n)
        with pytest.raises(RuntimeError):
            _build.check(err, OK.BLEND)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hi", [False, True])
def test_frame_plane_on_card_matches_host(card, hi):
    """8-bit P-frame references; 12-bit full-precision B-frame ones."""
    info = headers.Info(pic_width=192, pic_height=128,
                        bitdepth_mode=2 if hi else 1,
                        full_precision_references=int(hi))
    rng = np.random.default_rng(3 + hi)
    dt = np.uint16 if hi else np.uint8
    refs = random_refs(info, rng, hi)
    ref_imgi = [0, 0, 1, 0] if hi else [0, 1, 1, 0]
    g = random_grid(info, rng, bframe=hi)
    dst = PaddedImage(info, lambda s: np.zeros(s, dt))
    MC.mc_predict_frame(g, refs, ref_imgi, info, dst)
    devstats.reset()
    for pli in range(3):
        got = OB.predict_frame_plane_device(g, refs, ref_imgi, info, pli,
                                            card)
        assert np.array_equal(got, dst.plane_view(pli)), pli
    assert devstats.snapshot()["launches"].get(OK.BLEND, 0) > 0


def test_sweep_encode_on_card_matches_cpu(card):
    """The colour sweep on the card and on the CPU: byte-identical
    packets, encoder check on, with leaves of 16, 32 and 64 pixels."""
    if native.get_lib() is None:
        pytest.fail("the native engine did not build")
    frames = textured_clip(640, 368, 4)
    pk = {}
    for dev in (card, "cpu"):
        enc = Encoder(headers.Info(pic_width=640, pic_height=368),
                      device=dev, quant=25, complexity=7,
                      mv_refine_mode="sweep")
        enc.enable_encoder_check = True
        devstats.reset()
        pk[str(dev)] = [bytes(p) for fr in frames
                        for p in enc.encode_frame(fr)]
        if dev is card:
            assert devstats.snapshot()["launches"].get(OK.CELLS, 0) > 0
    assert pk[str(card)] == pk["cpu"]


# The lean tier: the PVQ band search and the SAD fields on the card.

def _shift_cases():
    rng = np.random.default_rng(17)
    x = np.concatenate([
        np.array([0, 1, -1, 32767, -32768, (1 << 31) - 1, -(1 << 31),
                  1 << 32, (1 << 40) + 3, -(1 << 40)], np.int64),
        rng.integers(-(1 << 41), 1 << 41, 4000)])
    s = rng.integers(-70, 71, len(x)).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(s)


def test_pvq_helpers_on_card_match_cpu(card):
    """Shifts by 64 or more and by negative amounts, the uint32
    truncation of _ilog and the helpers built on them: the card's int64
    semantics equal the CPU's (and so XLA's, tests/test_torch_pvqsearch.py)."""
    x, s = _shift_cases()
    for name, args in (("_ilog", (x.abs(),)), ("_ilog_c", (x,)),
                       ("_shl32", (x, s)), ("_vshr", (x, s)),
                       ("_vshr_round", (x, s)), ("_od_rcp", (x,)),
                       ("_od_exp2", (x,)), ("_od_sqrt", (x.abs(),)),
                       ("_pvq_cos", (x,))):
        fn = getattr(PS, name)
        want = fn(*args)
        got = fn(*[a.to(card) for a in args])
        for w, g in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            assert torch.equal(g.cpu(), w), name
    r = torch.from_numpy(np.random.default_rng(3).integers(
        -40000, 40000, (125, 32))).long()
    xr = x[:4000].view(125, 32) >> 24
    assert torch.equal(PS._apply_householder(xr.to(card), r.to(card)).cpu(),
                       PS._apply_householder(xr, r))
    torch.cuda.synchronize()


def _search_rows(dev, n, m, is_keyframe, seed):
    rng = np.random.default_rng(seed)
    mag = rng.choice([40, 120, 700, 3000], (m, 1))
    X = rng.normal(0, 1, (m, n)) * mag
    R = X * rng.uniform(-0.2, 1.2, (m, 1)) + rng.normal(0, 1, (m, n)) * mag / 3
    R[: m // 10] = 0
    X[m // 10: m // 5] = 0
    if is_keyframe:
        R[:] = 0
    adapt = AdaptCtx()
    adapt.reset(is_keyframe)
    cw = adapt.pvq.pvq_codeword_ctx
    t = lambda a, dt=torch.int32: torch.from_numpy(np.asarray(a)).to(dev, dt)
    return dict(
        dflat=t(X.astype(np.int32).ravel()),
        mdflat=t(R.astype(np.int32).ravel()),
        base=torch.arange(m, dtype=torch.int32, device=dev) * n,
        tabsel=torch.zeros(m, dtype=torch.int32, device=dev),
        tab=torch.arange(n, dtype=torch.int32, device=dev)[None],
        qmtab=torch.full((1, n), 16, dtype=torch.int32, device=dev),
        q0=t(rng.integers(20, 400, m)),
        beta15=t(rng.integers(0, 2, m), torch.bool),
        lam=0.147, n=n, iters=n + 64,
        k1_cdf=t(cw.pvq_k1_cdf), split_cdf=t(cw.pvq_split_cdf),
        is_keyframe=is_keyframe)


@pytest.mark.parametrize("is_keyframe", [False, True])
@pytest.mark.parametrize("n,m,fast", [
    pytest.param(8, 20000, False, id="8-20000"),
    pytest.param(15, 30000, False, id="15-30000"),
    pytest.param(32, 8000, False, id="32-8000"),
    pytest.param(128, 2000, False, id="128-2000"),
    pytest.param(512, 300, False, id="512-300"),
    pytest.param(15, 30001, True, id="15-30001-fast"),
    pytest.param(128, 9001, False, id="128-9001"),
    pytest.param(32, 41, False, id="32-41")])
def test_band_search_on_card_matches_cpu(card, n, m, fast, is_keyframe):
    """The same rows on the card and on the CPU: every output of every
    row equal, the integers, y and skip_diff's bits (NaN equal to NaN),
    and every output tensor on the card (both devices compute XLA:CPU's
    float32 forms, glibc's atan2f included).  Every form of the rate
    sums (n = 8, 15, 32, 128), the fast rate model (no CDF tables),
    calls of more rows than the kernels' grids hold at once, keyframe
    calls of several rows a warp with a ragged last task (30,001 and
    9,001 rows) and a call smaller than one block.  A band wider than the
    codec's widest (128 lanes), which the band kernels do not take, is
    refused on the card and searched on the CPU."""
    args = _search_rows(card, n, m, is_keyframe, n + m)
    if fast:
        args["k1_cdf"] = args["split_cdf"] = None
    if n > 128:
        with pytest.raises(ValueError, match="bands of 2 to 128 lanes"):
            PS.band_search(**args)
        cpu = {k: v.cpu() if torch.is_tensor(v) else v
               for k, v in args.items()}
        assert PS.band_search(**cpu)[1].shape == (m, n)
        return
    got = PS.band_search(**args)
    assert all(o.device.type == "cuda" for o in got)
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in args.items()}
    want = PS.band_search(**cpu)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    g, w = got[2].cpu(), want[2]
    same = (g.view(torch.int32) == w.view(torch.int32)) | (g.isnan()
                                                            & w.isnan())
    assert bool(same.all()), int((~same).sum())
    torch.cuda.synchronize()


def test_band_acos_kernel_matches_plain(card):
    """The band_prologue kernel's arccos (csrc/band_row.cuh br::acos_xla,
    glibc's atan2f written out), run alone, against acos_xla on the card
    and on the CPU, bit for bit: every 97th float32 c in [-1, 1] and
    every c within 2^16 ulps of -1, 0 and 1, both zeros included
    (chip_smoke.py phase 2d takes every c)."""
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    one = 0x3F800000
    u = torch.cat([torch.arange(0, one + 1, 97), torch.arange(0, 1 << 16),
                   torch.arange(one - (1 << 16), one + 1)])
    c = torch.cat([u, u - (1 << 31)]).to(torch.int32).view(torch.float32)
    got = BK.acos_xla_cuda(c.to(card))
    plain = BK.acos_xla(c.to(card))
    want = BK.acos_xla(c)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()


def test_lean_python_path_on_card_matches_native(card):
    """The lean tier on the card through the Python coefficient path
    (use_native_frame = False) and the native frame pass:
    test_torch_encoder_python.py's case, byte-identical packets, the
    encoder check on, the Python path's forced-band replay fed."""
    if native.get_lib() is None:
        pytest.fail("the native engine did not build")
    from test_torch_encoder_python import lean_python_matches_native
    native_pk, python_pk, snap = lean_python_matches_native(card)
    assert snap["counts"]["forced_bands"] > 0
    assert snap["launches"].get("lap_frame", 0) > 0
    assert snap["launches"].get("dct_frame", 0) > 0
    assert python_pk == native_pk


def test_sad_fields_on_card_match_cpu(card):
    """models/mefield.py on a 640x368 frame pair (odd visible size) and
    two references: the card's fields equal the CPU's."""
    from daala_tpu_torch.models import mefield as MF
    rng = np.random.default_rng(11)
    w, h, pad = 640, 368, MC.OD_BUFFER_PADDING
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    refs = [rng.integers(0, 256, (h + 2 * pad, w + 2 * pad), dtype=np.uint8)
            for _ in range(2)]
    args = (cur, refs, pad, (357, 633), h // 8, w // 8)
    got = MF.fullpel_sad_fields(*args, device=card)
    want = MF.fullpel_sad_fields(*args, device="cpu")
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)


def _same_bits(got, want):
    """Outputs equal bit for bit (floats by their bits, NaN too), every
    one on the card."""
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("is_keyframe", [False, True])
def test_pulse_search_kernel_matches_plain(card, is_keyframe):
    """csrc/pulse_search.cu against pulse_search_plain on the card, bit for
    bit, on _pulse_search's arguments in band_search over
    test_band_search_on_card_matches_cpu's rows at a 1080p frame's row
    counts (every band length of the codec, and 512, wider than the band
    kernels take: its arguments from band_search on the CPU, moved to the
    card): one launch a call."""
    from chip_smoke import watch_pulse_search
    from daala_tpu_torch.ops.cuda import pulse_kernels as PK
    calls = []
    restore = watch_pulse_search(calls)
    try:
        for n, m in [(8, 20000), (15, 30000), (32, 8000), (128, 2000),
                     (512, 300)]:
            dev = card if n <= 128 else "cpu"
            PS.band_search(**_search_rows(dev, n, m, is_keyframe, n + m))
    finally:
        restore()
    assert len(calls) == 5
    for args in calls:
        args = [a.to(card) if torch.is_tensor(a) else a for a in args]
        devstats.reset()
        got = PK.pulse_search(*args)
        assert devstats.snapshot()["launches"] == {PK.KERNEL: 1}
        _same_bits(got, PK.pulse_search_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [1, 5, 8, 15, 20, 32, 33, 100, 128, 512])
@pytest.mark.parametrize("capped", [False, True])
def test_pulse_search_kernel_on_random_rows(card, n, capped):
    """The kernel against the plain version on the card on
    tests/test_torch_pulse_plan.py's random rows (ties, magnitudes up to
    32,767, masked lanes, a row with every lane masked, k = 0..3 and
    large, the `iters` cap), at every row width the kernel instantiates
    (8 and 16 lanes a row, a warp, 2 to 16 registers a lane)."""
    from daala_tpu_torch.ops.cuda import pulse_kernels as PK
    from test_torch_pulse_plan import _random_inputs
    args = _random_inputs(n, 3000 if n <= 128 else 600, 17 * n + capped,
                          iters=3 if capped else None)
    args = [a.to(card) if torch.is_tensor(a) else a for a in args]
    _same_bits(PK.pulse_search(*args), PK.pulse_search_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [8, 15, 32, 128])
def test_pulse_search_kernel_with_row_index(card, n):
    """The kernel against the plain version on the card when each row
    searches a row of xc chosen by `src`: 3,000 rows over 700 rows of
    xc, some taken by many rows, some by none."""
    from daala_tpu_torch.ops.cuda import pulse_kernels as PK
    from test_torch_pulse_plan import _random_inputs
    xc, k, g2, lam, lane_ok, iters = _random_inputs(n, 700, 31 * n)
    rng = np.random.default_rng(n)
    src = torch.from_numpy(rng.integers(0, 600, 3000).astype(np.int32))
    k = torch.from_numpy(rng.choice([0, 1, 2, 3, 5, 9, 40, n + 20], 3000))
    g2 = torch.from_numpy(rng.uniform(0.1, 4, 3000).astype(np.float32))
    args = [a.to(card) if torch.is_tensor(a) else a
            for a in (xc, k, g2, lam, lane_ok, iters, src)]
    _same_bits(PK.pulse_search(*args), PK.pulse_search_plain(*args))
    torch.cuda.synchronize()


def _band_cases(card, is_keyframe):
    """_search_rows at a 1080p frame's row counts of every band length,
    at two small counts (the prologue's 32 lanes a row, the epilogue's
    one keyframe row a warp) and at 9,001 rows of 128 lanes (the
    prologue's 16 lanes a row, several keyframe rows a warp, a ragged
    last task), with rows whose gathers fall before and past the
    coefficient buffer."""
    for n, m in [(8, 20000), (15, 30000), (32, 8000), (128, 2000), (8, 700),
                 (15, 600), (128, 9001)]:
        args = _search_rows(card, n, m, is_keyframe, n + m)
        base = args["base"].clone()
        base[:3] = -2 * n
        base[-3:] += 5 * n
        base[3] = -n // 2
        args["base"] = base
        yield n, args


@pytest.mark.parametrize("is_keyframe", [False, True])
def test_band_prologue_kernel_matches_plain(card, is_keyframe):
    """csrc/band_search.cu's prologue against band_prologue_plain on the
    card, bit for bit in every output: one launch a call."""
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    for n, a in _band_cases(card, is_keyframe):
        args = (a["dflat"], a["mdflat"], a["base"], a["tabsel"], a["tab"],
                a["qmtab"], a["q0"], a["beta15"], a["lam"], n, is_keyframe)
        devstats.reset()
        got = BK.band_prologue(*args)
        assert devstats.snapshot()["launches"] == {BK.KERNEL_PRO: 1}
        _same_bits(got, BK.band_prologue_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("is_keyframe", [False, True])
def test_band_epilogue_kernel_matches_plain(card, is_keyframe):
    """csrc/band_search.cu's epilogue against band_epilogue_plain on the
    card, bit for bit, on the prologue's and the pulse search's outputs
    for those rows, with the CDF tables and (n = 15) the fast rate
    model: one launch a call."""
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    from daala_tpu_torch.ops.cuda import pulse_kernels as PK
    for n, a in _band_cases(card, is_keyframe):
        xs, lane_ok, src, cf, ci, rf = BK.band_prologue_plain(
            a["dflat"], a["mdflat"], a["base"], a["tabsel"], a["tab"],
            a["qmtab"], a["q0"], a["beta15"], a["lam"], n, is_keyframe)
        res = PK.pulse_search(xs, ci[5].reshape(-1), cf[0].reshape(-1),
                              a["lam"], lane_ok, a["iters"], src)
        tables = [(a["k1_cdf"], a["split_cdf"])]
        if n == 15:
            tables.append((None, None))
        for k1, sp in tables:
            args = res + (cf, ci, rf, a["lam"], n, k1, sp, is_keyframe)
            devstats.reset()
            got = BK.band_epilogue(*args)
            assert devstats.snapshot()["launches"] == {BK.KERNEL_EPI: 1}
            _same_bits(got, BK.band_epilogue_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("is_keyframe", [False, True])
def test_band_search_on_card_is_three_launches(card, is_keyframe):
    """band_search on the card runs band_prologue, pulse_search and
    band_epilogue once each, and its result equals the plain versions'
    chain on the card bit for bit."""
    from daala_tpu_torch.ops.cuda import band_kernels as BK
    from daala_tpu_torch.ops.cuda import pulse_kernels as PK
    a = _search_rows(card, 32, 8000, is_keyframe, 5)
    devstats.reset()
    got = PS.band_search(**a)
    assert devstats.snapshot()["launches"] == {
        BK.KERNEL_PRO: 1, PK.KERNEL: 1, BK.KERNEL_EPI: 1}
    xs, lane_ok, src, cf, ci, rf = BK.band_prologue_plain(
        a["dflat"], a["mdflat"], a["base"], a["tabsel"], a["tab"],
        a["qmtab"], a["q0"], a["beta15"], a["lam"], 32, is_keyframe)
    res = PK.pulse_search_plain(xs, ci[5].reshape(-1), cf[0].reshape(-1),
                                a["lam"], lane_ok, a["iters"], src)
    _same_bits(got, BK.band_epilogue_plain(
        *res, cf, ci, rf, a["lam"], 32, a["k1_cdf"], a["split_cdf"],
        is_keyframe))
    torch.cuda.synchronize()


def test_sad_fields_kernel_matches_plain(card):
    """csrc/sad_fields.cu against sad_fields_plain on the card on the
    1080p translation pair at r = 16, as one tile and as the 2 x 2 and
    3 x 2 tiles of a mesh, and at r = 4 and r = 7 on one tile: equal
    fields, one launch a tile."""
    from chip_smoke import sad_tile_cases
    from daala_tpu_torch.ops.cuda import sad_kernels as SK
    from daala_tpu_torch.utils.profile import H, W, translation_clip
    pad = MC.OD_BUFFER_PADDING
    frames = translation_clip(nframes=2)
    cur, ref = frames[1][0], np.pad(frames[0][0], pad, mode="edge")
    nvm, nhm = ((H + 31) // 32 * 32) >> 3, ((W + 31) // 32 * 32) >> 3
    for r, rows, cols in ((16, 1, 1), (16, 2, 2), (16, 3, 2), (4, 1, 1),
                          (7, 1, 1)):
        for _, c, win, nv, nh, oy, ox in sad_tile_cases(
                cur, ref, pad, (H, W), nvm, nhm, r, rows, cols):
            ct = torch.from_numpy(c).to(card)
            wt = torch.from_numpy(win).to(card)
            devstats.reset()
            got = SK.sad_fields(ct, wt, r, nv, nh, oy, ox)
            assert devstats.snapshot()["launches"] == {SK.NAME: 1}
            assert torch.equal(got, SK.sad_fields_plain(ct, wt, r, nv, nh,
                                                        oy, ox))
    torch.cuda.synchronize()


@pytest.mark.parametrize("r", [0, 1, 16, 64])
@pytest.mark.parametrize("offset", [0, 3])
def test_sad_fields_kernel_on_ragged_tiles(card, r, offset):
    """The kernel against the plain version on the card on the ragged
    tiles of tests/test_torch_sad_plan.py (partial cells, widths that are
    no multiple of 4, windows clipped by the margins), the planes as
    views at storage offsets 0 and 3: at 0 the tile whose rows start on
    16 bytes takes the cp.async staging, at 3 every tile the staging
    through registers."""
    from daala_tpu_torch.ops.cuda import sad_kernels as SK
    from test_torch_sad_plan import TILES, _tile

    def view(a):
        t = torch.zeros(a.size + 16, dtype=torch.uint8, device=card)
        t = t[offset:offset + a.size].view(a.shape)
        return t.copy_(torch.from_numpy(a))
    for k, (vh, vw, oy, ox, nv, nh) in enumerate(TILES):
        cur, ref = _tile(r + 10 * k, vh, vw, r)
        ct, wt = view(cur), view(ref)
        assert ct.is_contiguous() and ct.data_ptr() % 16 == offset
        got = SK.sad_fields(ct, wt, r, nv, nh, oy, ox)
        assert torch.equal(got, SK.sad_fields_plain(ct, wt, r, nv, nh, oy,
                                                    ox))
    torch.cuda.synchronize()


def _dering_luma(rng):
    """A 1080p int16 luma plane (17 x 30 superblocks) with rows of the
    border value, and a skip map with all-skip superblocks (a corner
    one and an interior one, their windows included) and edge
    superblocks partly skipped."""
    luma = rng.integers(-3000, 3000, (1088, 1920)).astype(np.int16)
    luma[::37] = 30000
    bskip = (rng.random((272, 480)) < 0.5).astype(np.uint8)
    bskip[:17, :17] = 1
    bskip[79:97, 239:257] = 1
    return luma, bskip


def test_dering_candidates_on_card_match_cpu(card):
    """models/restore.py's candidates of every 1080p superblock x the 5
    gains: the card's equal the CPU's, directions too."""
    from daala_tpu_torch.models import restore as TR
    luma, bskip = _dering_luma(np.random.default_rng(12))
    args = (luma, bskip, 271, 17, 30)
    cands, dirs = TR.dering_candidates_device(*args, device=card)
    want_c, want_d = TR.dering_candidates_device(*args, device="cpu")
    np.testing.assert_array_equal(dirs, want_d)
    np.testing.assert_array_equal(cands, want_c)
    np.testing.assert_array_equal(cands[0, 4], luma[:64, :64])


def test_frame_dering_on_card_matches_cpu(card):
    """The decoder's batched dering of a 1080p 4:2:0 frame (every
    superblock with a random level, chroma on luma's directions): card
    equals CPU."""
    from daala_tpu_torch.models import restore as TR
    rng = np.random.default_rng(13)
    luma, bskip = _dering_luma(rng)
    chroma = [rng.integers(-3000, 3000, (544, 960)).astype(np.int16)
              for _ in range(2)]
    cskip = [(rng.random((136, 240)) < 0.5).astype(np.uint8)
             for _ in range(2)]
    sbs = np.flatnonzero(rng.random(17 * 30) < 0.7)
    thr = [rng.integers(10, 300, len(sbs)).tolist() for _ in range(3)]
    args = ([luma] + chroma, [bskip] + cskip, [0, 1, 1], 17, 30, sbs, thr)
    got = TR.dering_frame_device(*args, device=card)
    want = TR.dering_frame_device(*args, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _random_bsize(state, rng):
    """A random valid block-size quadtree in state.bsize (8x8 cells)."""
    def rec(cx, cy, bsi):
        if bsi == 1:
            state.bsize[cy, cx] = rng.integers(0, 2)
        elif rng.random() < 0.6:
            half = 1 << (bsi - 2)
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                rec(cx + dx * half, cy + dy * half, bsi - 1)
        else:
            k = 1 << (bsi - 1)
            state.bsize[cy:cy + k, cx:cx + k] = bsi
    for sby in range(state.nvsb):
        for sbx in range(state.nhsb):
            rec(sbx * 8, sby * 8, 4)


def test_synthesis_on_card_matches_cpu(card):
    """models/synthesis.py synthesize_frame on a 1080p frame with a
    random block-size map (every leaf size, split postfilters at every
    level): the card's planes equal the CPU's, and both kernels ran."""
    from daala_tpu_torch.codec.state import CodecState
    from daala_tpu_torch.models import synthesis as SY
    rng = np.random.default_rng(14)
    info = headers.Info(pic_width=1920, pic_height=1080)
    state = CodecState(info)
    _random_bsize(state, rng)
    d = [rng.integers(-4000, 4000, (1088 >> yd, 1920 >> xd)).astype(np.int32)
         for xd, yd in info.plane_dec[:3]]
    devstats.reset()
    got = SY.synthesize_frame(state, info, d, card)
    launches = devstats.snapshot()["launches"]
    want = SY.synthesize_frame(state, info, d, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert launches.get("lap_frame") == 3
    assert launches.get("dct_frame", 0) >= 3 * 4


def test_decode_on_card_matches_host(card):
    """bench.py's 1080p clip (a keyframe and an inter frame, its preset)
    encoded on the card, then decoded by the port's Decoder with its
    device back end on the card and by its host Decoder: equal planes."""
    from daala_tpu_torch.codec.decoder import Decoder
    from daala_tpu_torch.utils.profile import ENCODER_KW, translation_clip
    if native.get_lib() is None:
        pytest.fail("the native engine did not build")
    frames = translation_clip(nframes=2)
    info = headers.Info(pic_width=1920, pic_height=1080)
    enc = Encoder(info, device=card, **ENCODER_KW)
    enc.keyframe_rate = 256
    pk = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
    outs = {}
    devstats.reset()
    for name, dec in (("card", Decoder(info, device=card,
                                       use_device_synthesis=True)),
                      ("host", Decoder(info, use_device_synthesis=False))):
        outs[name] = [o for p in pk for o in dec.decode_packet(p)]
    assert len(outs["card"]) == len(outs["host"]) == 2
    for a, b in zip(outs["card"], outs["host"]):
        for pli in range(3):
            np.testing.assert_array_equal(a[pli], b[pli])
    snap = devstats.snapshot()
    assert snap["launches"].get("lap_frame", 0) >= 6
    assert snap["spans_s"]["synthesize_frame"] > 0


def test_batch_encode_step_on_card_matches_cpu(card):
    """models/analysis.py's uniform pipeline over a batch on the card:
    rec, sse and nz equal the CPU's; both kernels launch once each way
    per frame."""
    from daala_tpu_torch.parallel import mesh as PM
    frames = np.random.default_rng(3).integers(0, 256, (2, 256, 384),
                                               np.uint8)
    shards = PM.shard_batch(frames, PM.make_mesh(devices=[card]))
    devstats.reset()
    rec, sse, nz = PM.batch_encode_step(shards)
    torch.cuda.synchronize()
    launches = devstats.snapshot()["launches"]
    want = PM.batch_encode_step(torch.from_numpy(frames))
    assert torch.equal(torch.from_numpy(rec.gather()), want[0])
    assert (sse, nz) == want[1:]
    assert launches.get("lap_frame") == launches.get("dct_frame") == 4


def test_clips_batched_on_card_match_serial(card):
    """Two small clips on a 2-row mesh of the card, both schedules: the
    packets of serial encodes on the card and on the CPU."""
    from daala_tpu_torch.parallel import mesh as PM
    w, h = 192, 128
    clips = [textured_clip(w, h, 2, seed=s) for s in (1, 2)]
    info = headers.Info(pic_width=w, pic_height=h)
    want = {}
    for dev in (card, "cpu"):
        want[str(dev)] = []
        for frames in clips:
            enc = Encoder(info, device=dev, quant=18, complexity=7)
            pk = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
            want[str(dev)].append(pk + [bytes(p) for p in enc.flush()])
    assert want[str(card)] == want["cpu"]
    mesh = PM.make_mesh(devices=[card, card])
    for threads in (False, True):
        devstats.reset()
        outs = PM.encode_clips_batched(clips, dict(pic_width=w, pic_height=h),
                                       mesh, quant=18, complexity=7,
                                       threads=threads)
        assert [[bytes(p) for p in o] for o in outs] == want["cpu"]
        assert devstats.snapshot()["launches"].get("dct_frame", 0) > 0


def test_measure_mags_on_card_matches_cpu(card):
    """train.zigzag.measure_mags on the card: the CPU's mags bit for bit
    at every n, one lap_frame and one dct_frame launch per frame."""
    from daala_tpu_torch.train import zigzag as ZZ
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (200, 330), np.uint8) for _ in range(2)]
    for n in (4, 8, 16, 32, 64):
        devstats.reset()
        got = ZZ.measure_mags(frames, n, card)
        launches = devstats.snapshot()["launches"]
        np.testing.assert_array_equal(got, ZZ.measure_mags(frames, n, "cpu"))
        assert launches.get("lap_frame") == launches.get("dct_frame") == 2


def test_gain_search_on_card_matches_cpu(card):
    """train.gain.search on the card: the CPU's integer parameters, its
    float optimum within 1e-4 dB."""
    from daala_tpu_torch.train import gain
    for n, filt in ((4, 4), (8, 8)):
        best, cg, fcg = gain.search(n, filt, steps=100, device=card)
        cbest, ccg, cfcg = gain.search(n, filt, steps=100, device="cpu")
        assert best == cbest and cg == ccg
        assert abs(fcg - cfcg) <= 1e-4


def test_vq_train_on_card_is_deterministic(card):
    """train.vq.train on the card: two runs identical, within 1e-5 of the
    CPU's history."""
    from daala_tpu_torch.train import vq
    rng = np.random.default_rng(9)
    data = rng.normal(size=(64, 16))[rng.integers(0, 64, 20000)]
    data += 0.2 * rng.normal(size=data.shape)
    a = vq.train(data, 32, 6, device=card)
    b = vq.train(data, 32, 6, device=card)
    assert a[1] == b[1] and np.array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], vq.train(data, 32, 6, device="cpu")[1],
                               rtol=0, atol=1e-5)


# -- the mesh's sp axis: tiles on the card -----------------------------------

def _mesh_of(card, dp, sp):
    from daala_tpu_torch.parallel import mesh as PM
    return PM.make_mesh(devices=[card] * (dp * sp), dp=dp)


@pytest.mark.parametrize("h,w,sb", [(1088, 1920, 64), (544, 960, 32),
                                    (136, 200, 64)])
def test_lap_kernel_on_tiles_matches_plain(card, h, w, sb):
    """The lap kernel from each tile's origin (a 2 x 2 mesh of the card,
    and one tile per superblock row): its plain version on the same tile
    bit for bit, and, cropped, the plane's kernel; dct_frame on each
    tile's interior: its plain version."""
    from daala_tpu_torch.parallel.sharding import Sharding, put
    x = np.random.default_rng(h).integers(-2**14, 2**14,
                                          (h, w)).astype(np.int32)
    for mesh in ((2, 2), (h // sb, 1)):
        sp = put(x, Sharding(_mesh_of(card, *mesh), ("dp", "sp")), halo=2,
                 unit=sb)
        for fwd in (True, False):
            plane = lap_kernels.lap_frame_cuda(torch.from_numpy(x).to(card),
                                               sb, sb, fwd).cpu().numpy()
            for t in sp.tiles:
                k = lap_kernels.lap_frame_cuda(t.data, sb, sb, fwd, t.origin,
                                               t.plane)
                assert torch.equal(k, lap_kernels.lap_frame_plain(
                    t.data, sb, sb, fwd, t.origin, t.plane))
                np.testing.assert_array_equal(t.crop(k).cpu().numpy(),
                                              plane[t.slices()])
                inner = t.crop()
                for n in (4, 8, 16, 32):
                    if inner.shape[0] % n or inner.shape[1] % n:
                        continue  # a ragged plane's last tile
                    assert torch.equal(
                        dct_kernels.dct_frame_cuda(inner, n, fwd, t.start),
                        dct_kernels.dct_frame_plain(inner, n, fwd))
    torch.cuda.synchronize()


def _kf_state(w, h):
    """A codec state with a mixed block-size map (every level)."""
    from daala_tpu_torch.codec import headers as TH
    from daala_tpu_torch.codec.state import CodecState
    info = TH.Info(pic_width=w, pic_height=h)
    st = CodecState(info)
    st.init_superblock_split(2)
    st.bsize[:8, :8] = 0
    st.bsize[8:16, :8] = 1
    st.bsize[:8, 8:16] = 3
    st.bsize[16:24, 16:24] = 4
    return info, st


def test_sharded_device_tier_on_card_matches_cpu(card):
    """analyze_keyframe, analyze_inter, analyze_rdo_pyramid,
    synthesize_frame and fullpel_sad_fields on a 2 x 2 mesh of the card
    (named_put(mesh, ("dp", "sp"))): the unsharded CPU results; both
    kernels launch once per tile and pass."""
    from daala_tpu_torch.models import keyframe as KF
    from daala_tpu_torch.models import mefield as MF
    from daala_tpu_torch.models import synthesis as S
    from daala_tpu_torch.parallel.sharding import named_put
    info, st = _kf_state(320, 192)
    rng = np.random.default_rng(4)
    planes = [rng.integers(0, 256, (st.frame_height >> d, st.frame_width >> d),
                           dtype=np.uint8) for d in (0, 1, 1)]
    mc = [rng.integers(0, 256, p.shape, dtype=np.uint8) for p in planes]
    d = [rng.integers(-3000, 3000, p.shape).astype(np.int32) for p in planes]
    hook = named_put(_mesh_of(card, 2, 2), ("dp", "sp"))
    devstats.reset()
    got = KF.analyze_keyframe(st, info, planes, False, card,
                              device_put_fn=hook)[-1]()
    for g, w in zip(got, KF.analyze_keyframe(st, info, planes, False,
                                             "cpu")[-1]()):
        np.testing.assert_array_equal(g, w)
    launches = devstats.snapshot()["launches"]
    assert launches["lap_frame"] == 3 * 4
    got = KF.analyze_inter(st, info, planes, mc, False, card,
                           device_put_fn=hook)[-1]()
    want = KF.analyze_inter(st, info, planes, mc, False, "cpu")[-1]()
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
    for mc_pl in (None, [mc[0]]):
        got = KF.analyze_rdo_pyramid(st, info, planes, mc_pl, False, card,
                                     device_put_fn=hook)
        want = KF.analyze_rdo_pyramid(st, info, planes, mc_pl, False, "cpu")
        for g, w in zip(got, want):
            if isinstance(w, dict):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            elif w is not None:
                np.testing.assert_array_equal(g, w)
    devstats.reset()
    got = S.synthesize_frame(st, info, d, card, device_put_fn=hook)
    for g, w in zip(got, S.synthesize_frame(st, info, d, "cpu")):
        np.testing.assert_array_equal(g, w)
    snap = devstats.snapshot()
    assert snap["launches"]["lap_frame"] == 3 * 4
    assert snap["counts"]["halo_bytes"] > 0
    pad = 32
    refs = [rng.integers(0, 256, (st.frame_height + 2 * pad,
                                  st.frame_width + 2 * pad), dtype=np.uint8)
            for _ in range(2)]
    kw = dict(r=16)
    args = (planes[0], refs, pad, (185, 310), st.frame_height // 8,
            st.frame_width // 8)
    for g, w in zip(MF.fullpel_sad_fields(*args, device=card,
                                          device_put_fn=hook, **kw),
                    MF.fullpel_sad_fields(*args, device="cpu", **kw)):
        np.testing.assert_array_equal(g, w)
    torch.cuda.synchronize()


def test_batch_encode_step_in_tiles_on_card_matches_cpu(card):
    """The uniform pipeline's batch over a 2 x 2 mesh of the card (the
    columns cut 3 + 3 superblocks, the inverse lapped filter's halo
    exchanged on the card): rec, sse and nz equal the CPU's in one
    piece."""
    from daala_tpu_torch.parallel import mesh as PM
    frames = np.random.default_rng(3).integers(0, 256, (2, 256, 384),
                                               np.uint8)
    devstats.reset()
    rec, sse, nz = PM.batch_encode_step(
        PM.shard_batch(frames, _mesh_of(card, 2, 2)))
    torch.cuda.synchronize()
    snap = devstats.snapshot()
    want = PM.batch_encode_step(torch.from_numpy(frames))
    assert torch.equal(torch.from_numpy(rec.gather()), want[0])
    assert (sse, nz) == want[1:]
    assert snap["launches"]["lap_frame"] == 2 * 2 * 2
    assert snap["counts"]["halo_bytes"] == 2 * 2 * 2 * 256 * 4


def test_clips_batched_in_tiles_on_card_match_serial(card):
    """Two small clips on a 2 x 2 mesh of the card, each clip's planes
    over its row's 2 columns (its own stream), both schedules: the
    packets of serial CPU encodes."""
    from daala_tpu_torch.parallel import mesh as PM
    w, h = 256, 128
    clips = [textured_clip(w, h, 2, seed=s) for s in (1, 2)]
    info = headers.Info(pic_width=w, pic_height=h)
    want = []
    for frames in clips:
        enc = Encoder(info, device="cpu", quant=18, complexity=7)
        pk = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
        want.append(pk + [bytes(p) for p in enc.flush()])
    for threads in (False, True):
        devstats.reset()
        outs = PM.encode_clips_batched(clips, dict(pic_width=w, pic_height=h),
                                       _mesh_of(card, 2, 2), quant=18,
                                       complexity=7, threads=threads)
        assert [[bytes(p) for p in o] for o in outs] == want
        assert devstats.snapshot()["launches"].get("lap_frame", 0) > 0
