"""Tests of the port that need a CUDA card: the kernels against their
plain versions at the encoder's 1080p shapes, launch-error reporting,
the device OBMC predictor against the host's, the encoder on the card
against the host encoder and (in sweep mode) against itself on the
CPU, the lean tier's PVQ band search and SAD fields on the card
against the CPU, the decoder's device back end (dering and synthesis)
on the card against the CPU and the host decoder, and the parallel
encodes (parallel/mesh.py) on the card against the CPU and serial
encodes.

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
@pytest.mark.parametrize("n,m", [(8, 20000), (15, 30000), (32, 8000),
                                 (128, 2000), (512, 300)])
def test_band_search_on_card_matches_cpu(card, n, m, is_keyframe):
    """The same rows on the card and on the CPU: the integer outputs and
    y equal on at least 99% of rows (the float32 RDO may flip near-ties
    between the devices), and every output tensor on the card."""
    args = _search_rows(card, n, m, is_keyframe, n + m)
    got = PS.band_search(**args)
    assert all(o.device.type == "cuda" for o in got)
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in args.items()}
    want = PS.band_search(**cpu)
    same = (got[0].cpu() == want[0]).all(1) & (got[1].cpu() == want[1]).all(1)
    assert int(same.sum()) >= 0.99 * m, (int(same.sum()), m)
    torch.cuda.synchronize()


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
    want = PM.batch_encode_step([torch.from_numpy(frames)])
    assert torch.equal(rec[0].cpu(), want[0][0])
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
