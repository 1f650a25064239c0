"""The port's analysis front end (daala_tpu_torch/models) against the JAX
functions of daala_tpu/models/keyframe.py, on the same planes and masks.

The codec has no learned weights: what the two must share is the host
state turned into masks (the block-size map), so the copied mask
functions are checked against the JAX ones on random block-size maps.
Every output is an integer plane; the tolerance is zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daala_tpu.codec import headers
from daala_tpu.codec.state import CodecState
from daala_tpu.models import analysis as j_analysis
from daala_tpu.models import keyframe as JKF
from daala_tpu_torch.models import analysis as t_analysis
from daala_tpu_torch.models import keyframe as TKF
from daala_tpu_torch.utils import devstats

CPU = torch.device("cpu")


def _random_map(state, seed, p_split=0.6):
    """Fill state.bsize with a random valid quadtree (8x8 granularity:
    a node of level bsi >= 1 covers 2^(bsi-1) cells; value 0 in a cell
    means four 4x4 blocks)."""
    rng = np.random.default_rng(seed)

    def rec(cx, cy, bsi):
        if bsi == 1:
            state.bsize[cy, cx] = rng.integers(0, 2)
            return
        if rng.random() < p_split:
            half = 1 << (bsi - 2)
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                rec(cx + dx * half, cy + dy * half, bsi - 1)
            return
        k = 1 << (bsi - 1)
        state.bsize[cy:cy + k, cx:cx + k] = bsi

    for sby in range(state.nvsb):
        for sbx in range(state.nhsb):
            rec(sbx * 8, sby * 8, 4)


def _setup(w, h, seed, **info_kw):
    info = headers.Info(pic_width=w, pic_height=h, **info_kw)
    state = CodecState(info)
    _random_map(state, seed)
    return info, state


def _planes(info, state, seed, dtype=np.uint8, hi=255):
    """Smooth content plus noise, one plane per codec plane."""
    rng = np.random.default_rng(seed)
    out = []
    for pli in range(info.nplanes):
        xd, yd = info.plane_dec[pli]
        h, w = state.frame_height >> yd, state.frame_width >> xd
        yy, xx = np.mgrid[0:h, 0:w]
        v = (hi / 2 + hi / 4 * np.sin(xx / (5.0 + pli))
             + hi / 6 * np.cos(yy / 7.0) + rng.normal(0, hi / 30, (h, w)))
        out.append(v.clip(0, hi).astype(dtype))
    return out


def _jax_masks(m):
    return tuple({k: jnp.asarray(v) for k, v in m[key].items()}
                 for key in ("split_h", "split_v", "merge", "leaf"))


@pytest.mark.parametrize("w,h,seed", [(256, 192, 0), (177, 115, 1)])
def test_mask_functions_match_jax(w, h, seed):
    info, state = _setup(w, h, seed)
    for pli in range(info.nplanes):
        a = TKF.build_analysis_masks(state, info, pli)
        b = JKF.build_analysis_masks(state, info, pli)
        for key in b:
            assert a[key].keys() == b[key].keys()
            for k in b[key]:
                assert np.array_equal(a[key][k], b[key][k]), (pli, key, k)
    a, b = TKF._rdo_level_masks(state, info), JKF._rdo_level_masks(state,
                                                                    info)
    assert a.keys() == b.keys()
    for k in b:
        assert np.array_equal(a[k][0], b[k][0])
        assert np.array_equal(a[k][1], b[k][1])


def test_analysis_helpers_match_jax():
    """lift_to_coeff, the frame pre/post filters and the tiling."""
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (128, 192)).astype(np.uint8)
    c_t = t_analysis.lift_to_coeff(torch.from_numpy(u8))
    c_j = j_analysis.lift_to_coeff(jnp.asarray(u8))
    assert np.array_equal(c_t.numpy(), np.asarray(c_j))
    pre_t = t_analysis.prefilter_frame(c_t)
    pre_j = j_analysis.prefilter_frame(c_j)
    assert np.array_equal(pre_t.numpy(), np.asarray(pre_j))
    post_t = t_analysis.postfilter_frame(pre_t)
    assert np.array_equal(post_t.numpy(),
                          np.asarray(j_analysis.postfilter_frame(pre_j)))
    assert np.array_equal(post_t.numpy(), c_t.numpy())
    rows = t_analysis._filter_rows_at(c_t, [30, 94], inv=False)
    assert np.array_equal(rows.numpy(), np.asarray(
        j_analysis._filter_rows_at(c_j, [30, 94], inv=False)))
    cols = t_analysis._filter_cols_at(c_t, [62], inv=True)
    assert np.array_equal(cols.numpy(), np.asarray(
        j_analysis._filter_cols_at(c_j, [62], inv=True)))
    b = t_analysis.blocks_of(c_t, 16)
    assert np.array_equal(b.numpy(), np.asarray(j_analysis.blocks_of(c_j,
                                                                     16)))
    assert torch.equal(t_analysis.unblocks(b, 128, 192), c_t)


@pytest.mark.parametrize("case,pli", [("8bit", 0), ("8bit", 1), ("8bit", 2),
                                      ("12bit", 0), ("pallas_lap", 0)])
def test_keyframe_analysis_plane_matches_jax(case, pli):
    """Each plane of an 8-bit keyframe; the luma plane of a 12-bit
    uint16 one (full precision, travelling as int16), and of one with
    the JAX side through its Pallas lap kernel in interpret mode.  (Each
    JAX variant traces anew, which dominates this file's time.)"""
    kw = {}
    if case == "12bit":
        kw = dict(bitdepth_mode=3, full_precision_references=True)
    info, state = _setup(192, 128, 5, **kw)
    if case == "12bit":
        planes = _planes(info, state, 6, np.uint16, 4095)
    else:
        planes = _planes(info, state, 6)
    fpr_mode = info.bitdepth_mode if case == "12bit" else 0
    xdec, ydec = info.plane_dec[pli]
    masks = TKF.build_analysis_masks(state, info, pli)
    got = TKF.keyframe_analysis_plane(
        TKF._upload_plane(planes[pli], CPU), TKF._mask_tensors(masks, CPU),
        xdec=xdec, ydec=ydec, fpr_mode=fpr_mode)
    want = JKF.keyframe_analysis_plane(
        jnp.asarray(planes[pli]), _jax_masks(masks), xdec=xdec, ydec=ydec,
        fpr_mode=fpr_mode, use_pallas=case == "pallas_lap")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pli", [0, 1, 2])
def test_inter_analysis_plane_matches_jax(pli):
    """(d, md) of each plane at 177x115, whose padding exercises the
    padding-follows-prediction substitution."""
    info, state = _setup(177, 115, 7)
    planes = _planes(info, state, 8)
    mc_planes = _planes(info, state, 9)
    xdec, ydec = info.plane_dec[pli]
    masks = TKF.build_analysis_masks(state, info, pli)
    pic_w = (info.pic_width + (1 << xdec) - 1) >> xdec
    pic_h = (info.pic_height + (1 << ydec) - 1) >> ydec
    d, md = TKF.inter_analysis_plane(
        TKF._upload_plane(planes[pli], CPU),
        TKF._upload_plane(mc_planes[pli], CPU),
        TKF._mask_tensors(masks, CPU), xdec=xdec, ydec=ydec,
        pic_w=pic_w, pic_h=pic_h)
    jd, jmd = JKF.inter_analysis_plane(
        jnp.asarray(planes[pli]), jnp.asarray(mc_planes[pli]),
        _jax_masks(masks), xdec=xdec, ydec=ydec, pic_w=pic_w, pic_h=pic_h)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert np.array_equal(md.numpy(), np.asarray(jmd))


@pytest.mark.parametrize("keyframe", [True, False])
def test_rdo_pyramid_matches_jax(keyframe):
    w, h = 177, 115
    info, state = _setup(w, h, 10)
    planes = _planes(info, state, 11)
    mc = None if keyframe else _planes(info, state, 12)
    d_l, md_l, d_m = TKF.analyze_rdo_pyramid(
        state, info, planes, None if keyframe else [mc[0]], False, "cpu")
    jd_l, jmd_l, jd_m = JKF.analyze_rdo_pyramid(
        state, info, planes, None if keyframe else [mc[0]], False)
    assert d_l.keys() == jd_l.keys() == set(range(5))
    for k in jd_l:
        assert np.array_equal(d_l[k], jd_l[k]), k
    if keyframe:
        assert md_l is None and jmd_l is None
        assert np.array_equal(d_m, jd_m)
    else:
        assert d_m is None and jd_m is None
        for k in jmd_l:
            assert np.array_equal(md_l[k], jmd_l[k]), k


def test_analyze_counts_its_work():
    """Each analyze_* call runs in a devstats span of its name and counts
    one dispatch per plane; a CPU run moves no host<->device bytes."""
    info, state = _setup(192, 128, 13)
    planes = _planes(info, state, 14)
    mc = _planes(info, state, 15)
    devstats.reset()
    TKF.analyze_keyframe(state, info, planes, False, "cpu")[-1]()
    TKF.analyze_inter(state, info, planes, mc, False, "cpu")[-1]()
    TKF.analyze_rdo_pyramid(state, info, planes, [mc[0]], False, "cpu")
    snap = devstats.snapshot()
    assert set(snap["spans_s"]) == {"analyze_keyframe", "analyze_inter",
                                    "analyze_rdo_pyramid"}
    assert all(v > 0 for v in snap["spans_s"].values())
    assert snap["dispatches"] == 2 * info.nplanes + 1
    assert snap["h2d_bytes"] == snap["d2h_bytes"] == 0
    assert snap["launches"] == {}
