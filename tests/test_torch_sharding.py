"""The mesh's `sp` axis (daala_tpu_torch/parallel/sharding.py): cuts,
put, gather and the halo exchange on CPU devices; the lap kernel's
plain version on tiles against the plane's and JAX's Pallas kernel in
interpret mode; and the port's sharded analysis, synthesis and SAD
fields against JAX's unsharded functions on the same seeded inputs.

JAX shards these functions' inputs and XLA inserts the halo
collectives (daala_tpu/parallel/mesh.py); the port cuts its planes on
superblocks and exchanges 2-pixel halos itself.  Sharding changes where
the work runs, never what it computes: every value compared is an
integer, and the tolerance is zero.

tests/test_torch_cuda.py runs the tile kernels and the sharded
analysis and synthesis on a card (a 2 x 2 mesh on cuda:0).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daala_tpu.models import keyframe as JKF
from daala_tpu.models import mefield as JMF
from daala_tpu.models import synthesis as JS
from daala_tpu.ops.pallas.lap_kernels import lap_frame_pallas
from daala_tpu_torch.models import keyframe as TKF
from daala_tpu_torch.models import mefield as TMF
from daala_tpu_torch.models import synthesis as TS
from daala_tpu_torch.ops.cuda import dct_kernels, lap_kernels
from daala_tpu_torch.parallel import mesh as PM
from daala_tpu_torch.parallel.sharding import (Sharding, ShardedPlane,
                                               as_plane, named_put, put,
                                               split_units, stage_hook)
from daala_tpu_torch.utils import devstats
from test_torch_analysis import _planes, _setup
import torch_threads

torch_threads.share_cores()

CPU = torch.device("cpu")


def _mesh(dp, sp, device="cpu"):
    return PM.make_mesh(devices=[device] * (dp * sp), dp=dp)


# -- cuts, put, gather, the halo exchange ------------------------------------

@pytest.mark.parametrize("n,parts,want", [
    (17, 2, [0, 9, 17]),         # 1088 rows over dp = 2: 9 + 8 superblocks
    (30, 2, [0, 15, 30]),        # 1920 columns over sp = 2
    (5, 3, [0, 2, 4, 5]),
    (3, 4, [0, 1, 2, 3, 3]),     # fewer units than parts: the last empty
    (1, 1, [0, 1])])
def test_split_units(n, parts, want):
    assert split_units(n, parts) == want


def _expect_tiles(shape, sharding, unit, halo):
    """(start, stop, halo) of every tile put() should make, from first
    principles: per axis, parts of whole units as split_units cuts
    them, the empty ones dropped."""
    parts = sharding.parts(len(shape))
    units = (1,) * (len(shape) - 2) + ((unit, unit) if isinstance(unit, int)
                                        else unit)
    cuts = []
    for size, u, p in zip(shape, units, parts):
        b = split_units(-(-size // u), p)
        cuts.append([(min(b[i] * u, size), min(b[i + 1] * u, size))
                     for i in range(p)])
    out = []
    for idx in np.ndindex(*parts):
        rng = [cuts[a][k] for a, k in enumerate(idx)]
        if any(s >= e for s, e in rng):
            continue
        hl = tuple((halo if rng[a][0] > 0 else 0,
                    halo if rng[a][1] < shape[a] else 0)
                   for a in (-2, -1))
        out.append((tuple(r[0] for r in rng), tuple(r[1] for r in rng), hl))
    return out


PUT_CASES = [
    # (shape, mesh (dp, sp), spec, unit)
    ((1088, 192), (2, 1), ("dp", None), 64),       # 9 + 8 superblocks
    ((544, 960), (2, 2), ("dp", "sp"), 32),        # 1080p chroma
    ((192, 320), (3, 5), ("dp", "sp"), 64),        # one superblock each
    ((64, 128), (2, 4), ("dp", "sp"), 64),         # devices without tiles
    ((136, 200), (2, 2), ("dp", "sp"), 64),        # ragged last superblock
    ((192, 160), (1, 2), (None, "sp"), (64, 32)),  # 4:2:2 chroma
    ((4, 64, 200), (2, 2), ("dp", None, "sp"), 64),
]


@pytest.mark.parametrize("shape,mesh,spec,unit", PUT_CASES)
@pytest.mark.parametrize("halo", [0, 2])
def test_put_and_gather(shape, mesh, spec, unit, halo):
    """Every tile holds its cut of the array and the halo beside each
    cut, on the device of its place in the mesh; gather() gives the
    array back."""
    x = np.random.default_rng(len(shape)).integers(
        -(1 << 20), 1 << 20, shape).astype(np.int32)
    m = _mesh(*mesh)
    sh = Sharding(m, spec)
    sp = put(x, sh, halo=halo, unit=unit)
    assert [(t.start, t.stop, t.halo) for t in sp.tiles] == \
        _expect_tiles(shape, sh, unit, halo)
    for t in sp.tiles:
        (ht, hb), (hl, hr) = t.halo
        sl = t.slices()[:-2] + (
            slice(t.start[-2] - ht, t.stop[-2] + hb),
            slice(t.start[-1] - hl, t.stop[-1] + hr))
        np.testing.assert_array_equal(t.data.numpy(), x[sl])
        assert t.origin == (t.start[-2] - ht, t.start[-1] - hl)
        assert t.plane == shape[-2:]
    np.testing.assert_array_equal(sp.gather(), x)
    np.testing.assert_array_equal(sp.to(CPU).numpy(), x)


def test_put_refusals_and_the_hook():
    m = _mesh(2, 2)
    with pytest.raises(ValueError):
        Sharding(m, ("dp", "dp"))
    with pytest.raises(ValueError):
        Sharding(m, ("rows",))
    with pytest.raises(ValueError):
        put(np.zeros((3, 64, 64), np.uint8), Sharding(m, ("dp", None)))
    hook = named_put(m, ("dp", "sp"))
    assert hook.device == m[0, 0]
    flat = hook(np.arange(5, dtype=np.int32), 0)
    assert isinstance(flat, torch.Tensor) and flat.device == m[0, 0]
    assert isinstance(hook(np.zeros((128, 128), np.uint8), 1), ShardedPlane)
    assert stage_hook(hook, CPU) is hook
    with pytest.raises(ValueError):
        stage_hook(hook, torch.device("meta"))
    # Without a hook a stage puts each plane as one tile with no halo,
    # which to(), gather() and exchange_halo() hand over as it is.
    x = np.arange(128 * 192, dtype=np.int32).reshape(128, 192)
    one = stage_hook(None, CPU)(x, 0, halo=2)
    assert one.device == CPU and len(one.tiles) == 1
    (t,) = one.tiles
    assert t.halo == ((0, 0), (0, 0)) and t.origin == (0, 0)
    assert one.to(CPU) is t.data
    assert one.exchange_halo(2).tiles[0].data is t.data
    np.testing.assert_array_equal(one.gather(), x)
    y = torch.from_numpy(x)
    plane, back = as_plane(y)
    assert plane.tiles[0].data is y and back(plane) is y
    assert as_plane(one)[0] is one


@pytest.mark.parametrize("shape,mesh,spec,unit", PUT_CASES)
def test_exchange_halo_takes_the_neighbours(shape, mesh, spec, unit):
    """exchange_halo(2) of tiles with no halo gives each tile what put()
    uploads with a halo of 2 (its neighbours' pixels, corners included),
    and counts the copied bytes."""
    x = np.random.default_rng(7).integers(
        -(1 << 20), 1 << 20, shape).astype(np.int32)
    sh = Sharding(_mesh(*mesh), spec)
    devstats.reset()
    got = put(x, sh, unit=unit).exchange_halo(2)
    want = put(x, sh, halo=2, unit=unit)
    nbytes = 0
    for g, w in zip(got.tiles, want.tiles):
        assert (g.start, g.stop, g.halo) == (w.start, w.stop, w.halo)
        assert torch.equal(g.data, w.data)
        nbytes += 4 * (g.data.numel() - g.crop().numel())
    assert devstats.snapshot()["counts"].get("halo_bytes", 0) == nbytes


def test_frames_of_a_stacked_plane():
    x = np.random.default_rng(3).integers(0, 256, (4, 64, 200), np.uint8)
    sp = put(x, Sharding(_mesh(2, 2), ("dp", None, "sp")), halo=2)
    frames = [sp.frame(b) for b in range(4)]
    for b, f in enumerate(frames):
        assert f.shape == (64, 200) and len(f.tiles) == 2
        assert [t.halo for t in f.tiles] == [((0, 0), (0, 2)),
                                             ((0, 0), (2, 0))]
        np.testing.assert_array_equal(f.gather(), x[b])
    back = sp.stack([f.replace([t.crop() for t in f.tiles])
                     for f in frames])
    np.testing.assert_array_equal(back.gather(), x)


# -- the lap kernel on tiles -------------------------------------------------

# (h, w, sb_x, sb_y): luma and chroma planes of 5 x 3 superblocks (an odd
# number), 4:2:2 chroma, a plane with a ragged last superblock, and one
# a single superblock high.
LAP_PLANES = [(192, 320, 64, 64), (96, 160, 32, 32), (192, 160, 32, 64),
              (136, 200, 64, 64), (64, 320, 64, 64)]
# (dp, sp): columns only, rows only, both, and a cut at every
# superblock boundary (one-superblock tiles, frame-border tiles).
LAP_MESHES = [(1, 2), (2, 1), (2, 2), (3, 5)]

_PALLAS = {}


def _pallas(x, sb_x, sb_y, fwd):
    key = (x.shape, sb_x, sb_y, fwd)
    if key not in _PALLAS:
        _PALLAS[key] = np.asarray(lap_frame_pallas(
            jnp.asarray(x), sb_x=sb_x, sb_y=sb_y, forward=fwd,
            interpret=True))
    return _PALLAS[key]


def _lap_tiles(sp, sb_x, sb_y, fwd):
    return sp.replace([lap_kernels.lap_tile(t.data, sb_x, sb_y, fwd, t)
                       for t in sp.tiles]).gather()


@pytest.mark.parametrize("h,w,sb_x,sb_y", LAP_PLANES)
@pytest.mark.parametrize("mesh", LAP_MESHES)
def test_lap_on_tiles_matches_the_plane_and_pallas(h, w, sb_x, sb_y, mesh):
    """Each tile, cut on superblocks with a halo of 2 where it has a
    neighbour, filtered from its origin and cropped: the plane's filter
    (plain version) and JAX's lap_frame_pallas (interpret mode), forward
    and inverse, at int32 extremes too."""
    rng = np.random.default_rng(h + w)
    x = rng.integers(-2**31, 2**31, (h, w), dtype=np.int64).astype(np.int32)
    x[::3] = rng.integers(-2**14, 2**14, (h, w))[::3]
    sp = put(x, Sharding(_mesh(*mesh), ("dp", "sp")), halo=2,
             unit=(sb_y, sb_x))
    for fwd in (True, False):
        plane = lap_kernels.lap_frame(torch.from_numpy(x), sb_x, sb_y, fwd)
        np.testing.assert_array_equal(plane.numpy(),
                                      _pallas(x, sb_x, sb_y, fwd))
        np.testing.assert_array_equal(_lap_tiles(sp, sb_x, sb_y, fwd),
                                      plane.numpy())


def test_lap_tile_checks_and_partial_bands():
    """An odd origin is refused; a band the tensor holds only in part is
    not filtered; with the origin 0 and the tensor's own size the filter
    is the plane's."""
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -2**14, 2**14, (128, 128)).astype(np.int32))
    with pytest.raises(ValueError):
        lap_kernels.lap_frame(x, 64, 64, True, origin=(1, 0), plane=(256, 256))
    assert lap_kernels._starts(128, 64, 0, 256) == [62]
    assert lap_kernels._starts(128, 64, 64, 256) == [126 - 64]
    assert lap_kernels._starts(66, 64, 60, 256) == [2]
    assert lap_kernels._starts(64, 64, 63, 256) == []   # 62..65 in part
    assert torch.equal(
        lap_kernels.lap_frame(x, 64, 64, True, origin=(0, 0),
                              plane=(128, 128)),
        lap_kernels.lap_frame(x, 64, 64, True))


def test_dct_refuses_a_tile_off_its_grid():
    x = torch.zeros((64, 64), dtype=torch.int32)
    dct_kernels.dct_frame(x, 32, True, origin=(64, 32))
    with pytest.raises(ValueError, match="grid"):
        dct_kernels.dct_frame(x, 32, True, origin=(64, 16))


# -- the sharded models against JAX's unsharded functions -------------------

MODEL_MESHES = [((1, 2), (None, "sp")), ((2, 2), ("dp", "sp")),
                ((3, 1), ("dp", None))]


def _jax_masks(m):
    return tuple({k: jnp.asarray(v) for k, v in m[key].items()}
                 for key in ("split_h", "split_v", "merge", "leaf"))


@pytest.fixture(scope="module")
def frame():
    """A 256 x 192 frame (4 x 3 superblocks) with a random block-size
    map, its planes, OBMC prediction planes and leaf coefficients from a
    seed, and their unsharded analysis and synthesis: JAX's of the luma
    plane (its compiles dominate this file's time), the port's of every
    plane and its RDO pyramids (tests/test_torch_analysis.py and
    test_torch_synthesis.py hold those to JAX's)."""
    info, state = _setup(256, 192, 21)
    planes = _planes(info, state, 22)
    mc = _planes(info, state, 23)
    rng = np.random.default_rng(31)
    d = [rng.integers(-3000, 3000, p.shape).astype(np.int32) for p in planes]
    jmasks = _jax_masks(JKF.build_analysis_masks(state, info, 0))
    jd, jmd = JKF.inter_analysis_plane(
        jnp.asarray(planes[0]), jnp.asarray(mc[0]), jmasks,
        pic_w=info.pic_width, pic_h=info.pic_height)
    jax_luma = {
        "kf": np.asarray(JKF.keyframe_analysis_plane(jnp.asarray(planes[0]),
                                                     jmasks)),
        "inter": (np.asarray(jd), np.asarray(jmd)),
        "synth": np.asarray(JS.synthesis_plane(jnp.asarray(d[0]), jmasks))}
    port = {"kf": TKF.analyze_keyframe(state, info, planes, False,
                                       "cpu")[-1](),
            "inter": TKF.analyze_inter(state, info, planes, mc, False,
                                       "cpu")[-1](),
            "synth": TS.synthesize_frame(state, info, d, "cpu"),
            "rdo_kf": TKF.analyze_rdo_pyramid(state, info, planes, None,
                                              False, "cpu"),
            "rdo_inter": TKF.analyze_rdo_pyramid(state, info, planes,
                                                 [mc[0]], False, "cpu")}
    # The port's unsharded luma is JAX's.
    np.testing.assert_array_equal(port["kf"][0], jax_luma["kf"])
    np.testing.assert_array_equal(port["inter"][0][0], jax_luma["inter"][0])
    np.testing.assert_array_equal(port["inter"][1][0], jax_luma["inter"][1])
    np.testing.assert_array_equal(port["synth"][0], jax_luma["synth"])
    return info, state, planes, mc, d, jax_luma, port


@pytest.mark.parametrize("mesh,spec", MODEL_MESHES)
def test_sharded_analysis_matches_jax(frame, mesh, spec):
    """analyze_keyframe, analyze_inter and analyze_rdo_pyramid with the
    hook: ShardedPlanes whose gathered planes are JAX's unsharded
    keyframe_analysis_plane's and inter_analysis_plane's (luma), and the
    port's unsharded planes (every plane) and RDO pyramids."""
    info, state, planes, mc, _, jax_luma, port = frame
    hook = named_put(_mesh(*mesh), spec)
    d_dev, fin = TKF.analyze_keyframe(state, info, planes, False, "cpu",
                                      device_put_fn=hook)
    assert all(isinstance(d, ShardedPlane) for d in d_dev)
    got = fin()
    np.testing.assert_array_equal(got[0], jax_luma["kf"])
    for g, w in zip(got, port["kf"]):
        np.testing.assert_array_equal(g, w)
    _, _, fin = TKF.analyze_inter(state, info, planes, mc, False, "cpu",
                                  device_put_fn=hook)
    ds, mds = fin()
    np.testing.assert_array_equal(ds[0], jax_luma["inter"][0])
    np.testing.assert_array_equal(mds[0], jax_luma["inter"][1])
    for g, w in zip(ds + mds, port["inter"][0] + port["inter"][1]):
        np.testing.assert_array_equal(g, w)
    for key, mc_pl in (("rdo_kf", None), ("rdo_inter", [mc[0]])):
        got = TKF.analyze_rdo_pyramid(state, info, planes, mc_pl, False,
                                      "cpu", device_put_fn=hook)
        for g, w in zip(got, port[key]):
            if w is None:
                assert g is None
            elif isinstance(w, dict):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            else:
                np.testing.assert_array_equal(g, w)


def test_sharded_analysis_refuses_another_device(frame):
    info, state, planes = frame[:3]
    hook = named_put(np.array([[torch.device("meta")]], dtype=object),
                     ("dp", "sp"))
    with pytest.raises(ValueError, match="device_put_fn"):
        TKF.analyze_keyframe(state, info, planes, False, "cpu",
                             device_put_fn=hook)


@pytest.mark.parametrize("mesh,spec", MODEL_MESHES)
def test_sharded_synthesis_matches_jax(frame, mesh, spec):
    """synthesize_frame with the hook on leaf coefficients from a seed:
    JAX's unsharded synthesis_plane (luma) and the port's unsharded
    synthesize_frame (every plane); the tiles' halos came from their
    neighbours."""
    info, state, _, _, d, jax_luma, port = frame
    devstats.reset()
    got = TS.synthesize_frame(state, info, d, "cpu",
                              device_put_fn=named_put(_mesh(*mesh), spec))
    np.testing.assert_array_equal(got[0], jax_luma["synth"])
    for g, w in zip(got, port["synth"]):
        np.testing.assert_array_equal(g, w)
    assert devstats.snapshot()["counts"]["halo_bytes"] > 0


@functools.lru_cache(maxsize=None)
def _fields_case(w, h, vh, vw, r):
    """The seeded inputs of one SAD-field case and JAX's unsharded fields
    of them, computed once for every mesh."""
    rng = np.random.default_rng(w + r)
    pad = 32
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    refs = [rng.integers(0, 256, (h + 2 * pad, w + 2 * pad), dtype=np.uint8)
            for _ in range(2)]
    return cur, refs, JMF.fullpel_sad_fields(cur, refs, pad, (vh, vw),
                                             h // 8, w // 8, r=r)


@pytest.mark.parametrize("mesh,spec", MODEL_MESHES + [((2, 3), ("dp", "sp"))])
@pytest.mark.parametrize("w,h,vh,vw,r", [(256, 192, 185, 250, 7),
                                         (320, 128, 128, 320, 16)])
def test_sharded_fields_match_jax(mesh, spec, w, h, vh, vw, r):
    """fullpel_sad_fields with the hook, cut by vertex windows (rows and
    columns): JAX's unsharded fields."""
    pad, (cur, refs, want) = 32, _fields_case(w, h, vh, vw, r)
    got = TMF.fullpel_sad_fields(cur, refs, pad, (vh, vw), h // 8, w // 8,
                                 r=r, device="cpu",
                                 device_put_fn=named_put(_mesh(*mesh), spec))
    for g, wnt in zip(got, want):
        assert g.dtype == np.int32 and g.shape == wnt.shape
        np.testing.assert_array_equal(g, wnt)
