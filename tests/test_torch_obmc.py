"""The port's OBMC prediction (daala_tpu_torch/models/obmc.py and the
plain versions of ops/cuda/obmc_kernels.py) against the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions; those
must equal daala_tpu's XLA functions (models/obmc.py predict_leaves,
models/mesweep.py _leaf_cells_xla), the two Pallas kernels in interpret
mode, and the host predictor (codec/mc.py mc_predict_frame), on 8-bit
and 12-bit planes and all 16 blend setups (oc, s).  Every output is an
integer; the tolerance is zero.  The CUDA kernels themselves run only on
a card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import (PaddedImage, random_grid, random_leaves,
                        random_refs)
from daala_tpu.codec import headers
from daala_tpu.codec import mc as MC
from daala_tpu.models import mesweep as JMS
from daala_tpu.models import obmc as JOB
from daala_tpu.ops.pallas.obmc_kernels import (obmc_blend_pallas,
                                               obmc_leaf_cells_pallas)
from daala_tpu_torch.models import obmc as OB
from daala_tpu_torch.ops.cuda import obmc_kernels as OK
import torch_threads

torch_threads.share_cores()

PAD = 64
PLANE = (128 + 2 * PAD, 192 + 2 * PAD)  # a padded 192x128 luma plane


def _planes(seed, hi):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4096 if hi else 256, (4,) + PLANE).astype(
        np.uint16 if hi else np.uint8)


def _leaves(seed, log_x, log_y, count=32):
    return random_leaves(np.random.default_rng(seed), log_x, log_y, PLANE,
                         PAD, count)


@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("log_x,log_y", [(2, 2), (3, 3), (4, 4), (5, 5),
                                         (6, 6), (4, 3)])
def test_predict_leaves_matches_jax(log_x, log_y, hi):
    """Plain predict_leaves == daala_tpu.models.obmc.predict_leaves."""
    p4 = _planes(log_x + 7 * log_y, hi)
    leaves = _leaves(log_x * 10 + log_y, log_x, log_y)
    got = OB.predict_leaves(torch.from_numpy(p4), *leaves, log_x, log_y,
                            PAD)
    want = JOB.predict_leaves(jnp.asarray(p4),
                              *[jnp.asarray(a) for a in leaves],
                              log_x=log_x, log_y=log_y, pad=PAD, hi=hi)
    assert got.dtype == (torch.uint16 if hi else torch.uint8)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("n", [8, 16])
def test_blend_matches_pallas(n, hi):
    """Plain obmc_blend == obmc_blend_pallas (interpret mode)."""
    log_n = n.bit_length() - 1
    p4 = _planes(n + hi, hi)
    leaves = _leaves(n, log_n, log_n, count=16)
    scal = OK.leaf_args(*leaves, PAD, log_n, log_n, PLANE)
    got = OK.obmc_blend_plain(torch.from_numpy(p4), torch.from_numpy(scal),
                              log_n, log_n)
    pscal, taps = JOB.pallas_leaf_args(*leaves, PAD)
    want = obmc_blend_pallas(
        jnp.asarray(JOB.stage_planes_i32(p4)), jnp.asarray(JOB.wtab64(log_n)),
        jnp.asarray(taps), jnp.asarray(pscal), n=n, hi=hi, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_leaf_cells_match_jax(n):
    """Plain obmc_leaf_cells == _leaf_cells_xla over JAX's
    predict_leaves, with a ragged visible area; at n = 8 and 16 also
    == obmc_leaf_cells_pallas (interpret mode)."""
    log_n = n.bit_length() - 1
    vh, vw = PLANE[0] - 2 * PAD - 11, PLANE[1] - 2 * PAD - 21
    rng = np.random.default_rng(n)
    p4 = _planes(n, False)
    cur = rng.integers(0, 256, (vh, vw)).astype(np.uint8)
    leaves = _leaves(n + 1, log_n, log_n, count=24)
    scal = OK.leaf_args(*leaves, PAD, log_n, log_n, PLANE)
    got = OK.obmc_leaf_cells(torch.from_numpy(p4), torch.from_numpy(cur),
                             torch.from_numpy(scal), log_n).numpy()
    blocks = JOB.predict_leaves(jnp.asarray(p4),
                                *[jnp.asarray(a) for a in leaves],
                                log_x=log_n, log_y=log_n, pad=PAD)
    want = JMS._leaf_cells_xla(blocks, jnp.asarray(cur),
                               jnp.asarray(leaves[0]), n=n, vh=vh, vw=vw)
    assert got.shape == (len(leaves[0]), n // 8, n // 8)
    assert np.array_equal(got, np.asarray(want))
    assert got.sum() > 0
    if n <= 16:
        # JAX's SweepState staging of the current plane for the kernel.
        c32 = np.zeros((((vh + 7) & ~7) + 64, ((vw + 7) & ~7) + 384),
                       np.int32)
        c32[:vh, :vw] = cur
        pscal, taps = JOB.pallas_leaf_args(*leaves, PAD)
        pal = obmc_leaf_cells_pallas(
            jnp.asarray(JOB.stage_planes_i32(p4)), jnp.asarray(c32),
            jnp.asarray(JOB.wtab64(log_n)), jnp.asarray(taps),
            jnp.asarray(pscal), n=n, vh=vh, vw=vw, interpret=True)
        assert np.array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("bframe", [False, True])
@pytest.mark.parametrize("hi", [False, True])
def test_frame_plane_matches_host(bframe, hi):
    """predict_frame_plane_device(device='cpu') == the host
    mc_predict_frame on tests/test_obmc_device.py's cases, all planes."""
    info = headers.Info(pic_width=192, pic_height=128,
                        bitdepth_mode=2 if hi else 1,
                        full_precision_references=1 if hi else 0)
    rng = np.random.default_rng(9 + int(bframe) + 2 * int(hi))
    refs = random_refs(info, rng, hi)
    ref_imgi = [0, 1, 1, 0] if not bframe else [0, 0, 1, 0]
    g = random_grid(info, rng, bframe=bframe)
    dst = PaddedImage(info, lambda s: np.zeros(s, np.uint16 if hi
                                               else np.uint8))
    MC.mc_predict_frame(g, refs, ref_imgi, info, dst)
    for pli in range(info.nplanes):
        got = OB.predict_frame_plane_device(g, refs, ref_imgi, info, pli,
                                            "cpu")
        assert got.dtype == (np.uint16 if hi else np.uint8)
        assert np.array_equal(got, dst.plane_view(pli)), pli


def test_leaf_classes_match_jax():
    """The copied mesh walk gives JAX's leaf lists."""
    info = headers.Info(pic_width=192, pic_height=128)
    g = random_grid(info, np.random.default_rng(4), bframe=True)
    for pli in range(info.nplanes):
        got = OB.build_leaf_lists(g, info, pli)
        want = JOB.build_leaf_lists(g, info, pli)
        assert sorted(got) == sorted(want) and len(got) == 4
        for lms in want:
            for key in ("pos", "srcs", "mvs", "ocs", "ss"):
                assert np.array_equal(got[lms][key], want[lms][key])


def test_out_of_bounds_window_raises():
    """A window past the plane's edge raises instead of being clamped
    (JAX's gather would clamp it)."""
    pos, srcs, mvs, ocs, ss = _leaves(3, 4, 4, count=4)
    mvs[2, 1, 1] = -8 * (PAD + int(pos[2, 0])) - 8  # 3 rows above the top
    with pytest.raises(ValueError, match="leaf 2"):
        OB.predict_leaves(torch.from_numpy(_planes(3, False)), pos, srcs,
                          mvs, ocs, ss, 4, 4, PAD)
    mvs[2, 1, 1] = 0
    srcs[1, 0] = 4
    with pytest.raises(ValueError, match="leaf 1"):
        OK.leaf_args(pos, srcs, mvs, ocs, ss, PAD, 4, 4, PLANE)


def test_kernel_entries_refuse_cpu_tensors():
    """The CUDA entries never run a plain version: a CPU tensor raises
    before any build."""
    log_n = 4
    leaves = _leaves(5, log_n, log_n, count=4)
    p4 = torch.from_numpy(_planes(5, False))
    scal = torch.from_numpy(OK.leaf_args(*leaves, PAD, log_n, log_n, PLANE))
    with pytest.raises(ValueError, match="CUDA"):
        OK.obmc_blend_cuda(p4, scal, log_n, log_n)
    with pytest.raises(ValueError, match="CUDA"):
        OK.obmc_leaf_cells_cuda(p4, p4[0], scal, log_n)
    with pytest.raises(ValueError, match="uint8"):
        OK.obmc_leaf_cells(p4.to(torch.int32), p4[0], scal, log_n)
