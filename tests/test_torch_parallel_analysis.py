"""The port's uniform-quantizer pipeline (daala_tpu_torch/models/
analysis.py: coeff_to_u8, split_filter, split_unfilter, fdct_frame,
idct_frame, analysis_transform, synthesis_transform, encode_step)
against the JAX package's (daala_tpu/models/analysis.py), on the same
planes made from a numpy seed.

JAX's functions run jitted at bs <= 2 and op by op under
jax.disable_jit() at bs >= 3, where its n = 32 and n = 64 programs take
8-34 s each to compile (its integer arithmetic is the same either way;
op by op, the many small band shapes of bs <= 2 cost more than the
compile).  Every value compared is an integer; the tolerance is zero.
(The parallel tests are split over two files so that each stays well
inside one test worker's share of the clock.)
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daala_tpu.models import analysis as JA
from daala_tpu_torch.models import analysis as TA

SHAPES = [(128, 128), (192, 256)]
CASES = [(h, w, bs) for h, w in SHAPES for bs in range(5)
         if h % (4 << bs) == 0 and w % (4 << bs) == 0]


def _frame(h, w, seed):
    """Smooth content plus noise, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    v = (128 + 60 * np.sin(xx / 7.0) + 40 * np.cos(yy / 11.0)
         + rng.normal(0, 20, (h, w)))
    return v.clip(0, 255).astype(np.uint8)


def _jax(level, fn, *args, **static):
    """JAX's fn(*args, **static) for block size 4 << level: jitted at
    level <= 2, op by op above."""
    if level >= 3:
        with jax.disable_jit():
            return fn(*args, **static)
    return jax.jit(functools.partial(fn, **static))(*args)


def _jax_pipeline(f, bs, quant):
    """Every stage of JAX's pipeline on frame f, in one program: the
    prefiltered coefficients, split_filter, fdct_frame, idct_frame of
    that, split_unfilter of that; analysis_transform, its
    synthesis_transform; encode_step."""
    c = JA.prefilter_frame(JA.lift_to_coeff(f))
    s = JA.split_filter(c, 4, bs)
    d = JA.fdct_frame(s, bs)
    back = JA.idct_frame(d, bs)
    d_an = JA.analysis_transform(f, bs=bs)
    return dict(c=c, s=s, d=d, back=back,
                un=JA.split_unfilter(back, bs), d_an=d_an,
                syn=JA.synthesis_transform(d_an, bs=bs),
                step=JA.encode_step(f, bs=bs, quant=quant))


def _eq(port, jax_out):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_out))


@pytest.mark.parametrize("h,w,bs", CASES)
def test_pipeline_matches_jax(h, w, bs):
    """The helpers stage by stage (split_filter, fdct_frame, idct_frame,
    split_unfilter, each inverse restoring its input), then
    analysis_transform, synthesis_transform and encode_step (at a
    quantizer that keeps some coefficients and zeroes others)."""
    f = _frame(h, w, bs)
    quant = 1200 << bs
    want = _jax(bs, _jax_pipeline, jnp.asarray(f), bs=bs, quant=quant)
    tf = torch.from_numpy(f)
    c = TA.prefilter_frame(TA.lift_to_coeff(tf))
    _eq(c, want["c"])
    s = TA.split_filter(c, 4, bs)
    _eq(s, want["s"])
    d = TA.fdct_frame(s, bs)
    _eq(d, want["d"])
    back = TA.idct_frame(d, bs)
    _eq(back, want["back"])
    torch.testing.assert_close(back, s, rtol=0, atol=0)
    un = TA.split_unfilter(back, bs)
    _eq(un, want["un"])
    torch.testing.assert_close(un, c, rtol=0, atol=0)
    d_an = TA.analysis_transform(tf, bs=bs)
    _eq(d_an, want["d_an"])
    _eq(TA.synthesis_transform(d_an, bs=bs), want["syn"])
    rec, sse, nz = TA.encode_step(tf, bs=bs, quant=quant)
    jrec, jsse, jnz = want["step"]
    assert rec.dtype == torch.uint8 and sse.dtype == nz.dtype == torch.int32
    _eq(rec, jrec)
    assert (int(sse), int(nz)) == (int(jsse), int(jnz))
    assert 0 < int(nz) < h * w


def test_split_filter_at_the_far_edge_matches_jax():
    """A plane whose sides are not multiples of the block sizes: the
    last bands run past it, and JAX reads its last line again and drops
    the writes beyond it."""
    rng = np.random.default_rng(3)
    c = rng.integers(-(1 << 14), 1 << 14, (120, 136)).astype(np.int32)
    for bs in (0, 1):
        s = TA.split_filter(torch.from_numpy(c), 4, bs)
        _eq(s, _jax(bs, JA.split_filter, jnp.asarray(c), bs_from=4,
                    bs_to=bs))
        _eq(TA.split_unfilter(s, bs), _jax(bs, JA.split_unfilter,
                                           jnp.asarray(s.numpy()), bs_to=bs))


def test_coeff_to_u8_at_int32_extremes():
    """The rounding offset wraps at the top of int32, as in JAX."""
    lim = np.iinfo(np.int32)
    v = np.array([lim.max, lim.max - 7, lim.max - 8, lim.min, lim.min + 8,
                  -1, 0, 7, 8, -(128 << 4) - 9, -(128 << 4) - 8,
                  (127 << 4) + 7, (127 << 4) + 8, 1 << 20, -(1 << 20)],
                 np.int32)
    v = np.concatenate([v, np.random.default_rng(0).integers(
        lim.min, lim.max, 4000, dtype=np.int64).astype(np.int32)])
    got = TA.coeff_to_u8(torch.from_numpy(v))
    assert got.dtype == torch.uint8
    _eq(got, JA.coeff_to_u8(jnp.asarray(v)))
