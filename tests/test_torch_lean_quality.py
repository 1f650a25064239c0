"""The port's lean tier against JAX's on the quality sweep's smooth clip.

The sweep's device_pvq point (tools/sweep_quality.py: 320x192, the
smooth class, seed 0, complexity 7, keyframe_rate 256) through JAX's
Encoder with use_device_analysis and use_device_pvq, and through the
port's utils/sweep_quality.encode_clip with the same keywords on the
CPU: the data packets must be equal, byte for byte.  The keyframe is
enough to show it at quant 8 (2,348 bytes in JAX, 2,347 in the port
before `_rsqrt` and `_fma32` in models/pvqsearch.py): where JAX's three
`1 / sqrt` and its phase-2 score are not computed as XLA:CPU computes
them, the pulse search places a pulse of two rows in another lane.  One
frame keeps JAX's compiles to the keyframe's programs (about 50 s cold);
the inter frames' tables are held to JAX's in test_torch_pvqsearch.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daala_tpu.codec import headers as JH
from daala_tpu.codec.encoder import Encoder as JaxEncoder
from daala_tpu_torch import native
from daala_tpu_torch.models import pvqsearch as PS
from daala_tpu_torch.utils import sweep_quality as SQ
import torch_threads

torch_threads.share_cores()

W, H, NFRAMES = 320, 192, 1
LEAN = {"use_device_analysis": True, "use_device_pvq": True}


def _jax_packets(frames, quant):
    enc = JaxEncoder(JH.Info(pic_width=W, pic_height=H), quant=quant,
                     complexity=7)
    enc.keyframe_rate = 256
    for key, value in LEAN.items():
        setattr(enc, key, value)
    pkts = list(enc.flush_headers())
    for fr in frames:
        pkts += enc.encode_frame(fr)
    pkts += enc.flush()
    return [bytes(p) for p in pkts[3:]]


@pytest.mark.skipif(native.get_lib() is None,
                    reason="native engine unavailable")
@pytest.mark.parametrize("quant", [8, 25])
def test_lean_tier_packets_equal_jax(quant):
    frames = SQ.make_smooth_clip(W, H, NFRAMES, seed=0)
    want = _jax_packets(frames, quant)
    got, _ = SQ.encode_clip(frames, W, H, quant, LEAN, device="cpu")
    assert len(got) == len(want) == NFRAMES
    assert [len(p) for p in got] == [len(p) for p in want]
    assert got == want
    assert np.sum([len(p) for p in got]) > 0


def test_rsqrt_is_xla_s():
    """PS._rsqrt equals JAX's `1.0 / jnp.sqrt(x)` under jit on the CPU bit
    for bit (XLA:CPU's rsqrt: the x86 rsqrtps estimate and two Newton
    steps) on every integer to 2^16, on floats over 17 decades and on 0,
    and differs from the correctly rounded value somewhere."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.arange(1, 1 << 16), [0.0, 1e-30, 2.0 ** 31],
        rng.uniform(1, 2, 50000) * 10.0 ** rng.uniform(-5, 12, 50000),
    ]).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: 1.0 / jnp.sqrt(a))(jnp.asarray(x)))
    got = PS._rsqrt(torch.from_numpy(x.copy())).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    pos = x > 0
    exact = (1.0 / np.sqrt(x[pos].astype(np.float64))).astype(np.float32)
    assert (got[pos] != exact).mean() > 0.05
    assert got[~pos].tolist() == [np.inf]


def test_fma32_rounds_once():
    """PS._fma32(a, b, c) is a * b + c rounded once: where a * b alone
    rounds away the low bits, it keeps them (a = b = 1 + 2^-12, c =
    -1 - 2^-11: the exact value 2^-24 survives)."""
    a = torch.tensor([1 + 2.0 ** -12], dtype=torch.float32)
    c = torch.tensor([-1 - 2.0 ** -11], dtype=torch.float32)
    assert PS._fma32(a, a, c).item() == 2.0 ** -24
    assert (a * a + c).item() == 0.0
