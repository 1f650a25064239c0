"""The port's encoder on its Python coefficient path
(daala_tpu_torch/codec/encoder.py `_encode_coefficients` with
`use_native_frame = False`), under both device tiers on the CPU.

- The lean tier (use_device_analysis=False, use_device_pvq=True): the
  Python path replays the device decision table band by band through
  `forced_bands` (DevicePVQTable.get) and its packets equal the native
  path's, which replays the same table (frame_enc.inc
  ec_pvq_theta_forced), byte for byte: test_pvqsearch.py's case of JAX's
  package, with its mid-stream keyframe.  The native lean packets equal
  JAX's (test_torch_encoder.py, test_torch_pvqsearch.py), so the chain
  closes on JAX's.
- The analysis tier: the Python path computes its own transforms, so its
  packets equal JAX's host encoder's Python path, with and without
  B-frames.
- Lossless (quant 0, Haar frames) through the Python path round-trips
  exactly through the port's host decoder.
- DAALA_TPU_DUMP_BSIZE_DIST, which runs the Python path, writes the same
  dump as JAX's host encoder.
- The Python path runs only where the caller asks for it: without the
  native engine the native pass raises.

Every value compared is an integer or a byte, so the tolerance is zero.
"""

import numpy as np
import pytest

import content
from daala_tpu import native
from daala_tpu.codec import headers
from daala_tpu.codec.encoder import Encoder as HostEncoder
from daala_tpu_torch.codec.decoder import Decoder
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.entropy import ec as ec_mod
from daala_tpu_torch.utils import devstats
import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native engine unavailable")

TIERS = {"analysis": dict(use_device_analysis=True, use_device_pvq=False),
         "lean": dict(use_device_analysis=False, use_device_pvq=True)}


def _encode(enc, frames, keyframe_rate=None, b_frames=0):
    if keyframe_rate is not None:
        enc.keyframe_rate = keyframe_rate
    enc.b_frames = b_frames
    out = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
    return out + [bytes(p) for p in enc.flush()]


def lean_python_matches_native(device):
    """test_pvqsearch.py's test_device_pvq_native_matches_python on the
    port's lean tier on `device`: 96x64, 5 frames, quant 18, complexity
    7, a keyframe every 4 frames.  Returns the native and the Python
    path's packets and the Python run's devstats."""
    w, h, nfr, q = 96, 64, 5, 18
    frames = content.make_clip(w, h, nfr, seed=5)
    out = {}
    for native_frame in (True, False):
        enc = Encoder(headers.Info(pic_width=w, pic_height=h), quant=q,
                      complexity=7, device=device, **TIERS["lean"])
        enc.use_native_frame = native_frame
        enc.enable_encoder_check = True
        devstats.reset()
        out[native_frame] = (_encode(enc, frames, keyframe_rate=4),
                             devstats.snapshot())
    return out[True][0], out[False][0], out[False][1]


def test_lean_tier_python_path_matches_native():
    """The Python path's forced-band replay equals the native replay byte
    for byte, and it read the table (valid entries handed out)."""
    native_pk, python_pk, snap = lean_python_matches_native("cpu")
    assert snap["counts"]["forced_bands"] > 0
    assert snap["counts"]["pvq_rows"] > 0
    assert len(python_pk) == len(native_pk)
    for i, (a, b) in enumerate(zip(python_pk, native_pk)):
        assert a == b, ("forced-band replay divergence", i)


@pytest.mark.parametrize("b_frames", [0, 2])
def test_analysis_tier_python_path_matches_jax(b_frames):
    """The analysis tier on the Python path equals JAX's host encoder on
    its Python path (both at use_native_frame = False)."""
    w, h = 64, 48
    frames = content.make_clip(w, h, 3, seed=3)
    pk = {}
    for name in ("jax", "port"):
        info = headers.Info(pic_width=w, pic_height=h)
        if name == "jax":
            enc = HostEncoder(info, quant=15, complexity=7)
        else:
            enc = Encoder(info, quant=15, complexity=7, device="cpu",
                          **TIERS["analysis"])
        enc.use_native_frame = False
        pk[name] = _encode(enc, frames, b_frames=b_frames)
    assert pk["port"] == pk["jax"]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_lossless_python_path_round_trips(tier):
    """quant 0 (Haar frames, a keyframe and an inter frame) through the
    Python path: the port's host decoder returns the input exactly."""
    w, h = 64, 48
    frames = content.make_clip(w, h, 2, seed=4)
    info = headers.Info(pic_width=w, pic_height=h)
    enc = Encoder(info, quant=0, device="cpu", **TIERS[tier])
    enc.use_native_frame = False
    enc.enable_encoder_check = True
    dec = Decoder(info, use_device_synthesis=False)
    outs = [o for p in _encode(enc, frames) for o in dec.decode_packet(p)]
    assert len(outs) == len(frames)
    for got, want in zip(outs, frames):
        for pl in range(3):
            np.testing.assert_array_equal(np.asarray(got[pl]), want[pl])


def test_bsize_dist_dump_matches_jax(monkeypatch, tmp_path):
    """DAALA_TPU_DUMP_BSIZE_DIST set before the encoder is built: the
    port's dump file equals JAX's host encoder's, and so do the
    packets."""
    w, h = 64, 48
    frames = content.make_clip(w, h, 2, seed=6)
    pk, dump = {}, {}
    for name in ("jax", "port"):
        path = tmp_path / (name + ".txt")
        monkeypatch.setenv("DAALA_TPU_DUMP_BSIZE_DIST", str(path))
        info = headers.Info(pic_width=w, pic_height=h)
        if name == "jax":
            enc = HostEncoder(info, quant=20, complexity=7)
        else:
            enc = Encoder(info, quant=20, complexity=7, device="cpu")
        pk[name] = _encode(enc, frames)
        dump[name] = path.read_text()
    assert dump["port"] == dump["jax"]
    assert dump["port"].count("\n") == len(frames) + 1
    assert pk["port"] == pk["jax"]


def test_missing_native_engine_raises_in_the_lean_tier(monkeypatch):
    """use_native_frame left on with the native engine made unavailable
    (the range coder without its native handle): the lean tier raises
    rather than fall back to the Python path, as the analysis tier does
    (test_torch_encoder.py test_refuses_the_python_frame_path)."""
    monkeypatch.setattr(ec_mod, "Encoder", ec_mod.PyEncoder)
    enc = Encoder(headers.Info(pic_width=64, pic_height=48), quant=15,
                  complexity=1, device="cpu", **TIERS["lean"])
    with pytest.raises(RuntimeError, match="native engine is missing"):
        enc.encode_frame(content.make_clip(64, 48, 1, seed=2)[0])
