"""The port's device decode back end (daala_tpu_torch/models/synthesis.py
and the decoder's use_device_synthesis seam) against the JAX package's.

- synthesis_plane against JAX's on the `d` planes and block-size maps
  of a real decode (a keyframe and an inter frame, every plane);
- the port's Decoder(info, device="cpu", use_device_synthesis=True)
  against JAX's Decoder with use_device_synthesis = True and against
  the port's host Decoder, on tests/test_device_synthesis.py's five
  cases (intra, inter, 4:4:4, an odd size, and a lossless Haar clip
  that stays on the host), through the native and the Python
  (use_native_frame = False) frame paths.

Every output is an integer plane; the tolerance is zero.  JAX runs on
the CPU, as tests/test_device_synthesis.py runs it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daala_tpu import native
from daala_tpu.codec import headers as JH
from daala_tpu.codec.decoder import Decoder as JaxDecoder
from daala_tpu.models import keyframe as JKF
from daala_tpu.models import synthesis as JS
from daala_tpu_torch.codec import headers
from daala_tpu_torch.codec.decoder import Decoder
from daala_tpu_torch.models import keyframe as TKF
from daala_tpu_torch.models import synthesis as S
from daala_tpu_torch.utils import devstats

from test_device_synthesis import CASES
from test_frame_native import _clip, _encode

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native engine unavailable")

CPU = torch.device("cpu")


def _info(mod, w, h, dec420):
    if dec420:
        return mod.Info(pic_width=w, pic_height=h)
    return mod.Info(pic_width=w, pic_height=h,
                    plane_dec=((0, 0), (0, 0), (0, 0), (0, 0)))


def _decode(dec, pkts, native_frame):
    dec.use_native_frame = native_frame
    return [o for p in pkts for o in dec.decode_packet(p)]


_PACKETS = {}


def _packets(name, kw, w, h, n, kfr, dec420):
    if name not in _PACKETS:
        _PACKETS[name] = _encode(True, _clip(w, h, n, dec420=dec420), w, h,
                                 kfr=kfr, dec420=dec420, **kw)
    return _PACKETS[name]


@pytest.mark.parametrize("native_frame", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("name,kw,w,h,n,kfr,dec420", CASES,
                         ids=[c[0] for c in CASES])
def test_decoder_matches_jax_and_host(name, kw, w, h, n, kfr, dec420,
                                      native_frame):
    pkts = _packets(name, kw, w, h, n, kfr, dec420)
    port = _decode(Decoder(_info(headers, w, h, dec420), device="cpu",
                           use_device_synthesis=True), pkts, native_frame)
    jdec = JaxDecoder(_info(JH, w, h, dec420))
    jdec.use_device_synthesis = True
    jax_out = _decode(jdec, pkts, native_frame)
    host = _decode(Decoder(_info(headers, w, h, dec420),
                           use_device_synthesis=False), pkts, True)
    assert len(port) == len(jax_out) == len(host) == n
    for i, (a, b, c) in enumerate(zip(port, jax_out, host)):
        for pli in range(3):
            np.testing.assert_array_equal(a[pli], b[pli], err_msg=str(i))
            np.testing.assert_array_equal(a[pli], c[pli], err_msg=str(i))


@pytest.fixture(scope="module")
def decoded_state():
    """(info, [(is_keyframe, per plane (masks, d))]) of every frame of
    the inter case's clip, captured where JAX's decoder calls
    synthesize_frame."""
    name, kw, w, h, n, kfr, dec420 = next(c for c in CASES
                                          if c[0] == "inter")
    pkts = _packets(name, kw, w, h, n, kfr, dec420)
    info = JH.Info(pic_width=w, pic_height=h)
    dec = JaxDecoder(info)
    dec.use_device_synthesis = True
    frames = []
    real = JS.synthesize_frame

    def capture(state, info, d_planes, device_put_fn=None):
        frames.append((state.frame_type == 0, [
            (JKF.build_analysis_masks(state, info, pli),
             np.array(d_planes[pli], np.int32))
            for pli in range(info.nplanes)]))
        return real(state, info, d_planes, device_put_fn=device_put_fn)

    JS.synthesize_frame = capture
    try:
        _decode(dec, pkts, True)
    finally:
        JS.synthesize_frame = real
    assert [f[0] for f in frames] == [True] + [False] * (n - 1)
    return info, frames


@pytest.mark.parametrize("frame,use_pallas", [("keyframe", False),
                                              ("inter", False),
                                              ("inter", True)])
def test_synthesis_plane_matches_jax(decoded_state, frame, use_pallas):
    """Each plane of the keyframe and of the first inter frame; once with
    the JAX side's frame postfilter through its Pallas lap kernel in
    interpret mode."""
    info, frames = decoded_state
    _, planes = frames[0 if frame == "keyframe" else 1]
    for pli, (masks, d) in enumerate(planes):
        xdec, ydec = info.plane_dec[pli]
        got = S.synthesis_plane(torch.from_numpy(d),
                                TKF._mask_tensors(masks, CPU), xdec=xdec,
                                ydec=ydec)
        want = JS.synthesis_plane(
            jnp.asarray(d), tuple({k: jnp.asarray(v) for k, v in
                                   masks[key].items()}
                                  for key in ("split_h", "split_v", "merge",
                                              "leaf")),
            xdec=xdec, ydec=ydec, use_pallas=use_pallas)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_split_postfilter_inverts_the_prefilter():
    """On random masks at every node size, the split postfilter undoes
    the analysis front end's split prefilter exactly."""
    rng = np.random.default_rng(4)
    c = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, (128, 192))
                         .astype(np.int32))
    for n in (8, 16, 32, 64):
        hm = torch.from_numpy(rng.random((128 // n, 192 // n)) < 0.5)
        vm = torch.from_numpy(rng.random((128 // n, 192 // n)) < 0.5)
        pre = TKF._masked_split_filter(c, hm, vm, n)
        assert not torch.equal(pre, c)
        assert torch.equal(S._masked_split_postfilter(pre, hm, vm, n), c)


def test_synthesize_frame_counts_its_work():
    """One dispatch per plane inside the synthesize_frame span; no
    host<->device bytes on the CPU; the planes come back writable."""
    from daala_tpu_torch.codec.state import CodecState
    info = headers.Info(pic_width=128, pic_height=64)
    state = CodecState(info)
    state.init_superblock_split(2)
    rng = np.random.default_rng(6)
    d = [rng.integers(-500, 500, (64 >> yd, 128 >> xd)).astype(np.int32)
         for xd, yd in info.plane_dec[:3]]
    devstats.reset()
    out = S.synthesize_frame(state, info, d, "cpu")
    snap = devstats.snapshot()
    assert list(snap["spans_s"]) == ["synthesize_frame"]
    assert snap["dispatches"] == 3
    assert snap["h2d_bytes"] == snap["d2h_bytes"] == 0
    assert [o.shape for o in out] == [x.shape for x in d]
    assert all(o.dtype == np.int32 and o.flags.writeable for o in out)


def test_decoder_device_is_explicit():
    """The device back end on the card by default; the CPU and the host
    decoder only where the caller asks for them."""
    info = headers.Info(pic_width=64, pic_height=64)
    with pytest.raises(ValueError):
        # a device the host decoder ignores
        Decoder(info, device="cpu", use_device_synthesis=False)
    host = Decoder(info, use_device_synthesis=False)
    assert host.device is None and not host.use_device_synthesis
    assert Decoder(info, device="cpu").device == CPU
    assert Decoder(info, device="cpu",
                   use_device_synthesis=True).device == CPU
    if not torch.cuda.is_available():
        for kw in ({}, {"device": "cuda"}, {"use_device_synthesis": True}):
            with pytest.raises(RuntimeError):
                Decoder(info, **kw)
    else:
        assert Decoder(info).device.type == "cuda"
