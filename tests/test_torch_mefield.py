"""The port's full-pel SAD fields (daala_tpu_torch/models/mefield.py)
against the JAX package and the direct window SADs, and the encoder
that reads them.

Every value compared is an integer, so the tolerance is zero: the fields
equal JAX's and the direct SADs of test_mefield.py, and the plain version
of the fields' kernel (ops/cuda/sad_kernels.py) equals JAX's
_fullpel_fields; the port's Encoder
(device "cpu", its analysis tier on, so the fields are on) gives packets
byte-identical to daala_tpu's host encoder, which has no fields; and a
perturbed field changes the packets, so the native motion search really
reads them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daala_tpu import native
from daala_tpu.codec import headers
from daala_tpu.codec import mc as MC
from daala_tpu.codec.encoder import Encoder as HostEncoder
from daala_tpu.models import mefield as JMF
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.models import mefield as MF
from daala_tpu_torch.ops.cuda import sad_kernels as SK
from daala_tpu_torch.utils import devstats
from test_mefield import _win_sad_ref
import torch_threads

torch_threads.share_cores()

PAD = MC.OD_BUFFER_PADDING


def _planes(w, h, seed, nrefs=2):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    refs = [rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD), dtype=np.uint8)
            for _ in range(nrefs)]
    return cur, refs


# (frame w, h, visible h, w, search radius)
CASES = [(192, 128, 115, 177, 16), (192, 128, 128, 192, 16),
         (128, 64, 64, 128, 4), (256, 192, 185, 250, 7)]


@pytest.mark.parametrize("w,h,vh,vw,r", CASES)
def test_fields_match_jax(w, h, vh, vw, r):
    cur, refs = _planes(w, h, w + r)
    want = JMF.fullpel_sad_fields(cur, refs, PAD, (vh, vw), h // 8, w // 8,
                                  r=r)
    got = MF.fullpel_sad_fields(cur, refs, PAD, (vh, vw), h // 8, w // 8,
                                r=r, device="cpu")
    assert len(got) == len(want) == len(refs)
    for g, wnt in zip(got, want):
        assert g.dtype == np.int32 and g.shape == wnt.shape
        np.testing.assert_array_equal(g, wnt)


@pytest.mark.parametrize("w,h,vh,vw,r", CASES)
def test_sad_fields_plain_matches_jax(w, h, vh, vw, r):
    """The kernel's plain version (ops/cuda/sad_kernels.py) on the
    visible current plane and its reference window, its cells at the
    margins fullpel_sad_fields gives them, against JAX's _fullpel_fields
    on the same planes."""
    cur, refs = _planes(w, h, 2 * w + r, 1)
    cur_vis = np.ascontiguousarray(cur[:vh, :vw])
    win = np.ascontiguousarray(refs[0][PAD - r:PAD + vh + r,
                                       PAD - r:PAD + vw + r])
    nvb, nhb = h // 64 + 1, w // 64 + 1
    want = np.asarray(JMF._fullpel_fields(jnp.asarray(cur_vis),
                                          jnp.asarray(win), r=r, nvb=nvb,
                                          nhb=nhb))
    got = SK.sad_fields_plain(torch.from_numpy(cur_vis),
                              torch.from_numpy(win), r, nvb, nhb,
                              MF._margin(nvb, -(-vh // 8)),
                              MF._margin(nhb, -(-vw // 8)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sad_fields_wrapper_checks_and_devices():
    """sad_fields runs the plain version on the CPU; it raises on a
    device other than a card or the CPU, on a reference window of the
    wrong size, and on cells that leave the windows' grid."""
    cur, refs = _planes(128, 64, 9, 1)
    r = 4
    c = torch.from_numpy(np.ascontiguousarray(cur[:60, :100]))
    win = torch.from_numpy(np.ascontiguousarray(
        refs[0][PAD - r:PAD + 60 + r, PAD - r:PAD + 100 + r]))
    assert torch.equal(SK.sad_fields(c, win, r, 2, 3, 4, 4),
                       SK.sad_fields_plain(c, win, r, 2, 3, 4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        SK.sad_fields(c.to("meta"), win.to("meta"), r, 2, 3, 4, 4)
    with pytest.raises(ValueError, match="reference window"):
        SK.sad_fields(c, win[1:], r, 2, 3, 4, 4)
    with pytest.raises(ValueError, match="leave"):
        SK.sad_fields(c, win, r, 2, 3, 4, 12)


def test_fields_match_direct():
    """test_mefield.py's direct host window SADs, at the corner, edge
    and inner vertices and the extreme offsets."""
    w, h, vis, r = 192, 128, (115, 177), 16
    cur, refs = _planes(w, h, 3, 1)
    t = MF.fullpel_sad_fields(cur, refs, PAD, vis, h // 8, w // 8, r=r,
                              device="cpu")[0]
    nvb, nhb = h // 64 + 1, w // 64 + 1
    assert t.shape == ((2 * r + 1) ** 2, nvb, nhb)
    for vyi in range(nvb):
        for vxi in range(nhb):
            for dy, dx in [(-r, -r), (0, 0), (r, r), (-3, 7), (11, -16),
                           (r, -r)]:
                want = _win_sad_ref(cur, refs[0], PAD, vis, 64 * vyi,
                                    64 * vxi, dy, dx)
                got = int(t[(dy + r) * (2 * r + 1) + dx + r, vyi, vxi])
                assert got == want, (vyi, vxi, dy, dx)


def test_fields_count_their_traffic():
    """uint8 planes up (the current picture and each reference window),
    int32 fields down; one dispatch per reference; all in the span."""
    w, h, vis, r = 128, 64, (64, 128), 4
    cur, refs = _planes(w, h, 5)
    devstats.reset()
    MF.fullpel_sad_fields(cur, refs, PAD, vis, h // 8, w // 8, r=r,
                          device="cpu")
    snap = devstats.snapshot()
    assert snap["dispatches"] == len(refs)
    assert snap["spans_s"]["fullpel_sad_fields"] > 0
    # A CPU run moves nothing across a bus.
    assert snap["h2d_bytes"] == snap["d2h_bytes"] == 0


def _clip(w, h, n):
    """test_mefield.py's encode clip: a moving pattern with noise."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (128 + 60 * np.sin((xx + 4 * t) / 9.0)
             + 30 * np.cos((yy - 3 * t) / 7.0)
             + rng.normal(0, 5, (h, w))).clip(0, 255).astype(np.uint8)
        cb = (128 + 20 * np.sin((xx[::2, ::2] + t) / 13.0)) \
            .clip(0, 255).astype(np.uint8)
        frames.append([y, cb, cb.copy()])
    return frames


def _encode(enc, frames):
    enc.keyframe_rate = 8
    out = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
    return out + [bytes(p) for p in enc.flush()]


@pytest.mark.skipif(native.get_lib() is None,
                    reason="native engine unavailable")
def test_encoder_with_fields_matches_host(monkeypatch):
    """test_mefield.py's differential: the port's Encoder on the CPU,
    which computes the fields for every inter frame, against the host
    encoder without them: byte-identical packets.  Then a perturbed
    field (one offset made free for every vertex) changes the packets."""
    w, h = 192, 128
    frames = _clip(w, h, 4)
    host = _encode(HostEncoder(headers.Info(pic_width=w, pic_height=h),
                               quant=18, complexity=7), frames)
    calls = []
    real = MF.fullpel_sad_fields

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(MF, "fullpel_sad_fields", counted)

    def port():
        return _encode(Encoder(headers.Info(pic_width=w, pic_height=h),
                               device="cpu", quant=18, complexity=7),
                       frames)
    assert port() == host
    assert len(calls) == len(frames) - 1

    def free_offset(*args, **kw):
        fields = real(*args, **kw)
        for f in fields:
            f[f.shape[0] // 3] = 0
        return fields

    monkeypatch.setattr(MF, "fullpel_sad_fields", free_offset)
    bumped = port()
    assert bumped[0] == host[0] and bumped[1:] != host[1:]
