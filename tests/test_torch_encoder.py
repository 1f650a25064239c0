"""The port's encoder (daala_tpu_torch/codec/encoder.py) end to end.

Mirrors tests/test_device_analysis.py: with its analysis front end on
the CPU, the port's Encoder must produce packets byte-identical to the
host encoder's (keyframes, inter frames, odd sizes, complexity 7,
10-bit input with full-precision references), and on one clip to the
JAX device tier's.  Since only the native pass reads the planes, a
perturbed plane must change the packets: that proves they are used.
Without the native engine the encoder raises rather than fall back to
its Python coefficient path (tests/test_torch_encoder_python.py runs
that path where it is asked for).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from daala_tpu import native
from daala_tpu.codec import headers
from daala_tpu.codec.encoder import Encoder as HostEncoder
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.entropy import ec as ec_mod
from daala_tpu_torch.models import keyframe as TKF
from daala_tpu_torch.models import restore as TR
from daala_tpu_torch.utils import devstats
import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native engine unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip(w, h, n, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (128 + 60 * np.sin((xx + 3 * t) / 9.0)
             + 40 * np.cos((yy + 2 * t) / 7.0)
             + rng.normal(0, 5, (h, w))).clip(0, 255).astype(np.uint8)
        cw, ch = (w + 1) // 2, (h + 1) // 2
        cb = (128 + 20 * np.sin((xx[:ch, :cw] + t) / 13.0)) \
            .clip(0, 255).astype(np.uint8)
        cr = (128 + 20 * np.cos((yy[:ch, :cw] + t) / 11.0)) \
            .clip(0, 255).astype(np.uint8)
        frames.append([y, cb, cr])
    return frames


def _clip10(w, h, n, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (512 + 240 * np.sin((xx + 3 * t) / 9.0)
             + rng.normal(0, 12, (h, w))).clip(0, 1023).astype(np.uint16)
        cb = (512 + 100 * np.sin((xx[::2, ::2] + t) / 13.0)) \
            .clip(0, 1023).astype(np.uint16)
        cr = (512 - 80 * np.cos((yy[::2, ::2] + t) / 11.0)) \
            .clip(0, 1023).astype(np.uint16)
        frames.append([y, cb, cr])
    return frames


def _encode(enc, frames, b_frames=0):
    enc.keyframe_rate = 8
    enc.b_frames = b_frames
    out = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
    return out + [bytes(p) for p in enc.flush()]


def _pair(frames, w, h, info_kw=None, b_frames=0, **kw):
    """Packets of the host encoder and of the port's (device 'cpu')."""
    pk = {}
    for name in ("host", "port"):
        info = headers.Info(pic_width=w, pic_height=h, **(info_kw or {}))
        if name == "host":
            enc = HostEncoder(info, **kw)
        else:
            enc = Encoder(info, device="cpu", **kw)
        pk[name] = _encode(enc, frames, b_frames)
    return pk["host"], pk["port"]


def test_keyframe_matches_host():
    host, port = _pair(_clip(256, 192, 1), 256, 192, quant=18,
                       complexity=1)
    assert port == host


@pytest.mark.parametrize("w,h", [(192, 128), (177, 115)])
def test_inter_matches_host(w, h):
    host, port = _pair(_clip(w, h, 4), w, h, quant=15, complexity=1)
    assert port == host


@pytest.mark.parametrize("b_frames", [0, 2])
def test_complexity7_matches_host(b_frames):
    """Both device passes: the RDO trial pyramid and the final
    analysis on the decided block-size map; with and without B-frames."""
    host, port = _pair(_clip(192, 128, 4, seed=7), 192, 128, quant=15,
                       complexity=7, b_frames=b_frames)
    assert port == host


def test_fpr_highdepth_matches_host():
    host, port = _pair(_clip10(192, 128, 3), 192, 128,
                       info_kw=dict(bitdepth_mode=2,
                                    full_precision_references=True),
                       quant=15, complexity=7)
    assert port == host


def test_matches_jax_device_tier():
    """One clip (a keyframe and an inter frame) against the JAX
    use_device_analysis tier, with dering on: both sides filter the
    dering candidates on their device tier (the port's
    dering_candidates_device on the CPU, JAX's on its CPU backend)."""
    w, h = 128, 64
    frames = _clip(w, h, 2, seed=3)
    pk = {}
    for name in ("jax", "port"):
        info = headers.Info(pic_width=w, pic_height=h)
        if name == "jax":
            enc = HostEncoder(info, quant=15, complexity=1)
            enc.use_device_analysis = True
        else:
            enc = Encoder(info, device="cpu", quant=15, complexity=1)
        devstats.reset()
        pk[name] = _encode(enc, frames)
    assert devstats.snapshot()["spans_s"]["dering_candidates"] > 0
    assert pk["port"] == pk["jax"]


def _levels_of_first_frame(enc, frame):
    """The packet of `frame` (a keyframe) and the dering levels it chose."""
    enc.keyframe_rate = 8
    pk = [bytes(p) for p in enc.encode_frame(frame)]
    st = enc.state
    return pk, st.dering_level.reshape(st.frame_height >> 6,
                                       st.frame_width >> 6).copy()


def test_dering_candidates_are_consumed(monkeypatch):
    """Spoiling the candidate that the dering RDO chose for one
    superblock (its level's, +4096 on every pixel) changes that choice
    and so the packet: the native pass really reads the candidates that
    dering_candidates_device returns."""
    w, h = 96, 64
    frame = _clip(w, h, 1, seed=2)[0]

    def run():
        return _levels_of_first_frame(
            Encoder(headers.Info(pic_width=w, pic_height=h), device="cpu",
                    quant=18, complexity=1), frame)

    base, levels = run()
    sb = int(np.flatnonzero(levels)[0])
    level = int(levels.flat[sb])
    real = TR.dering_candidates_device

    def spoiled(*args, **kwargs):
        cands, dirs = real(*args, **kwargs)
        cands[sb, level - 1] += 4096
        return cands, dirs
    monkeypatch.setattr(TR, "dering_candidates_device", spoiled)
    pk, new_levels = run()
    assert new_levels.flat[sb] != level and pk != base


def test_lean_tier_keeps_native_dering(monkeypatch):
    """The lean tier (bench.py's `device` configuration) leaves dering to
    the native pass, as JAX's does: no device candidates."""
    def refuse(*args, **kwargs):
        raise AssertionError("dering candidates in the lean tier")
    monkeypatch.setattr(TR, "dering_candidates_device", refuse)
    enc = Encoder(headers.Info(pic_width=96, pic_height=64), device="cpu",
                  quant=18, complexity=1, use_device_analysis=False,
                  use_device_pvq=True)
    _, levels = _levels_of_first_frame(enc, _clip(96, 64, 1, seed=2)[0])
    assert levels.any()


def _perturbed(fn, edit):
    def wrapped(*args, **kwargs):
        return edit(fn(*args, **kwargs))
    return wrapped


def _perturbed_fetch(fn, edit):
    """fn (an analyze_* entry point) with the planes its finish()
    fetches edited."""
    def wrapped(*args, **kwargs):
        *dev, finish = fn(*args, **kwargs)
        return (*dev, lambda: edit(finish()))
    return wrapped


def test_analysis_planes_are_consumed(monkeypatch):
    """A perturbed coefficient in the port's keyframe and inter planes
    changes the packets, so the native pass really used them.  The
    offset is large (4096, several quantizer steps) so that
    quantization cannot absorb it."""
    w, h = 192, 128
    frames = _clip(w, h, 2, seed=5)

    def run():
        info = headers.Info(pic_width=w, pic_height=h)
        return _encode(Encoder(info, device="cpu", quant=15, complexity=1),
                       frames)

    def bump_kf(d):
        d[0][5, 6] += 4096
        return d

    def bump_inter(d_md):
        d_md[0][0][5, 6] += 4096
        return d_md

    base = run()
    monkeypatch.setattr(TKF, "analyze_keyframe",
                        _perturbed_fetch(TKF.analyze_keyframe, bump_kf))
    kf = run()
    assert kf[0] != base[0]
    monkeypatch.undo()
    monkeypatch.setattr(TKF, "analyze_inter",
                        _perturbed_fetch(TKF.analyze_inter, bump_inter))
    inter = run()
    assert inter[0] == base[0] and inter[1:] != base[1:]


def test_rdo_pyramid_is_consumed(monkeypatch):
    """Perturbing the port's RDO pyramid (the trial pass's transforms)
    changes the block-size decisions and so the packets."""
    w, h = 192, 128
    frames = _clip(w, h, 2, seed=7)

    def run():
        info = headers.Info(pic_width=w, pic_height=h)
        return _encode(Encoder(info, device="cpu", quant=15, complexity=7),
                       frames)

    def bump(pyr):
        d_l, md_l, d_m = pyr
        for lvl in (2, 3, 4):
            d_l[lvl] += 4096
        return d_l, md_l, d_m

    base = run()
    monkeypatch.setattr(TKF, "analyze_rdo_pyramid",
                        _perturbed(TKF.analyze_rdo_pyramid, bump))
    assert run() != base


def test_refuses_the_python_frame_path(monkeypatch):
    """The port takes the Python coefficient path only where the caller
    asks for it (tests/test_torch_encoder_python.py): with the native
    engine missing (the range coder without its native handle) and
    use_native_frame left on, it raises where JAX's encoder falls back
    to the Python path."""
    monkeypatch.setattr(ec_mod, "Encoder", ec_mod.PyEncoder)
    info = headers.Info(pic_width=64, pic_height=64)
    enc = Encoder(info, device="cpu", quant=15, complexity=1)
    with pytest.raises(RuntimeError, match="native engine is missing"):
        enc.encode_frame(_clip(64, 64, 1)[0])


def test_refuses_no_device_tier():
    """With neither tier on the whole frame would run on the host, so the
    port's encoder refuses it."""
    info = headers.Info(pic_width=64, pic_height=64)
    with pytest.raises(ValueError):
        Encoder(info, device="cpu", use_device_analysis=False,
                use_device_pvq=False)


def test_both_tiers_match_the_lean_tier():
    """Both tiers on: the native pass reads the fetched planes (the
    same transforms it computes itself) and replays the same search
    table, so the packets equal the lean tier's; encoder check on."""
    w, h = 96, 64
    frames = _clip(w, h, 3, seed=9)
    pk = []
    for analysis in (False, True):
        enc = Encoder(headers.Info(pic_width=w, pic_height=h), device="cpu",
                      quant=18, complexity=7, use_device_analysis=analysis,
                      use_device_pvq=True)
        enc.enable_encoder_check = True
        pk.append(_encode(enc, frames))
    assert pk[1] == pk[0]


def test_cuda_device_without_card_raises():
    """The device tier runs on the card by default (Encoder(info)) and
    raises where there is none; on the CPU only where the caller asks."""
    info = headers.Info(pic_width=64, pic_height=64)
    for kw in ({"device": "cuda"}, {}):
        if torch.cuda.is_available():
            assert Encoder(info, **kw).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                Encoder(info, **kw)
    assert Encoder(info, device="cpu").device == torch.device("cpu")


def test_import_leaves_jax_out():
    """The port and its encoder import no jax, directly or not."""
    code = ("import sys; import daala_tpu_torch.codec.encoder, "
            "daala_tpu_torch.ops.cuda.dct_kernels, "
            "daala_tpu_torch.ops.cuda.lap_kernels, "
            "daala_tpu_torch.utils.profile; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'daala_tpu.models', "
            "'daala_tpu.ops.pallas'))); print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
