"""The port's command-line encoder and decoder (daala_tpu_torch/tools/)
against the JAX package's CLI (tools/encode.py, tools/decode.py).

Every mode of the CLI, on small clips from a numpy seed written as y4m
under tmp_path: the port's `tools.encode.main([..., "--device",
"cpu"])` (in process) writes the same .ogv as `python tools/encode.py`
(a subprocess) with the same flags, and the port's `tools.decode.main`
the same y4m as `python tools/decode.py`, seeking included.  Where the
JAX CLI drops options (`--workers` builds its Info and Encoder without
the bit depth and most options), the port is held to serial encodes of
the segments instead.  The lean tiers (`--config device`,
`device+sweep`) are held to the port's Encoder with the same
configuration.  The tolerance is zero throughout: bytes and frames.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from daala_tpu import native
from daala_tpu_torch.bench import CONFIGS
from daala_tpu_torch.codec import headers
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.tools import decode as tdecode
from daala_tpu_torch.tools import encode as tencode
from daala_tpu_torch.utils.ogg import read_ogg_packets
from daala_tpu_torch.utils.y4m import Y4MReader, Y4MWriter
import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native engine unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def clip(w, h, n, chroma="420", depth=8, seed=7):
    """A moving textured clip in y4m's plane layout for `chroma` ("420",
    "422", "444" or "mono"), `depth` bits."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    scale = 1 << (depth - 8)
    dt = np.uint8 if depth == 8 else np.uint16
    sub = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}
    tex = rng.normal(0, 20, (16, 16))
    frames = []
    for t in range(n):
        y = (128 + 50 * np.sin((xx + 3 * t) / 9.0)
             + 30 * np.cos((yy + 2 * t) / 7.0))
        oy, ox = (4 + 3 * t) % (h - 16), (6 + 5 * t) % (w - 16)
        y[oy:oy + 16, ox:ox + 16] += tex
        y = y + rng.normal(0, 4, (h, w))
        planes = [(y * scale).clip(0, 255 * scale).astype(dt)]
        if chroma != "mono":
            sx, sy = sub[chroma]
            cx, cy = xx[::sy, ::sx], yy[::sy, ::sx]
            cb = 128 + 20 * np.sin((cx + t) / 13.0)
            cr = 128 + 20 * np.cos((cy + t) / 11.0)
            planes += [(c * scale).clip(0, 255 * scale).astype(dt)
                       for c in (cb, cr)]
        frames.append(planes)
    return frames


def write_y4m(path, frames, chroma="420", depth=8):
    h, w = frames[0][0].shape
    wr = Y4MWriter(str(path), w, h, fps=(30, 1), chroma=chroma,
                   aspect=(1, 1), depth=depth)
    for fr in frames:
        wr.write_frame(fr)
    wr.close()


# mode: (width, height, frames, chroma, depth, CLI flags)
MODES = {
    "b2_check": (64, 48, 4, "420", 8, ["-v", "12", "-b", "2", "--check"]),
    "bitrate": (128, 96, 6, "420", 8, ["--bitrate", "200000"]),
    "two_pass": (128, 96, 6, "420", 8, ["--bitrate", "200000"]),
    "lossless": (64, 48, 3, "420", 8, ["-v", "0", "-k", "1"]),
    "10bit": (64, 48, 3, "420", 10, ["-v", "12", "--check"]),
    "422": (64, 48, 3, "422", 8, ["-v", "12"]),
    "444": (64, 48, 3, "444", 8, ["-v", "12", "--check"]),
    "mono": (64, 48, 3, "mono", 8, ["-v", "12", "--check"]),
    "limit": (64, 48, 6, "420", 8, ["-v", "15", "--limit", "3"]),
    "z3": (64, 48, 4, "420", 8, ["-v", "15", "-z", "3"]),
    "workers": (64, 48, 32, "420", 8, ["-v", "15", "-k", "16",
                                       "--workers", "2"]),
    "seek": (64, 48, 16, "420", 8, ["-v", "15", "-k", "8"]),
}
SEEK = ["--seek", "0.4"]  # frame 12, after the keyframe at frame 8


def jax_cli(script, args):
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", script)]
                       + [str(a) for a in args], cwd=REPO, env=JAX_ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r


def read(path):
    with open(path, "rb") as f:
        return f.read()


def packets(path):
    with open(path, "rb") as f:
        return [p for p, _ in read_ogg_packets(f)]


class Streams:
    """Each mode's input clip, encoded once by each CLI (the test module
    runs on one worker)."""

    def __init__(self, root):
        self.root = root
        self.done = {}

    def input(self, mode):
        w, h, n, chroma, depth, _ = MODES[mode]
        path = self.root / ("%s.y4m" % mode)
        if not path.exists():
            write_y4m(path, clip(w, h, n, chroma, depth), chroma, depth)
        return path

    def encode(self, mode):
        """{"port": .ogv path, "jax": .ogv path} of the mode; two-pass
        also compares its first runs' streams and statistics."""
        if mode in self.done:
            return self.done[mode]
        src, flags = self.input(mode), MODES[mode][5]
        out = {k: self.root / ("%s.%s.ogv" % (mode, k))
               for k in ("port", "jax")}
        if mode == "two_pass":
            stats = {k: self.root / ("%s.%s.stats" % (mode, k))
                     for k in out}
            first = {k: self.root / ("%s.%s.pass1.ogv" % (mode, k))
                     for k in out}
            tencode.main([str(src), str(first["port"]), "--two-pass",
                          str(stats["port"]), "--device", "cpu"])
            jax_cli("encode.py", [src, first["jax"], "--two-pass",
                                  stats["jax"]])
            assert read(first["port"]) == read(first["jax"])
            assert read(stats["port"]) == read(stats["jax"])
            flags = flags + ["--two-pass"]
            tencode.main([str(src), str(out["port"])] + flags
                         + [str(stats["port"]), "--device", "cpu"])
            jax_cli("encode.py", [src, out["jax"]] + flags + [stats["jax"]])
        else:
            tencode.main([str(src), str(out["port"])] + flags
                         + ["--device", "cpu"])
            jax_cli("encode.py", [src, out["jax"]] + flags)
        self.done[mode] = out
        return out


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    return Streams(tmp_path_factory.mktemp("cli"))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_encode_matches_jax_cli(streams, mode):
    out = streams.encode(mode)
    got, want = read(out["port"]), read(out["jax"])
    assert len(packets(out["port"])) > 3
    assert got == want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_matches_jax_cli(streams, mode):
    ogv = streams.encode(mode)["port"]
    got = streams.root / ("%s.port.y4m" % mode)
    want = streams.root / ("%s.jax.y4m" % mode)
    tdecode.main([str(ogv), str(got), "--device", "cpu"])
    jax_cli("decode.py", [ogv, want])
    assert read(got) == read(want)
    frames = list(Y4MReader(str(got)))
    n = MODES[mode][2]
    if "--limit" in MODES[mode][5]:
        n = int(MODES[mode][5][MODES[mode][5].index("--limit") + 1])
    assert len(frames) == n
    if mode == "lossless":
        for a, b in zip(frames, Y4MReader(str(streams.input(mode)))):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)


def test_seek_matches_jax_cli(streams):
    """--seek on a stream with a keyframe every 8 frames: the port's y4m
    equals the JAX CLI's, and its frames are the full decode's from the
    target frame on."""
    ogv = streams.encode("seek")["port"]
    got = streams.root / "seek.port.seek.y4m"
    want = streams.root / "seek.jax.seek.y4m"
    full = streams.root / "seek.port.full.y4m"
    tdecode.main([str(ogv), str(got), "--device", "cpu"] + SEEK)
    jax_cli("decode.py", [ogv, want] + SEEK)
    assert read(got) == read(want)
    tdecode.main([str(ogv), str(full), "--device", "cpu"])
    sought = list(Y4MReader(str(got)))
    whole = list(Y4MReader(str(full)))
    assert len(sought) == 4 and len(whole) == 16
    for a, b in zip(sought, whole[12:]):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("config", ["device", "device+sweep"])
def test_lean_config_matches_encoder(streams, tmp_path, config):
    """--config device / device+sweep: the .ogv's packets are the port's
    Encoder's in that configuration on the CPU, and both decoders
    decode them to the same y4m."""
    w, h, n = 128, 96, 3
    frames = clip(w, h, n, seed=3)
    src, ogv = tmp_path / "in.y4m", tmp_path / "out.ogv"
    write_y4m(src, frames)
    tencode.main([str(src), str(ogv), "-v", "20", "--check", "--config",
                  config, "--device", "cpu"])
    info = headers.Info(pic_width=w, pic_height=h, timebase_numerator=30,
                        timebase_denominator=1, pixel_aspect_numerator=1,
                        pixel_aspect_denominator=1)
    enc = Encoder(info, quant=20, trial_rate_approx=True,
                  trial_prune_boost=3.0, device="cpu", **CONFIGS[config])
    want = [bytes(p) for p in enc.flush_headers()]
    want += [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
    want += [bytes(p) for p in enc.flush()]
    assert packets(ogv) == want
    got, jax_y4m = tmp_path / "port.y4m", tmp_path / "jax.y4m"
    tdecode.main([str(ogv), str(got), "--device", "cpu"])
    jax_cli("decode.py", [ogv, jax_y4m])
    assert read(got) == read(jax_y4m)
    assert len(list(Y4MReader(str(got)))) == n


def test_workers_high_depth_equals_serial_segments(tmp_path):
    """--workers 2 on 10-bit input (where the JAX CLI writes an 8-bit
    header): the packets of serial encodes of each segment (16 frames,
    then 2) with the full Info and options, --check included."""
    w, h, n, seg = 64, 48, 18, 16
    frames = clip(w, h, n, depth=10, seed=9)
    src, ogv = tmp_path / "in.y4m", tmp_path / "out.ogv"
    write_y4m(src, frames, depth=10)
    tencode.main([str(src), str(ogv), "-v", "15", "-k", "16", "-z", "5",
                  "--mv-level-max", "2", "--check", "--workers", "2",
                  "--device", "cpu"])
    info = headers.Info(pic_width=w, pic_height=h, keyframe_rate=seg,
                        timebase_numerator=30, timebase_denominator=1,
                        pixel_aspect_numerator=1, pixel_aspect_denominator=1,
                        bitdepth_mode=2, full_precision_references=1)
    want = None
    for i in range(0, n, seg):
        enc = Encoder(info, quant=15, complexity=5, trial_rate_approx=True,
                      trial_prune_boost=3.0, device="cpu")
        enc.mv_max_level = 2
        enc.enable_encoder_check = True
        if want is None:
            want = [bytes(p) for p in enc.flush_headers()]
        want += [bytes(p) for fr in frames[i:i + seg]
                 for p in enc.encode_frame(fr)]
        want += [bytes(p) for p in enc.flush()]
    got = packets(ogv)
    assert headers.decode_header(got[0], None)[0].bitdepth_mode == 2
    assert got == want


def test_two_pass_refuses_workers(tmp_path):
    src = tmp_path / "in.y4m"
    write_y4m(src, clip(64, 48, 2))
    with pytest.raises(SystemExit, match="does not combine"):
        tencode.main([str(src), str(tmp_path / "o.ogv"), "--workers", "2",
                      "--two-pass", str(tmp_path / "s"), "--device", "cpu"])
    assert not (tmp_path / "o.ogv").exists()


NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="a card is present: the default "
                             "device resolves")


@NO_CARD
def test_default_device_without_a_card_fails(streams, tmp_path):
    """Without a card `python -m daala_tpu_torch.tools.encode` (default
    --device cuda) exits nonzero with the resolver's message and writes
    no output."""
    out = tmp_path / "out.ogv"
    r = subprocess.run([sys.executable, "-m", "daala_tpu_torch.tools.encode",
                        str(streams.input("limit")), str(out)], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "torch sees no CUDA device" in r.stderr
    assert not out.exists()


@NO_CARD
def test_decode_without_a_card_exits(streams, tmp_path):
    """tools.decode.main([..., "--device", "cuda"]): the same exit,
    before the output is opened."""
    out = tmp_path / "out.y4m"
    with pytest.raises(SystemExit, match="torch sees no CUDA device"):
        tdecode.main([str(streams.encode("limit")["port"]), str(out),
                      "--device", "cuda"])
    assert not out.exists()
