"""The port's quality sweep (daala_tpu_torch.utils.sweep_quality) and the
zigzag CLI's --clip path, on the CPU at tiny sizes.

The anchor's bytes and PSNR equal tools/sweep_quality.py run_encode's
through the JAX package's host Encoder (exact: the analysis tier is the
host encoder byte for byte); a device_pvq sweep gives a finite BD-rate;
the copied clip generators equal their originals from the same seed
(exact); the CLI's table is gen_zigzag(measure_mags(...)) of the clip's
luma (exact).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import content
from daala_tpu_torch.train import zigzag as tzz
from daala_tpu_torch.utils import sweep_quality as SQ
from daala_tpu_torch.utils.y4m import Y4MWriter
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name, monkeypatch):
    """tools/<name>.py as a module, with tools/ on sys.path while the
    test runs (the tool imports its neighbours)."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    spec = importlib.util.spec_from_file_location(
        "_tool_" + name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config", ["device_pvq", "mv_sweep"])
def test_anchor_is_the_host_encoder(config, monkeypatch):
    frames = SQ.make_natural_clip(128, 64, 2, seed=0)
    a_kw, _, a_cx, _ = SQ.CONFIGS[config]
    nb, psnr, _ = SQ.run_encode(frames, 128, 64, 25, a_kw, a_cx, "cpu")
    want_nb, want_psnr, _ = _tool("sweep_quality", monkeypatch).run_encode(
        frames, 128, 64, 25, lambda e: None, a_cx)
    assert nb == want_nb
    assert psnr == want_psnr


def test_device_pvq_sweep_gives_a_finite_bd_rate(capsys):
    rows = SQ.sweep_bd("device_pvq", ["natural"], [0], [12, 25, 40, 60],
                       128, 64, 1, device="cpu")
    assert len(rows) == 1 and rows[0]["device"] == "cpu"
    assert np.isfinite(rows[0]["bd_rate_mean_pct"])
    assert '"class": "natural", "seed": 0' in capsys.readouterr().out


@pytest.mark.parametrize("name", ["smooth", "mixed", "natural"])
def test_clip_generators_equal_their_originals(name, monkeypatch):
    orig = {"smooth": lambda: _tool("sweep_trial",
                                    monkeypatch).make_smooth_clip,
            "mixed": lambda: content.make_clip,
            "natural": lambda: content.make_natural_clip}[name]()
    for seed in (0, 1):
        got = SQ.MAKERS[name](96, 64, 3, seed=seed)
        want = orig(96, 64, 3, seed=seed)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype == np.uint8
                np.testing.assert_array_equal(a, b)


def test_zigzag_cli_reads_a_clip(tmp_path):
    frames = SQ.make_natural_clip(160, 128, 2, seed=4)
    path = str(tmp_path / "clip.y4m")
    wr = Y4MWriter(path, 160, 128)
    for fr in frames:
        wr.write_frame(fr)
    wr.close()
    r = subprocess.run([sys.executable, "-m", "daala_tpu_torch.train",
                        "zigzag", "8", "--clip", path, "--device", "cpu"],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    want = tzz.gen_zigzag(tzz.measure_mags([f[0] for f in frames], 8,
                                           device="cpu"))
    lines = r.stdout.splitlines()
    assert lines[0] == "OD_ZIGZAG8 = [" and lines[-1] == "]"
    assert lines[1:-1] == ["  (%d, %d)," % (x, y) for x, y in want]
