"""The port's benchmark harnesses on the CPU: daala_tpu_torch/bench.py
(bench.py's device legs) and daala_tpu_torch/utils/bench_scaling.py
(tools/bench_scaling.py's device leg), at small sizes with --device cpu.

The clips equal bench.py's bit for bit; bench_ours's bytes equal the
port's Encoder run directly in each configuration and, for the analysis
tier, daala_tpu's host Encoder's; the JSON lines carry the keys of the
JAX scripts' own lines (taken from a run of each at a small size) plus
the port's; without a card and without --device cpu the harnesses
raise.
"""

import importlib.util
import json
import os
import sys

import pytest
import torch

from daala_tpu.codec import headers as JH
from daala_tpu.codec.encoder import Encoder as HostEncoder
from daala_tpu_torch import bench as B
from daala_tpu_torch.codec import headers as H
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.utils import bench_scaling as BS
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H_, NF = 128, 64, 2
CPU = ["--device", "cpu", "--size", "%dx%d" % (W, H_), "--frames", str(NF)]


def _script(path, monkeypatch):
    """The repository's script at `path` as a module (its directory and
    the repository root on sys.path while the test runs)."""
    full = os.path.join(REPO, path)
    monkeypatch.syspath_prepend(os.path.dirname(full))
    spec = importlib.util.spec_from_file_location(
        "_script_" + os.path.basename(path)[:-3], full)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture
def in_process(monkeypatch):
    """The harnesses' mains in this process, which holds jax and
    daala_tpu: their own check of sys.modules (made again in every
    probe's process) is skipped here."""
    monkeypatch.setattr(B, "check_imports", lambda: None)


def test_check_imports_sees_jax():
    assert "jax" in sys.modules
    with pytest.raises(AssertionError, match="imported"):
        B.check_imports()


@pytest.fixture(scope="module")
def jax_bench():
    with pytest.MonkeyPatch.context() as mp:
        yield _script("bench.py", mp)


@pytest.mark.parametrize("content", B.CONTENTS)
def test_make_clip_is_bench_py_s(content, jax_bench):
    want = jax_bench.make_clip(content, 2)
    got = B.make_clip(content, 2)
    assert len(got) == len(want) == 2
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert (a == b).all()


@pytest.mark.parametrize("config", sorted(B.CONFIGS))
def test_bench_ours_bytes_are_the_encoder_s(config):
    frames = B.make_clip("translation", NF, W, H_)
    v, nbytes, kf_wall, dt = B.bench_ours(frames, config, "cpu")
    assert v > 0 and 0 < kf_wall < dt
    enc = Encoder(H.Info(pic_width=W, pic_height=H_), quant=B.QUANT,
                  complexity=B.COMPLEXITY, device="cpu", **B.PRESET,
                  **B.CONFIGS[config])
    enc.keyframe_rate = 256
    pk = [p for fr in frames for p in enc.encode_frame(fr)] + enc.flush()
    assert nbytes == sum(map(len, pk))
    if config == "analysis":
        host = HostEncoder(JH.Info(pic_width=W, pic_height=H_),
                           quant=B.QUANT, complexity=B.COMPLEXITY,
                           **B.PRESET)
        host.keyframe_rate = 256
        want = [p for fr in frames for p in host.encode_frame(fr)]
        want += host.flush()
        assert [bytes(p) for p in pk] == [bytes(p) for p in want]


def test_probe_one_has_bench_py_s_keys(jax_bench, monkeypatch, capsys,
                                       in_process):
    monkeypatch.setattr(jax_bench, "W", W)
    monkeypatch.setattr(jax_bench, "H", H_)
    monkeypatch.setattr(sys, "argv", ["bench.py", "--probe-one", "host"])
    jax_bench.main()
    want = set(_last_json(capsys.readouterr().out))
    assert B.main(["--probe-one", "device"] + CPU) == 0
    got = _last_json(capsys.readouterr().out)
    assert want - {"warm_compiles", "warm_compile_s"} <= set(got)
    assert got["config"] == "device" and got["mpix_s"] > 0
    assert got["dev"]["counts"]["pvq_rows"] > 0
    assert {"launches", "spans_s", "counts", "dispatches"} <= set(got["dev"])
    assert isinstance(got["builds_s"], dict)


def test_main_run_has_bench_py_s_keys(jax_bench, monkeypatch, capsys,
                                      in_process):
    """bench.py's host leg at the small size (its backend probe, a
    subprocess that imports jax, answers "cpu" here and is skipped), then
    the port's probes, each in a process with one torch thread."""
    monkeypatch.setattr(jax_bench, "W", W)
    monkeypatch.setattr(jax_bench, "H", H_)
    monkeypatch.setattr(jax_bench, "probe_device_mode",
                        lambda: (False, False, {"backend": "cpu"}))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    jax_bench.main()
    want = _last_json(capsys.readouterr().out)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert B.main(CPU) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(want) | {"card", "torch_threads"} == set(got)
    assert set(want["config"]) | {"name", "size",
                                  "frames"} == set(got["config"])
    assert got["card"] == "cpu" and got["torch_threads"] >= 1
    assert got["value"] > 0 and got["vs_baseline"] is None
    probe = got["config"]["probe"]
    assert set(probe) == set(B.CONFIGS)
    assert all(isinstance(v, dict) and v["mpix_s"] > 0
               for v in probe.values())
    assert got["config"]["name"] == max(probe, key=lambda n:
                                        probe[n]["mpix_s"])
    entry = want["config"]["per_content"]["translation"]
    for content in B.CONTENTS:
        mine = got["config"]["per_content"][content]
        assert set(entry) | {"bytes", "walls_s", "dev"} <= set(mine)
        assert len(mine["walls_s"]) == 2 and mine["bytes"] > 0


def test_config_skips_the_probe(capsys, in_process):
    assert B.main(["--config", "device+sweep"] + CPU) == 0
    got = _last_json(capsys.readouterr().out)
    assert got["config"]["name"] == "device+sweep"
    assert got["config"]["probe"] is None and got["config"]["mv_sweep"]
    dev = got["config"]["per_content"]["translation"]["dev"]
    assert dev["spans_s"]["refine_sweep"] > 0


@pytest.mark.parametrize("argv", [[], ["--probe-one", "device"]])
def test_bench_needs_a_card_or_cpu(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        B.main(argv)


def test_bench_scaling_has_tools_keys(monkeypatch, capsys, in_process):
    small = ["--width", "64", "--height", "48", "--clips", "2",
             "--frames", "2"]
    tool = _script(os.path.join("tools", "bench_scaling.py"), monkeypatch)
    monkeypatch.setattr(sys, "argv", ["bench_scaling.py", "--host"] + small)
    tool.main()
    want = _last_json(capsys.readouterr().out)
    assert BS.main(small + ["--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(want) | {"serial_walls_s", "threaded_walls_s", "card",
                        "torch_threads"} == set(got)
    assert got["card"] == "cpu" and got["device"] is True
    assert got["serial_s"] > 0 and got["threaded_s"] > 0
    assert got["serial_s"] == min(got["serial_walls_s"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BS.main(small)
